"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    The default is the card.  A CUDA device with no card present raises
    instead of silently running on the CPU: only an explicit
    ``device="cpu"`` runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (a CUDA device without an
    index matches any card)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)
