"""Checkpoint and resume of a batched MPC chain.

Port of ``drake_ddp_tpu/io/checkpoint.py``: the chain state (each
scenario's problem record, x0 / x_nom / warm-start tapes, plus progress
counters) in one .npz archive with the JAX package's layout: fields
``prob_<name>`` for every problem field that is not None (None fields
are left out; loading lets the record's defaults refill them),
``resolves_done``, and ``extra_<name>`` for every extra that is not
None.  A file written by either package loads in the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from drake_ddp_tpu_torch._device import resolve_device
from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem


def _host(v):
    return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v))


def save_mpc_checkpoint(path: str, prob: ILQRProblem, resolves_done: int,
                        extra: Optional[dict] = None) -> None:
    """Write the batched MPC chain state to one npz archive.  None fields
    and extras are left out: an object array would fail at
    ``np.load(allow_pickle=False)``."""
    payload = {f"prob_{k}": _host(v)
               for k, v in prob._asdict().items() if v is not None}
    payload["resolves_done"] = np.asarray(resolves_done)
    for k, v in (extra or {}).items():
        if v is not None:
            payload[f"extra_{k}"] = _host(v)
    np.savez(path, **payload)


def load_mpc_checkpoint(path: str, device="cuda"
                        ) -> Tuple[ILQRProblem, int, dict]:
    """Load a checkpoint: (problem record with its tensors on ``device``,
    resolves_done, extras as numpy arrays)."""
    dev = resolve_device(device)
    data = np.load(path)
    prob = ILQRProblem(**{
        k[len("prob_"):]: torch.as_tensor(data[k], device=dev)
        for k in data.files if k.startswith("prob_")})
    extras = {k[len("extra_"):]: data[k] for k in data.files
              if k.startswith("extra_")}
    return prob, int(data["resolves_done"]), extras
