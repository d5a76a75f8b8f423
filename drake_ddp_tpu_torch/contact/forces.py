"""Smooth hydroelastic-style contact force law: host-side parameters.

Port of ``drake_ddp_tpu/contact/forces.py``.  The force law itself is
evaluated lane-major in :mod:`drake_ddp_tpu_torch.multibody.lanestep`
(plain PyTorch) and in ``csrc/lanestep.cuh`` (the CUDA device step);
what lives here is the parameter record and the static stiction
continuation schedule, both host floats.
"""

from __future__ import annotations

from typing import NamedTuple


class ContactForceParams(NamedTuple):
    """smooth_width: softplus width of the penetration [m] (wider = more
    force-at-a-distance signal for the optimizer, narrower = crisper
    contact); stiction_vel: friction regularization [m/s]; force_scale:
    O(1) patch-shape constant, fn = force_scale * K * phi^2."""

    smooth_width: float = 3e-3
    stiction_vel: float = 1e-3
    force_scale: float = 2.0


def stiction_schedule(stiction_vel: float, contact_iters: int,
                      anneal: float = 4.0, vs_max: float = 5e-2):
    """Per-iteration friction-regularization widths of the implicit
    contact Newton solve: a continuation from a softened friction curve
    down to the true ``stiction_vel`` —
    [min(vs_max, vs * anneal^(n-1)), ..., vs * anneal, vs].

    The schedule is static, so the step map stays a fixed composition of
    smooth functions with no state-dependent gates; the last iteration
    solves the true model, so the root (and the implicit-function
    derivatives taken there) is unchanged."""
    vs = float(stiction_vel)
    return [min(max(vs, vs_max), vs * anneal ** (contact_iters - 1 - it))
            for it in range(contact_iters)]
