"""Keypoint-scheduled dynamics derivatives with linear interpolation.

Port of the batched lane path of ``drake_ddp_tpu/solver/keypoints.py``:
exact Jacobians at keypoints through one lane-major Jacobian call
(every (scenario, keypoint) pair is one lane), linear interpolation in
between.  This slice carries the dense baseline and the static
setInterval schedule; the data-dependent adaptiveJerk and
iterativeError schedules come with a later slice (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

SET_INTERVAL = "setInterval"
ADAPTIVE_JERK = "adaptiveJerk"
ITERATIVE_ERROR = "iterativeError"
_METHODS = (SET_INTERVAL, ADAPTIVE_JERK, ITERATIVE_ERROR)


class DerivsInterpolation(NamedTuple):
    """Derivative-interpolation config.

    Attributes:
        keypoint_method: one of 'setInterval', 'adaptiveJerk',
            'iterativeError' (the last two come with a later slice, with
            the thresholds and budgets that only they read).
        minN: interval between keypoints.
    """

    keypoint_method: str = SET_INTERVAL
    minN: int = 1

    def validate(self) -> "DerivsInterpolation":
        if self.keypoint_method not in _METHODS:
            raise ValueError(
                f"unknown interpolation method {self.keypoint_method!r}")
        return self


BASELINE = DerivsInterpolation(SET_INTERVAL, 1)


def is_baseline(cfg: DerivsInterpolation) -> bool:
    """True for the dense setInterval-1 case."""
    return cfg.keypoint_method == SET_INTERVAL and cfg.minN == 1


def set_interval_mask(N: int, minN: int) -> np.ndarray:
    """Static (N-1,) keypoint mask of the setInterval method:
    ``arange(0, N-1, minN)`` with its last element *replaced* by N-2 if
    it isn't already."""
    pts = np.arange(0, N - 1, minN)
    if pts[-1] != N - 2:
        pts = pts.copy()
        pts[-1] = N - 2
    mask = np.zeros(N - 1, dtype=bool)
    mask[pts] = True
    return mask


def compute_derivatives_batched(
    jac_T: Callable,
    cfg: DerivsInterpolation,
    x: torch.Tensor,
    u: torch.Tensor,
    root: bool = False,
):
    """Batched derivatives through a lane-major Jacobian function.

    Args:
        jac_T: (x (n, L), u (m, L)) -> (fx (n, n, L), fu (n, m, L)); with
            ``root=True`` it takes a third argument x_next (n, L), the
            trajectory's own next state (root-seeded lane Jacobian).
        cfg: interpolation config (validated).
        x: (B, N, n) trajectories.
        u: (B, N-1, m) control tapes.
    Returns:
        fx (B, N-1, n, n), fu (B, N-1, n, m), percent (B,).
    """
    B, N, n = x.shape
    m = u.shape[-1]
    T = N - 1
    dtype, dev = x.dtype, x.device
    xn = x[:, 1:]                      # (B, T, n) next states, t -> t+1

    def at_indices(x_k, u_k, xn_k):
        """Jacobians at gathered keypoints: x_k (B, K, n) -> (B, K, n, n)."""
        K = x_k.shape[1]
        lane = lambda a, d: a.reshape(B * K, d).T.contiguous()
        if root:
            fx_L, fu_L = jac_T(lane(x_k, n), lane(u_k, m), lane(xn_k, n))
        else:
            fx_L, fu_L = jac_T(lane(x_k, n), lane(u_k, m))
        fx_k = fx_L.reshape(n, n, B, K).permute(2, 3, 0, 1)
        fu_k = fu_L.reshape(n, m, B, K).permute(2, 3, 0, 1)
        return fx_k, fu_k

    if is_baseline(cfg):
        fx, fu = at_indices(x[:, :-1], u, xn)
        return fx, fu, torch.full((B,), 100.0, dtype=dtype, device=dev)

    if cfg.keypoint_method != SET_INTERVAL:
        raise NotImplementedError(
            f"{cfg.keypoint_method} keypoints come with a later slice of "
            "the port (ROADMAP Queue 1, item 10); use setInterval")
    mask_np = set_interval_mask(N, cfg.minN)
    idx = np.nonzero(mask_np)[0]
    if idx[0] != 0:
        # the interpolation needs a keypoint at t = 0; the JAX package's
        # prev-keypoint lookup wraps to the last keypoint here instead
        raise ValueError(
            f"setInterval minN={cfg.minN} leaves no keypoint at t = 0 for "
            f"horizon N={N}")
    idx_t = torch.as_tensor(idx, device=dev)
    fx_k, fu_k = at_indices(x[:, idx_t], u[:, idx_t], xn[:, idx_t])
    # static schedule: interpolate straight from the compact (B, K, ...)
    # keypoint stack with host-side prev/next indices and weights
    t_np = np.arange(T)
    prev_k = np.searchsorted(idx, t_np, side="right") - 1
    next_k = np.minimum(np.searchsorted(idx, t_np, side="left"),
                        len(idx) - 1)
    s_, e_ = idx[prev_k], idx[next_k]
    w_np = np.where(mask_np, 0.0, (t_np - s_) / np.maximum(e_ - s_, 1))
    w = torch.as_tensor(w_np, dtype=dtype, device=dev)[None, :, None, None]
    prev_t = torch.as_tensor(prev_k, device=dev)
    next_t = torch.as_tensor(next_k, device=dev)
    fx = fx_k[:, prev_t] * (1.0 - w) + fx_k[:, next_t] * w
    fu = fu_k[:, prev_t] * (1.0 - w) + fu_k[:, next_t] * w
    pct = torch.full((B,), 100.0 * len(idx) / T, dtype=dtype, device=dev)
    return fx, fu, pct
