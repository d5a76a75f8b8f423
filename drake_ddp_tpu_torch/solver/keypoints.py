"""Keypoint-scheduled dynamics derivatives with linear interpolation.

Port of ``drake_ddp_tpu/solver/keypoints.py`` (the Russell/Papallas/Dogar
key-point method): exact Jacobians at keypoints through one lane-major
Jacobian call (every (scenario, keypoint) pair is one lane), linear
interpolation in between.  Keypoints are a boolean mask over the horizon.

Methods (the JAX package's numbers):
- ``setInterval``: a static schedule, interpolated straight from the
  compact keypoint stack;
- ``adaptiveJerk``: the jerk flags are computed on the device, the
  counter scan over time runs on the host for all scenarios at once (one
  copy of B x (N-3) booleans), and exactly the masked (scenario, step)
  pairs become the lanes of one Jacobian call;
- ``iterativeError``: the dyadic bisection of [0, N-2] is evaluated level
  by level, one Jacobian call per level over the wanted mids of every
  scenario (one host read of the level's error flags).  With
  ``max_keypoints`` the JAX package's per-level caps apply per scenario,
  in its stable index order, and segments the budget cannot check are
  accepted as-is; without it the tree runs uncapped, which visits what the
  JAX package's dense replay visits and evaluates only those steps.

The JAX package's static-shape workarounds (wasted budget lanes, dense
stacks for the replay) have no counterpart here: the lane count of a call
follows the data.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

SET_INTERVAL = "setInterval"
ADAPTIVE_JERK = "adaptiveJerk"
ITERATIVE_ERROR = "iterativeError"
_METHODS = (SET_INTERVAL, ADAPTIVE_JERK, ITERATIVE_ERROR)


class DerivsInterpolation(NamedTuple):
    """Derivative-interpolation config, the JAX package's fields in its
    order (a positional construction means the same in both packages).

    Attributes:
        keypoint_method: one of 'setInterval', 'adaptiveJerk',
            'iterativeError'.
        minN: minimum interval between keypoints.
        maxN: maximum interval between keypoints (adaptiveJerk only).
        jerk_threshold: jerk that triggers a keypoint (adaptiveJerk only).
        iterative_error_threshold: mean-squared fx interpolation error
            that triggers subdivision (iterativeError only).
        max_keypoints: keypoint budget.  adaptiveJerk: an upper bound on
            each scenario's keypoint count (a larger count raises
            ValueError); iterativeError: the per-level caps of the
            budgeted bisection.  None: adaptiveJerk evaluates its masks
            exactly, iterativeError runs the uncapped bisection.
        jac_chunk: at most this many lanes per Jacobian call (a larger
            call is split); None = one call.
    """

    keypoint_method: str = SET_INTERVAL
    minN: int = 1
    maxN: int = 0
    jerk_threshold: float = 0.0
    iterative_error_threshold: float = 0.0
    max_keypoints: Optional[int] = None
    jac_chunk: Optional[int] = None

    def validate(self) -> "DerivsInterpolation":
        if self.keypoint_method not in _METHODS:
            raise ValueError(
                f"unknown interpolation method {self.keypoint_method!r}")
        return self


BASELINE = DerivsInterpolation(SET_INTERVAL, 1, 0, 0.0, 0.0)


def from_config(cfg) -> Optional[DerivsInterpolation]:
    """The interpolation an example's ``Config`` asks for, built as the
    JAX package's examples build it: None unless
    ``use_derivative_interpolation``."""
    if not cfg.use_derivative_interpolation:
        return None
    return DerivsInterpolation(
        cfg.keypoint_method, cfg.minN, cfg.maxN, cfg.jerk_threshold,
        cfg.iterative_error_threshold, max_keypoints=cfg.max_keypoints)


def is_baseline(cfg: DerivsInterpolation) -> bool:
    """True for the dense setInterval-1 case."""
    return cfg.keypoint_method == SET_INTERVAL and cfg.minN == 1


# ---------------------------------------------------------------------------
# Keypoint masks: shape (..., N-1) over steps 0..N-2, True where an exact
# Jacobian is evaluated.
# ---------------------------------------------------------------------------


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


def _force_last_keypoint(mask: np.ndarray, N: int) -> np.ndarray:
    """(B, N-1) host masks: where a row's last True isn't at N-2, move it
    there (a row's only keypoint 0 moves too, as in the JAX package)."""
    mask = mask.copy()
    rows = np.arange(mask.shape[0])
    last = np.where(mask, np.arange(N - 1), -1).max(axis=1)
    move = (last != N - 2) & (last >= 0)
    mask[rows[move], last[move]] = False
    mask[:, N - 2] = True
    return mask


def jerk_profile(x: torch.Tensor, N: int, n: int) -> torch.Tensor:
    """Second difference of the velocity trace: x (..., N, n), velocities
    the trailing n/2 entries -> (..., N-3, n/2)."""
    dof = n // 2
    vel = x[..., n - dof:]
    return (vel[..., 2:N - 1, :] - 2.0 * vel[..., 1:N - 2, :]
            + vel[..., 0:N - 3, :])


def _adaptive_jerk_masks_host(cfg: DerivsInterpolation, exceeds: np.ndarray,
                              N: int) -> np.ndarray:
    """The adaptiveJerk counter scan over (B, N-3) host exceed flags, all
    scenarios at once: starting from keypoint 0, step t becomes a
    keypoint when the counter reaches minN and the jerk exceeds the
    threshold, or unconditionally at maxN.  -> (B, N-1) masks."""
    B = exceeds.shape[0]
    counter = np.zeros(B, np.int64)
    hits = np.zeros_like(exceeds)
    for t in range(exceeds.shape[1]):
        counter += 1
        hit_jerk = (counter >= cfg.minN) & exceeds[:, t]
        counter[hit_jerk] = 0
        hit_max = counter >= cfg.maxN
        counter[hit_max] = 0
        hits[:, t] = hit_jerk | hit_max
    mask = np.zeros((B, N - 1), bool)
    mask[:, 0] = True
    mask[:, :N - 3] |= hits
    return _force_last_keypoint(mask, N)


def adaptive_jerk_masks(cfg: DerivsInterpolation, x: torch.Tensor
                        ) -> np.ndarray:
    """Host (B, N-1) adaptiveJerk masks of trajectories x (B, N, n): the
    exceed flags on x's device, one copy to the host, the scan there."""
    B, N, n = x.shape
    exceeds = torch.any(jerk_profile(x, N, n) > cfg.jerk_threshold, dim=-1)
    return _adaptive_jerk_masks_host(cfg, exceeds.cpu().numpy(), N)


def adaptive_jerk_mask(cfg: DerivsInterpolation, x: torch.Tensor, N: int,
                       n: int) -> torch.Tensor:
    """Mask (N-1,) of the adaptiveJerk method for one trajectory x (N, n),
    on x's device."""
    mask = adaptive_jerk_masks(cfg, x.reshape(1, N, n))[0]
    return torch.as_tensor(mask, device=x.device)


def _dyadic_depth(N: int, minN: int) -> int:
    """Max bisection depth for segments of [0, N-2] wider than minN."""
    depth = 0
    width = N - 2
    while width > max(minN, 1):
        width = (width + 1) // 2
        depth += 1
    return depth + 1


def _adaptive_jerk_budget(cfg: DerivsInterpolation, N: int) -> int:
    """Upper bound on any adaptiveJerk mask's keypoint count: the counter
    resets on every hit, so consecutive hits are at least
    ``min(minN, maxN)`` steps apart (``maxN <= 0``: a hit at every step);
    with keypoint 0 and the forced last one the count is at most
    ``(N-3)//spacing + 3``."""
    spacing = max(1, min(cfg.minN, cfg.maxN)) if cfg.maxN > 0 else 1
    return min(N - 1, (N - 3) // spacing + 3)


def _dyadic_tree(N: int, minN: int):
    """The dyadic bisection tree over [0, N-2]: a list of levels, each
    ``(starts, ends, mids, wide)`` numpy arrays of length 2**level, in
    the JAX package's segment order (children: the first halves of every
    segment, then the second halves)."""
    levels = []
    starts = np.array([0], np.int32)
    ends = np.array([N - 2], np.int32)
    for _ in range(_dyadic_depth(N, minN)):
        mids = (starts + ends) // 2
        wide = (ends - starts) > minN
        levels.append((starts, ends, mids, wide))
        starts = np.concatenate([starts, mids])
        ends = np.concatenate([mids, ends])
    return levels


def _level_caps(levels, budget: int) -> list[int]:
    """Per-level lane caps of the budgeted bisection: 3 lanes for the root
    (s, m, e), then at most the level's wide segments until the budget is
    spent."""
    caps = [3]
    rem = max(0, budget - 3)
    for level in levels[1:]:
        cap = min(len(level[0]), int(np.sum(level[3])), rem)
        caps.append(cap)
        rem -= cap
    return caps


def _segment_error(fx_s, fx_e, fx_m, n: int) -> torch.Tensor:
    """Mean over 2n of the squared entries of the midpoint estimate's
    error (fx_s + fx_e)/2 - fx_m, per leading index."""
    return torch.sum((0.5 * (fx_s + fx_e) - fx_m) ** 2, dim=(-2, -1)) / (2 * n)


def iterative_error_mask(cfg: DerivsInterpolation, fx_full: torch.Tensor,
                         N: int) -> torch.Tensor:
    """Mask (N-1,) of the iterativeError method, the bisection replayed on
    a precomputed Jacobian stack ``fx_full`` (N-1, n, n): a segment (s, e)
    with ``e - s > minN`` marks s, m = (s+e)//2 and e as evaluated; where
    the midpoint estimate's error exceeds the threshold both halves are
    checked in turn.  The dense counterpart of the lazy evaluation in
    :func:`compute_derivatives_batched`."""
    n = fx_full.shape[-1]
    dev = fx_full.device
    starts = torch.zeros(1, dtype=torch.long, device=dev)
    ends = torch.full((1,), N - 2, dtype=torch.long, device=dev)
    active = torch.ones(1, dtype=torch.bool, device=dev)
    visited = torch.zeros(N - 1, dtype=torch.bool, device=dev)
    for _ in range(_dyadic_depth(N, cfg.minN)):
        mids = (starts + ends) // 2
        check = active & ((ends - starts) > cfg.minN)
        for idx in (starts, mids, ends):
            visited[idx[check]] = True
        err = _segment_error(fx_full[starts], fx_full[ends], fx_full[mids], n)
        bad = check & (err > cfg.iterative_error_threshold)
        starts = torch.cat([starts, mids])
        ends = torch.cat([mids, ends])
        active = torch.cat([bad, bad])
    return visited


# ---------------------------------------------------------------------------
# Interpolation between keypoints.
# ---------------------------------------------------------------------------


def _prev_next_keypoint(mask: torch.Tensor):
    """Per-step indices of the surrounding keypoints of masks (..., T):
    prev[t] = largest keypoint <= t, next[t] = smallest keypoint >= t+1
    (clamped to the last keypoint).  Without a keypoint at or before t,
    prev is -1, which reads the last step, as the JAX package's gather
    does."""
    T = mask.shape[-1]
    idx = torch.arange(T, device=mask.device).expand_as(mask)
    prev = torch.cummax(torch.where(mask, idx, -1), dim=-1).values
    nxt_rev = torch.flip(torch.cummin(
        torch.flip(torch.where(mask, idx, T), dims=(-1,)), dim=-1).values,
        dims=(-1,))
    last = torch.amax(torch.where(mask, idx, -1), dim=-1, keepdim=True)
    nxt = torch.minimum(torch.maximum(nxt_rev, prev), last)
    return prev, nxt


def interpolate_stack(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Linearly interpolate stacks vals (..., T, ...) between the masked
    keypoints of mask (..., T) (the leading axes shared): for consecutive
    keypoints s < e and s <= t < e, out[t] = vals[s] + (vals[e] - vals[s])
    (t - s) / (e - s); out[t] = vals[t] at keypoints."""
    T = mask.shape[-1]
    lead = mask.dim() - 1
    prev, nxt = _prev_next_keypoint(mask)
    t = torch.arange(T, device=mask.device)
    denom = torch.clamp(nxt - prev, min=1)
    w = (t - prev).to(vals.dtype) / denom.to(vals.dtype)
    w = torch.where(mask, torch.zeros_like(w), w)
    trail = vals.dim() - lead - 1
    w = w.reshape(w.shape + (1,) * trail)

    def take(ix):
        ix = ix % T                    # -1 reads the last step
        ix = ix.reshape(ix.shape + (1,) * trail).expand(vals.shape)
        return torch.gather(vals, lead, ix)

    return take(prev) * (1.0 - w) + take(nxt) * w


# ---------------------------------------------------------------------------
# Batched derivatives through a lane-major Jacobian.
# ---------------------------------------------------------------------------


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
    chunk = cfg.jac_chunk

    def jac_lanes(xL, uL, xnL):
        """The Jacobian of lane-last inputs, at most ``jac_chunk`` lanes a
        call."""
        L = xL.shape[-1]
        step = L if chunk is None else max(1, int(chunk))
        parts = []
        for a in range(0, L, step):
            sl = slice(a, a + step)
            ins = (xL[:, sl], uL[:, sl]) + ((xnL[:, sl],) if root else ())
            parts.append(jac_T(*(t.contiguous() for t in ins)))
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in (0, 1))

    def at_indices(x_k, u_k, xn_k):
        """Jacobians at gathered keypoints: x_k (B, K, n) -> (B, K, n, n)."""
        K = x_k.shape[1]
        lane = lambda a, d: a.reshape(B * K, d).T.contiguous()
        fx_L, fu_L = jac_lanes(lane(x_k, n), lane(u_k, m),
                               lane(xn_k, n) if root else None)
        fx_k = fx_L.reshape(n, n, B, K).permute(2, 3, 0, 1)
        fu_k = fu_L.reshape(n, m, B, K).permute(2, 3, 0, 1)
        return fx_k, fu_k

    if is_baseline(cfg):
        fx, fu = at_indices(x[:, :-1], u, xn)
        return fx, fu, torch.full((B,), 100.0, dtype=dtype, device=dev)

    if cfg.keypoint_method == SET_INTERVAL:
        return _set_interval(cfg, at_indices, x, u, xn)

    bufs = _LaneBuffers(x, u, xn, jac_lanes, root)
    if cfg.keypoint_method == ADAPTIVE_JERK:
        masks = adaptive_jerk_masks(cfg, x)
        counts = masks.sum(axis=1)
        budget = (_adaptive_jerk_budget(cfg, N) if cfg.max_keypoints is None
                  else min(int(cfg.max_keypoints), T))
        if counts.max() > budget:
            b = int(counts.argmax())
            raise ValueError(
                f"adaptiveJerk: scenario {b} has {int(counts[b])} keypoints, "
                f"over the budget max_keypoints={cfg.max_keypoints} (the "
                "JAX package reads zero Jacobians at the dropped ones); "
                "raise max_keypoints or leave it unset")
        bufs.evaluate(*np.nonzero(masks))
    elif (N - 2) > cfg.minN:           # ITERATIVE_ERROR
        masks = _iterative_error_lazy(cfg, bufs, B, N, n)
    else:
        # the root segment is not wide: the JAX package's replay visits
        # nothing, and its interpolation reads the last step everywhere
        masks = np.zeros((B, T), bool)
        bufs.evaluate(np.arange(B), np.full(B, T - 1))
    mask_t = torch.as_tensor(masks, device=dev)
    pct = 100.0 * mask_t.sum(dim=1).to(dtype) / T
    return (interpolate_stack(mask_t, bufs.fx),
            interpolate_stack(mask_t, bufs.fu), pct)


def compute_derivatives(step: Callable, cfg: DerivsInterpolation,
                        x: torch.Tensor, u: torch.Tensor):
    """(fx, fu, percent) of one trajectory through a per-scenario step:
    the JAX package's ``compute_derivatives``.

    The keypoints of the configured method get exact Jacobians,
    ``torch.func.jacfwd`` of ``step`` vmapped over the keypoints (at most
    ``jac_chunk`` a call), and the steps between are interpolated, through
    :func:`compute_derivatives_batched` at B = 1.  ``max_keypoints`` caps
    the iterativeError bisection as there; for setInterval and
    adaptiveJerk a mask with more keypoints than ``max_keypoints`` raises
    ValueError (the JAX package reads zero Jacobians at the dropped
    ones).

    Args:
        step: (x (n,), u (m,)) -> x_next (n,).
        cfg: interpolation config (validated).
        x: (N, n) trajectory.
        u: (N-1, m) control tape.
    Returns:
        fx (N-1, n, n), fu (N-1, n, m), percent: a 0-d tensor in [0, 100].
    """
    from torch.func import jacfwd, vmap

    jac_T = vmap(jacfwd(step, argnums=(0, 1)), in_dims=-1, out_dims=-1)
    N = x.shape[0]
    if (cfg.keypoint_method == SET_INTERVAL and not is_baseline(cfg)
            and cfg.max_keypoints is not None):
        count = int(set_interval_mask(N, cfg.minN).sum())
        if count > cfg.max_keypoints:
            raise ValueError(
                f"setInterval: {count} keypoints, over the budget "
                f"max_keypoints={cfg.max_keypoints} (the JAX package reads "
                "zero Jacobians at the dropped ones); raise max_keypoints "
                "or leave it unset")
    fx, fu, pct = compute_derivatives_batched(jac_T, cfg, x[None], u[None])
    return fx[0], fu[0], pct[0]


def _set_interval(cfg, at_indices, x, u, xn):
    """The static schedule: interpolate straight from the compact (B, K,
    ...) keypoint stack with host-side prev/next indices and weights."""
    B, N, _ = x.shape
    T = N - 1
    dtype, dev = x.dtype, x.device
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


class _LaneBuffers:
    """(B, T, n, n) / (B, T, n, m) Jacobian stacks filled at gathered
    (scenario, step) pairs, one Jacobian call per :meth:`evaluate`; the
    steps never evaluated stay zero (interpolation never reads them)."""

    def __init__(self, x, u, xn, jac_lanes, root):
        B, N, n = x.shape
        m = u.shape[-1]
        self.x, self.u, self.xn = x, u, xn
        self.jac_lanes, self.root = jac_lanes, root
        self.fx = x.new_zeros((B, N - 1, n, n))
        self.fu = x.new_zeros((B, N - 1, n, m))

    def evaluate(self, b: np.ndarray, t: np.ndarray):
        """Jacobians at the lanes (b[i], t[i]) into the stacks."""
        dev = self.x.device
        b = torch.as_tensor(np.asarray(b, np.int64), device=dev)
        t = torch.as_tensor(np.asarray(t, np.int64), device=dev)
        fx, fu = self.jac_lanes(self.x[b, t].T, self.u[b, t].T,
                                self.xn[b, t].T if self.root else None)
        self.fx[b, t] = fx.permute(2, 0, 1)
        self.fu[b, t] = fu.permute(2, 0, 1)


def _iterative_error_lazy(cfg, bufs: _LaneBuffers, B: int, N: int, n: int):
    """The iterativeError bisection of every scenario, level by level: one
    Jacobian call per level over the wanted mids of all scenarios (the
    root level: s, m, e), one host read of the level's error flags.  With
    ``max_keypoints`` each scenario checks at most the level's cap of its
    wanted segments, the first in the tree's order; the rest are accepted.
    Returns the host (B, N-1) visited masks."""
    T = N - 1
    thr = cfg.iterative_error_threshold
    levels = _dyadic_tree(N, cfg.minN)
    caps = (_level_caps(levels, max(3, int(cfg.max_keypoints)))
            if cfg.max_keypoints is not None else [None] * len(levels))
    visited = np.zeros((B, T), bool)
    rows = np.arange(B)

    s0, e0, m0 = 0, N - 2, (N - 2) // 2
    bufs.evaluate(np.repeat(rows, 3), np.tile([s0, m0, e0], B))
    visited[:, [s0, m0, e0]] = True
    fx = bufs.fx
    err0 = _segment_error(fx[:, s0], fx[:, e0], fx[:, m0], n)
    bad0 = (err0 > thr).cpu().numpy()
    active = np.stack([bad0, bad0], axis=1)               # (B, 2)

    for (starts, ends, mids, wide), cap in zip(levels[1:], caps[1:]):
        if cap == 0:
            break
        want = active & wide[None]
        if cap is not None:
            want &= np.cumsum(want, axis=1) <= cap
        b, j = np.nonzero(want)
        if len(b) == 0:
            break                      # no segment is checked below here
        bufs.evaluate(b, mids[j])
        visited[b, mids[j]] = True
        bt = torch.as_tensor(b, device=fx.device)
        at = lambda ix: fx[bt, torch.as_tensor(ix[j].astype(np.int64),
                                                device=fx.device)]
        err = _segment_error(at(starts), at(ends), at(mids), n)
        bad = np.zeros((B, len(starts)), bool)
        bad[b, j] = (err > thr).cpu().numpy()
        active = np.concatenate([bad, bad], axis=1)
    return visited
