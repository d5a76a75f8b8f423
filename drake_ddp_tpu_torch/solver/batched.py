"""Natively batched iLQR with the rollout on a hand-written CUDA kernel.

Port of ``drake_ddp_tpu/solver/batched.py``: the iLQR solver with the
scenario batch as an explicit leading axis B.

- The closed-loop linesearch rollout runs the ls_parallel candidates
  folded into the lane axis (lane index c*B + b) through the fused
  whole-horizon kernel (``rollout_kernel="fused"``, :mod:`ops.megaroll`)
  or one step kernel launch per horizon step (``"megastep"``,
  :mod:`ops.megastep`).  On CPU tensors both run their plain versions.
- Derivatives come from the root-seeded lane Jacobian in plain PyTorch
  (``deriv_kernel="lane"``, :mod:`multibody.lanejac`), through the
  keypoint schedule of :mod:`solver.keypoints`.
- Both loops keep what ``jax.vmap`` makes of a batched ``while_loop``:
  iterate while ANY lane is active, freeze the carry of inactive lanes.
  Each round costs one host synchronisation to read that flag;
  :func:`any_lane` counts them.

Kernel choice is an explicit setting: there is no fallback between
kernels.
"""

from __future__ import annotations

from functools import partial

import torch

from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.ops.megaroll import (megaroll_for_system,
                                              rollout_plain)
from drake_ddp_tpu_torch.ops.megastep import megastep_for_system
from drake_ddp_tpu_torch.solver import keypoints as kp
from drake_ddp_tpu_torch.solver.ilqr import (
    ILQRConfig,
    ILQRProblem,
    ILQRSolution,
    ILQRStats,
    _backward_pass,
    _cost_steps,
    _LoopState,
)
from drake_ddp_tpu_torch.utils.timing import phase

ROLLOUT_KERNELS = ("fused", "megastep")


def any_lane(mask: torch.Tensor) -> bool:
    """``mask.any()`` read on the host: one synchronisation, counted in
    ``any_lane.syncs``."""
    any_lane.syncs += 1
    return bool(mask.any())


any_lane.syncs = 0


def _tile_c(a, C):
    """(..., B) -> (..., C*B) with lane index c*B + b."""
    return a.repeat((1,) * (a.dim() - 1) + (C,))


def _lanes(a):
    """(B, T, ...) tape -> time-major lane layout (T, ..., B)."""
    return a.permute(*range(1, a.dim()), 0)


def _chunk_rollout_lanes(rollout, prob, state, eps_cb,
                         cost_ceiling=float("inf"), timer=None):
    """Closed-loop rollouts of eps_cb (C, B) candidates in one lane batch.

    ``rollout(x0, eps, u_bar, kappa, K, x_bar)`` is the fused kernel or
    a per-step loop (see :func:`_rollout_for`).  prob/state leaves carry
    a leading batch axis B.  Returns x (C, B, N, n), u (C, B, N-1, m),
    L (C, B), steps (C, B, N)."""
    C, B = eps_cb.shape
    N, n = state.x_bar.shape[1], state.x_bar.shape[-1]
    m = state.u_bar.shape[-1]
    tile = lambda a: _tile_c(a, C).contiguous()
    x0 = tile(prob.x0.T)                                      # (n, CB)
    tapes = [tile(_lanes(a)) for a in (state.u_bar, state.kappa, state.K,
                                       state.x_bar[:, :-1])]
    with phase(timer, "rollout"):
        xs, us = rollout(x0, eps_cb.reshape(C * B), *tapes)
    x_full = torch.cat([x0[None], xs], dim=0)                 # (N, n, CB)
    # back to batch-first candidate-major layout
    x_out = x_full.reshape(N, n, C, B).permute(2, 3, 0, 1)
    u_out = us.reshape(N - 1, m, C, B).permute(2, 3, 0, 1)
    steps = _cost_steps(prob, x_out, u_out)                   # (C, B, N)
    L = torch.sum(steps, dim=-1)
    L = torch.where(torch.isfinite(L) & (L <= cost_ceiling), L,
                    torch.full_like(L, float("inf")))
    return x_out, u_out, L, steps


def _linesearch_batched(rollout, cfg, prob, state, timer=None):
    """Batched backtracking linesearch: the accepted eps of each lane is
    the first (largest) entry of {1, beta, beta^2, ...} whose improvement
    beats gamma * expected; lanes that have accepted freeze their carry.

    Returns (eps, x, u, L, improvement, n_iters, failed, floor_cut)."""
    B = state.x_bar.shape[0]
    dtype, dev = state.x_bar.dtype, state.x_bar.device
    C = max(1, int(cfg.ls_parallel))
    beta = torch.tensor(cfg.beta, dtype=dtype, device=dev)
    powers = beta ** torch.arange(C, dtype=dtype, device=dev)
    chunk_factor = beta ** C
    dV_sum = torch.sum(state.dV_coeff, dim=1)                 # (B,)
    steps_bar = _cost_steps(prob, state.x_bar, state.u_bar)   # (B, N)
    have_incumbent = torch.isfinite(state.L)
    lane_ix = torch.arange(B, device=dev)

    def allowed(eps):
        # candidates whose predicted decrease eps (1 - eps/2) dV_sum cannot
        # reach ls_expected_floor are skipped (per lane)
        return ~have_incumbent | (
            eps * (1.0 - eps / 2.0) * dV_sum >= cfg.ls_expected_floor)

    def chunk(eps_start):
        eps_cb = eps_start[None, :] * powers[:, None]         # (C, B)
        x, u, L, steps = _chunk_rollout_lanes(rollout, prob, state, eps_cb,
                                              cfg.cost_ceiling, timer)
        expected = -eps_cb * (1.0 - eps_cb / 2.0) * dV_sum[None]
        diff = torch.sum(steps_bar[None] - steps, dim=2)      # (C, B)
        inf = torch.full_like(diff, float("inf"))
        finite = torch.isfinite(L)
        improvement = torch.where(have_incumbent[None], diff,
                                  torch.where(finite, inf, -inf))
        improvement = torch.where(finite, improvement, -inf)
        accept = ((improvement > cfg.gamma * expected)
                  & (eps_cb >= cfg.eps_min) & allowed(eps_cb))
        found = torch.any(accept, dim=0)                      # (B,)
        idx = torch.argmax(accept.to(torch.uint8), dim=0)     # first True
        return (found, idx, eps_cb[idx, lane_ix], x[idx, lane_ix],
                u[idx, lane_ix], L[idx, lane_ix], improvement[idx, lane_ix])

    eps_start = torch.ones(B, dtype=dtype, device=dev)
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iters = torch.zeros(B, dtype=torch.int32, device=dev)
    eps = torch.ones(B, dtype=dtype, device=dev)
    x, u = state.x_bar, state.u_bar
    L = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    imp = torch.zeros(B, dtype=dtype, device=dev)
    k = 0
    while True:
        active = ~found & (eps_start >= cfg.eps_min) & allowed(eps_start)
        if not any_lane(active):
            break
        found_c, idx, eps_c, x_c, u_c, L_c, imp_c = chunk(eps_start)
        n_new = (k * C + idx + 1).to(torch.int32)
        sel = lambda new, old: torch.where(
            active.reshape((B,) + (1,) * (old.dim() - 1)), new, old)
        eps_start = sel(eps_start * chunk_factor, eps_start)
        found, n_iters = sel(found | found_c, found), sel(n_new, n_iters)
        eps, x, u = sel(eps_c, eps), sel(x_c, x), sel(u_c, u)
        L, imp = sel(L_c, L), sel(imp_c, imp)
        k += 1
    floor_cut = ~found & (eps_start >= cfg.eps_min) & ~allowed(eps_start)
    return eps, x, u, L, imp, n_iters, ~found, floor_cut


def _rollout_for(system: DiscreteSystem, rollout_kernel: str):
    """The linesearch rollout ``(x0, eps, u_bar, kappa, K, x_bar) ->
    (xs, us)`` for an explicit kernel choice."""
    if rollout_kernel == "fused":
        return megaroll_for_system(system)
    if rollout_kernel == "megastep":
        return partial(rollout_plain, megastep_for_system(system))
    raise ValueError(f"rollout_kernel must be one of {ROLLOUT_KERNELS}, "
                     f"got {rollout_kernel!r}")


def solve_ilqr_batched(
    system: DiscreteSystem,
    cfg: ILQRConfig,
    prob: ILQRProblem,
    rollout_kernel: str = "fused",
    deriv_kernel: str = "lane",
    timer=None,
) -> ILQRSolution:
    """Batched iLQR: every ``prob`` leaf carries a leading batch axis B;
    the returned ILQRSolution leaves do too.

    ``rollout_kernel``: 'fused' (one megaroll launch per linesearch
    chunk) or 'megastep' (one megastep launch per horizon step).
    ``deriv_kernel``: 'lane', the root-seeded structured-IFT lane
    Jacobian in plain PyTorch; the megajac kernel is the next slice.
    ``timer``: optional :class:`~drake_ddp_tpu_torch.utils.timing.
    PhaseTimer` that gets the rollout, lane_jac, derivs and riccati
    phases."""
    cfg.derivs.validate()
    if deriv_kernel != "lane":
        raise NotImplementedError(
            f"deriv_kernel={deriv_kernel!r}: only the plain lane Jacobian "
            "('lane') is ported; the megajac kernel is the next slice")
    if system.lane_jac_root_fn is None:
        raise ValueError("system provides no root-seeded lane Jacobian")
    rollout = _rollout_for(system, rollout_kernel)
    N = cfg.num_steps
    B, n = prob.x0.shape
    m = prob.u_init.shape[-1]
    dtype, dev = prob.x0.dtype, prob.x0.device

    # root seeding: the trajectory handed to the derivative phase is the
    # accepted rollout, whose x_{t+1} IS the converged contact root
    jac_root = system.lane_jac_root_fn

    def jac_T(x, u, x_next):
        with phase(timer, "lane_jac"):
            return jac_root(x, u, x_next)

    derivs_fn = partial(kp.compute_derivatives_batched, jac_T, cfg.derivs,
                        root=True)
    adaptive = cfg.reg > 0.0
    lane_ix = torch.arange(B, device=dev)

    def forward_and_backward(state: _LoopState) -> _LoopState:
        (eps, x, u, L_new, imp, ls_iters, failed,
         floor_cut) = _linesearch_batched(rollout, cfg, prob, state, timer)

        selb = lambda flag, a, b: torch.where(
            flag.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
        x_use = selb(failed, state.x_bar, x)
        u_use = selb(failed, state.u_bar, u)
        L_use = torch.where(failed, state.L, L_new)
        if adaptive:
            reg_new = torch.where(
                failed, state.reg * cfg.reg_mult,
                torch.clamp(state.reg / cfg.reg_mult, min=cfg.reg))
        else:
            reg_new = state.reg
        # floor_cut = every remaining candidate's predicted decrease is
        # below ls_expected_floor <= delta: convergence, not divergence.
        # isfinite(L): a lane with no finite incumbent is not at an optimum
        at_optimum = (((torch.sum(state.dV_coeff, dim=1) <= cfg.delta)
                       | floor_cut) & (state.iteration > 0)
                      & torch.isfinite(state.L))
        exhausted = ((state.reg >= cfg.reg_max) | at_optimum
                     | (not adaptive))
        retry = failed & ~exhausted
        diverged = failed & exhausted & ~at_optimum

        # fresh derivatives for every lane; failed lanes keep the cached
        # stack (valid only after iteration 0: before that it is the zeros
        # init, and a first-iteration failure must linearize the kept
        # trajectory, e.g. the policy warm start)
        cache_ok = failed & (state.iteration > 0)
        with phase(timer, "derivs"):
            fx_new, fu_new, pct = derivs_fn(x_use, u_use)
        fx = selb(cache_ok, state.fx, fx_new)
        fu = selb(cache_ok, state.fu, fu_new)
        percent = torch.where(failed, torch.zeros_like(pct), pct)
        with phase(timer, "riccati"):
            kappa, K, dV = _backward_pass(cfg, prob, x_use, u_use, fx, fu,
                                          reg_new)

        # inactive lanes (iteration == max_iters) write a discarded slot
        it = state.iteration.long().clamp(max=cfg.max_iters - 1)

        def put(tab, v):
            tab = tab.clone()
            tab[lane_ix, it] = v.to(tab.dtype)
            return tab

        stats = ILQRStats(
            cost=put(state.stats.cost, L_use),
            eps=put(state.stats.eps, torch.where(failed,
                                                 torch.zeros_like(eps), eps)),
            ls_iters=put(state.stats.ls_iters, ls_iters),
            percent_derivs=put(state.stats.percent_derivs, percent),
        )
        improvement = torch.where(failed, torch.zeros_like(imp), imp)
        return _LoopState(
            x_bar=x_use, u_bar=u_use, fx=fx, fu=fu, kappa=kappa, K=K,
            dV_coeff=dV, L=L_use, improvement=improvement,
            iteration=state.iteration + 1, reg=reg_new, retry=retry,
            diverged=diverged, stats=stats)

    def lane_cond(state: _LoopState) -> torch.Tensor:
        c = (((state.improvement > cfg.delta) | state.retry)
             & (state.iteration < cfg.max_iters) & ~state.diverged)
        if prob.frozen is not None:
            c = c & ~prob.frozen
        return c

    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    stats0 = ILQRStats(
        cost=zeros(B, cfg.max_iters), eps=zeros(B, cfg.max_iters),
        ls_iters=zeros(B, cfg.max_iters, dt=torch.int32),
        percent_derivs=zeros(B, cfg.max_iters))
    # policy warm start: with K_init / x_ref_init the FIRST linesearch
    # rollout is closed-loop around the previous solution
    warm = prob.K_init is not None
    state = _LoopState(
        x_bar=prob.x_ref_init.to(dtype) if warm else zeros(B, N, n),
        u_bar=prob.u_init.to(dtype),
        fx=zeros(B, N - 1, n, n), fu=zeros(B, N - 1, n, m),
        kappa=zeros(B, N - 1, m),
        K=prob.K_init.to(dtype) if warm else zeros(B, N - 1, m, n),
        dV_coeff=zeros(B, N - 1),
        L=torch.full((B,), float("inf"), dtype=dtype, device=dev),
        improvement=torch.full((B,), float("inf"), dtype=dtype, device=dev),
        iteration=zeros(B, dt=torch.int32),
        reg=torch.full((B,), cfg.reg, dtype=dtype, device=dev),
        retry=zeros(B, dt=torch.bool), diverged=zeros(B, dt=torch.bool),
        stats=stats0)

    while True:
        active = lane_cond(state)
        if not any_lane(active):
            break
        new = forward_and_backward(state)
        sel = lambda a, b: torch.where(
            active.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
        state = _LoopState(*(
            ILQRStats(*map(sel, a, b)) if isinstance(a, ILQRStats)
            else sel(a, b) for a, b in zip(new, state)))
    return ILQRSolution(
        x=state.x_bar, u=state.u_bar, K=state.K, kappa=state.kappa,
        cost=state.L, iterations=state.iteration, diverged=state.diverged,
        stats=state.stats)
