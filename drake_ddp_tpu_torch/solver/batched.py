"""Natively batched iLQR with the rollout on a hand-written CUDA kernel.

Port of ``drake_ddp_tpu/solver/batched.py``: the iLQR solver with the
scenario batch as an explicit leading axis B.

- The closed-loop linesearch rollout runs the ls_parallel candidates
  folded into the lane axis (lane index c*B + b) through the fused
  whole-horizon kernel (``rollout_kernel="fused"``, :mod:`ops.megaroll`)
  or one step kernel launch per horizon step (``"megastep"``,
  :mod:`ops.megastep`).  On CPU tensors both run their plain versions.
  ``"plain"`` loops the system's own lane step: the route of a system
  without kernel data, such as an analytic one.
- Derivatives come from the step's lane Jacobian, through the keypoint
  schedule of :mod:`solver.keypoints`: the megajac CUDA kernels
  (``deriv_kernel="megajac"``, :mod:`ops.megajac`) or the system's own
  lane Jacobian (``"lane"``; for a multibody system the plain PyTorch
  structured IFT of :mod:`multibody.lanejac`), root-seeded or
  cold-Newton as ``root_seed`` says.
- The Riccati phase is the sequential sweep, or with
  ``cfg.parallel_backward`` the associative scan of :mod:`solver.parscan`.
- Both loops keep what ``jax.vmap`` makes of a batched ``while_loop``:
  iterate while ANY lane is active, freeze the carry of inactive lanes.
  Each round costs one host synchronisation to read that flag;
  :func:`any_lane` counts them.  A single scenario (B = 1) also reads
  whether its round is a regularization retry, and skips the derivative
  call then, as the per-scenario JAX solve's ``lax.cond`` does.
- Given a timer (:mod:`utils.timing`), the solve is the host-only span
  ``solve``, its phases ``linesearch``, ``rollout``, ``derivs``, ``jac``
  and ``riccati``, and each read of the loops' flag the host-only span
  ``wait.round`` or ``wait.ls`` (the host blocked on the card).  Such a
  read is then the lane count, in the same one synchronisation: each
  round adds its lanes still iterating to the counter ``lanes_active``
  and B to ``lane_slots``; each linesearch chunk adds the lanes it rolls
  out that are active in the round and still searching to
  ``ls_lanes_kept`` and B to ``ls_lane_slots``.

Kernel choice is an explicit setting: there is no fallback between
kernels.
"""

from __future__ import annotations

from functools import partial

import torch

from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.ops.megajac import megajac_for_system
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
from drake_ddp_tpu_torch.solver.parscan import parallel_backward_pass
from drake_ddp_tpu_torch.utils.timing import count, phase, span, spanned

ROLLOUT_KERNELS = ("fused", "megastep", "plain")
DERIV_KERNELS = ("megajac", "lane")


def any_lane(mask: torch.Tensor) -> bool:
    """``mask.any()`` read on the host: one synchronisation, counted in
    ``any_lane.syncs``."""
    any_lane.syncs += 1
    return bool(mask.any())


any_lane.syncs = 0


def _lanes_left(mask, timer, wait, counters=None, keep=None) -> bool:
    """Whether any lane of ``mask`` (B,) is set: :func:`any_lane` inside
    the host-only span ``wait``.  With a timer and a pair of
    ``counters``, the read is the lane count instead (still one
    synchronisation), and a read that finds lanes adds the lanes of
    ``mask`` (and of ``keep``) to ``counters[0]`` and B to
    ``counters[1]`` (:func:`~drake_ddp_tpu_torch.utils.timing.count`)."""
    with span(timer, wait):
        if timer is None or counters is None:
            return any_lane(mask)
        any_lane.syncs += 1
        if keep is None:
            n = kept = int(mask.sum())
        else:
            n, kept = torch.stack((mask.sum(),
                                   (mask & keep).sum())).tolist()
    if n:
        count(timer, counters[0], kept)
        count(timer, counters[1], mask.numel())
    return n > 0


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


def _linesearch_batched(rollout, cfg, prob, state, timer=None,
                        lanes=None):
    """Batched backtracking linesearch: the accepted eps of each lane is
    the first (largest) entry of {1, beta, beta^2, ...} whose improvement
    beats gamma * expected; lanes that have accepted freeze their carry.
    ``lanes``: the round's active lanes (B,), for the timer's count of
    the rolled-out lanes whose result the round keeps.

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
        if not _lanes_left(active, timer, "wait.ls",
                           ("ls_lanes_kept", "ls_lane_slots"), lanes):
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
    if rollout_kernel == "plain":
        return partial(rollout_plain, system.lane_step_fn)
    raise ValueError(f"rollout_kernel must be one of {ROLLOUT_KERNELS}, "
                     f"got {rollout_kernel!r}")


def _jac_for(system: DiscreteSystem, deriv_kernel: str, root_seed=None):
    """The lane Jacobian for an explicit kernel choice, and whether it is
    root-seeded.  Root-seeded: the trajectory handed to the derivative
    phase is the accepted rollout, whose x_{t+1} is the converged contact
    root, so the Jacobian's own Newton can be skipped.  Cold-Newton: the
    Jacobian runs the step's own Newton first.  ``root_seed`` None takes
    the root-seeded Jacobian when the system has one."""
    if deriv_kernel not in DERIV_KERNELS:
        raise ValueError(f"deriv_kernel must be one of {DERIV_KERNELS}, "
                         f"got {deriv_kernel!r}")
    has_root = system.lane_jac_root_fn is not None
    root = has_root if root_seed is None else bool(root_seed)
    if (root and not has_root) or (not root and system.lane_jac_fn is None):
        kind = "root-seeded" if root else "cold-Newton"
        raise ValueError(f"system provides no lane Jacobian ({kind})")
    if deriv_kernel == "megajac":
        return megajac_for_system(system, root_seed=root), root
    return (system.lane_jac_root_fn if root else system.lane_jac_fn), root


def _round_flags(cfg, state: _LoopState, failed, floor_cut):
    """A round's regularization update and its retry and divergence
    flags (B,), from the round's incoming state and its linesearch's
    ``failed`` and ``floor_cut``: Levenberg regularization raised on a
    failure and decayed toward ``cfg.reg`` on success; a failure retries
    until reg reaches ``reg_max``, and diverges then unless the lane is
    at an optimum.  Returns (reg_new, retry, diverged)."""
    adaptive = cfg.reg > 0.0
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
    return reg_new, retry, diverged


def _lane_cond(cfg, prob: ILQRProblem, state: _LoopState) -> torch.Tensor:
    """The stopping test: the lanes (B,) that run another round (an
    improvement over ``delta`` or a regularization retry, below
    ``max_iters``, not diverged, not frozen)."""
    c = (((state.improvement > cfg.delta) | state.retry)
         & (state.iteration < cfg.max_iters) & ~state.diverged)
    if prob.frozen is not None:
        c = c & ~prob.frozen
    return c


@spanned("solve")
def solve_ilqr_batched(
    system: DiscreteSystem,
    cfg: ILQRConfig,
    prob: ILQRProblem,
    rollout_kernel: str = "fused",
    deriv_kernel: str = "megajac",
    root_seed=None,
    timer=None,
) -> ILQRSolution:
    """Batched iLQR: every ``prob`` leaf carries a leading batch axis B;
    the returned ILQRSolution leaves do too.

    ``rollout_kernel``: 'fused' (one megaroll launch per linesearch
    chunk), 'megastep' (one megastep launch per horizon step) or 'plain'
    (the system's lane step, one Python step per horizon step).
    ``deriv_kernel``: 'megajac' (the CUDA Jacobian kernels, one launch
    per derivative call) or 'lane' (the system's lane Jacobian).
    ``root_seed``: True for the root-seeded Jacobian
    (``lane_jac_root_fn``), False for the cold-Newton one
    (``lane_jac_fn``), None for the root-seeded one when the system has
    it, else the cold one.
    ``timer``: optional :class:`~drake_ddp_tpu_torch.utils.timing.
    PhaseTimer` that gets the solve span, the linesearch (with its
    rollouts), jac, derivs and riccati phases, the wait spans and the
    lane counters (see the module's docstring)."""
    cfg.derivs.validate()
    rollout = _rollout_for(system, rollout_kernel)
    jac, root = _jac_for(system, deriv_kernel, root_seed)
    N = cfg.num_steps
    B, n = prob.x0.shape
    m = prob.u_init.shape[-1]
    dtype, dev = prob.x0.dtype, prob.x0.device

    def jac_T(*lanes):
        with phase(timer, "jac"):
            return jac(*lanes)

    derivs_fn = partial(kp.compute_derivatives_batched, jac_T, cfg.derivs,
                        root=root)
    backward = (parallel_backward_pass if cfg.parallel_backward
                else _backward_pass)
    iters = torch.arange(cfg.max_iters, device=dev)

    def forward_and_backward(state: _LoopState, active) -> _LoopState:
        with phase(timer, "linesearch"):
            (eps, x, u, L_new, imp, ls_iters, failed,
             floor_cut) = _linesearch_batched(rollout, cfg, prob, state,
                                              timer, active)

        selb = lambda flag, a, b: torch.where(
            flag.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
        x_use = selb(failed, state.x_bar, x)
        u_use = selb(failed, state.u_bar, u)
        started = state.iteration > 0

        # fresh derivatives for every lane; failed lanes keep the cached
        # stack (valid only after iteration 0: before that it is the zeros
        # init, and a first-iteration failure must linearize the kept
        # trajectory, e.g. the policy warm start).  The round's other
        # bookkeeping follows the derivative launch, so that on the card
        # the host does it while the Jacobian kernels run.
        cache_ok = failed & started
        if B == 1 and not _lanes_left(~cache_ok, timer, "wait.round"):
            fx, fu = state.fx, state.fu
            percent = torch.zeros_like(state.L)
        else:
            with phase(timer, "derivs"):
                fx_new, fu_new, pct = derivs_fn(x_use, u_use)
            fx = selb(cache_ok, state.fx, fx_new)
            fu = selb(cache_ok, state.fu, fu_new)
            percent = torch.where(failed, torch.zeros_like(pct), pct)

        L_use = torch.where(failed, state.L, L_new)
        reg_new, retry, diverged = _round_flags(cfg, state, failed,
                                                floor_cut)

        # inactive lanes (iteration == max_iters) write a discarded slot
        it = state.iteration.long().clamp(max=cfg.max_iters - 1)
        slot = iters[None] == it[:, None]                     # (B, max_iters)

        def put(tab, v):
            return torch.where(slot, v.to(tab.dtype)[:, None], tab)

        stats = ILQRStats(
            cost=put(state.stats.cost, L_use),
            eps=put(state.stats.eps, torch.where(failed,
                                                 torch.zeros_like(eps), eps)),
            ls_iters=put(state.stats.ls_iters, ls_iters),
            percent_derivs=put(state.stats.percent_derivs, percent),
        )
        improvement = torch.where(failed, torch.zeros_like(imp), imp)
        with phase(timer, "riccati"):
            kappa, K, dV = backward(cfg, prob, x_use, u_use, fx, fu,
                                    reg_new)
        return _LoopState(
            x_bar=x_use, u_bar=u_use, fx=fx, fu=fu, kappa=kappa, K=K,
            dV_coeff=dV, L=L_use, improvement=improvement,
            iteration=state.iteration + 1, reg=reg_new, retry=retry,
            diverged=diverged, stats=stats)

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
        active = _lane_cond(cfg, prob, state)
        if not _lanes_left(active, timer, "wait.round",
                           ("lanes_active", "lane_slots")):
            break
        new = forward_and_backward(state, active)
        if B == 1:
            # the one lane is active: freezing nothing, the select is `new`
            state = new
            continue
        sel = lambda a, b: torch.where(
            active.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
        state = _LoopState(*(
            ILQRStats(*map(sel, a, b)) if isinstance(a, ILQRStats)
            else sel(a, b) for a, b in zip(new, state)))
    return ILQRSolution(
        x=state.x_bar, u=state.u_bar, K=state.K, kappa=state.kappa,
        cost=state.L, iterations=state.iteration, diverged=state.diverged,
        stats=state.stats)
