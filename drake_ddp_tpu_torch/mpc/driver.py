"""Receding-horizon MPC driver, batched and per scenario.

Port of ``drake_ddp_tpu/mpc/driver.py``: an initial solve plus
``num_resolves`` resolves of a scenario batch (:func:`mpc_solve_batched`)
or of one scenario (:func:`mpc_solve`, the batched driver at B = 1 on
the per-scenario kernels), each resolve warm-started from the previous
one:

- warm start: keep the tail of the last optimal control tape and repeat
  the final input for the new steps (optionally with the previous
  solution's time-varying LQR policy, ``policy_warm_start``);
- open-loop handoff: the next initial state is the predicted state
  ``replan_steps`` into the last solution;
- optional moving target: x_nom advances by ``x_nom_shift`` each resolve;
- chain health: a resolve that diverged or converged above
  ``resolve_cost_ceiling`` coasts on its last-good policy, a lane whose
  previous resolve failed is re-seeded with ``rescue_u``, and a lane that
  fails ``freeze_after`` resolves in a row is latched dead (frozen).

The JAX package scans over resolves inside one compiled program; here
the resolves are a Python loop around :func:`solve_ilqr_batched`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
from drake_ddp_tpu_torch.solver.ilqr import (
    ILQRConfig,
    ILQRProblem,
    scenario_routes,
    unbatch,
)
from drake_ddp_tpu_torch.utils.timing import spanned


class MPCConfig(NamedTuple):
    num_resolves: int      # additional solves after the initial one
    replan_steps: int      # horizon shift per resolve (>0)
    # Seed every resolve with the previous solution's time-varying LQR
    # policy (shifted K + state reference) in addition to the shifted
    # control tape: replaying a tape open loop through stiff contact
    # diverges over the horizon tail, the closed-loop seed keeps the
    # incumbent bounded.
    policy_warm_start: bool = False
    # Latch divergence: once a lane's resolve fails ``freeze_after``
    # times in a row, freeze it for the rest of the chain (its solves
    # exit at iteration 0 and it coasts on the last-good policy).
    freeze_diverged: bool = False
    freeze_after: int = 1
    # A resolve that converges to a cost above this is treated exactly
    # like a diverged one; inf = off.
    resolve_cost_ceiling: float = float("inf")


class MPCResult(NamedTuple):
    """Leading axis B from :func:`mpc_solve_batched`; none from
    :func:`mpc_solve`."""

    states: torch.Tensor      # (B, N + resolves*replan, n) stitched traj
    costs: torch.Tensor       # (B, num_resolves + 1) optimal cost per solve
    iterations: torch.Tensor  # (B, num_resolves + 1) iLQR iterations
    diverged: torch.Tensor    # (B, num_resolves + 1) failed-resolve flags
    final_x: torch.Tensor     # (B, N, n) last solution
    final_u: torch.Tensor     # (B, N-1, m) last control tape
    final_K: Optional[torch.Tensor] = None   # (B, N-1, m, n) last gains
    # chain-health latch state, to thread across chunked calls through
    # ILQRProblem.frozen and ``consec0``
    dead: Optional[torch.Tensor] = None      # (B,) latched-dead flags
    consec: Optional[torch.Tensor] = None    # (B,) consecutive failures


def shift_warm_start(u: torch.Tensor, replan_steps: int) -> torch.Tensor:
    """u (N-1, m): drop the first replan_steps inputs, repeat the last."""
    return _shift_tape(u, replan_steps, time_axis=0)


def shift_warm_start_batched(u: torch.Tensor,
                             replan_steps: int) -> torch.Tensor:
    """u (B, N-1, m): drop the first replan_steps inputs, repeat the last."""
    return _shift_tape(u, replan_steps, time_axis=1)


def _shift_tape(a: torch.Tensor, replan_steps: int, time_axis: int = 0):
    """Shift any time-major tape: drop the first replan_steps entries
    along ``time_axis``, repeat the last entry to keep the length."""
    T = a.shape[time_axis]
    tail = a.narrow(time_axis, replan_steps, T - replan_steps)
    last = a.narrow(time_axis, T - 1, 1)
    reps = [1] * a.dim()
    reps[time_axis] = replan_steps
    return torch.cat([tail, last.repeat(reps)], dim=time_axis)


def _sel_lane(mask, a, b):
    """Per-lane select of (B, ...) tensors by a (B,) mask."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


@spanned("mpc")
def mpc_solve_batched(
    system: DiscreteSystem,
    cfg: ILQRConfig,
    prob: ILQRProblem,
    mpc: MPCConfig,
    x_nom_shift: Optional[torch.Tensor] = None,
    rollout_kernel: str = "fused",
    deriv_kernel: str = "megajac",
    consec0: Optional[torch.Tensor] = None,
    rescue_u: Optional[torch.Tensor] = None,
    timer=None,
    root_seed=None,
) -> MPCResult:
    """Initial solve + ``mpc.num_resolves`` receding-horizon resolves of a
    batch: ``prob`` leaves carry a leading batch axis B and the MPCResult
    leaves do too.  ``rollout_kernel``, ``deriv_kernel`` and ``root_seed``
    as in :func:`solve_ilqr_batched`.

    ``x_nom_shift``: optional (n,) target advance applied once per resolve.
    ``consec0``: optional (B,) consecutive-failure counts carried in from
    a previous chunked call.  ``rescue_u`` ((N-1, m) or (B, N-1, m)): a
    lane whose previous resolve failed is re-seeded with this open-loop
    tape (zero gains) instead of its coasted stale policy.  ``timer``: an
    optional PhaseTimer handed to every solve; the whole call is its
    host-only span ``mpc``."""
    N, rs = cfg.num_steps, mpc.replan_steps
    if mpc.freeze_diverged and not mpc.policy_warm_start:
        raise ValueError(
            "freeze_diverged requires policy_warm_start: a frozen lane's "
            "solve returns its warm-start trajectory, which without the "
            "policy seed is the zeros init")
    solve = lambda p: solve_ilqr_batched(system, cfg, p,
                                         rollout_kernel=rollout_kernel,
                                         deriv_kernel=deriv_kernel,
                                         root_seed=root_seed, timer=timer)
    B, n = prob.x0.shape
    dev = prob.x0.device
    dead_prior = (prob.frozen if prob.frozen is not None
                  else torch.zeros(B, dtype=torch.bool, device=dev))
    rescue_ub = (None if rescue_u is None
                 else rescue_u.expand(prob.u_init.shape))
    if rescue_ub is not None and consec0 is None:
        # the entry rescue must not silently disappear when the caller
        # doesn't thread a consec count
        consec0 = torch.zeros(B, dtype=torch.int32, device=dev)
    prob0 = prob
    if rescue_ub is not None:
        # the previous chunk's last resolve failed: the entry solve gets
        # the safe default seed for that lane
        resc0 = (consec0 >= 1) & ~dead_prior
        prob0 = prob0._replace(u_init=_sel_lane(resc0, rescue_ub,
                                                prob.u_init))
        if mpc.policy_warm_start and prob.K_init is not None:
            prob0 = prob0._replace(K_init=_sel_lane(
                resc0, torch.zeros_like(prob.K_init), prob.K_init))
    sol0 = solve(prob0)
    # a resolve is "bad" if it diverged OR converged to a garbage optimum;
    # dead lanes are excluded (their iteration-0 exit carries L = inf)
    bad0 = (sol0.diverged | ~(sol0.cost <= mpc.resolve_cost_ceiling)) \
        & ~dead_prior
    div0 = bad0 | dead_prior
    x_prev, u_prev, K_prev = sol0.x, sol0.u, sol0.K
    if mpc.policy_warm_start and prob.K_init is not None:
        # coast a failed entry solve on the policy it was seeded with
        x_prev = _sel_lane(div0, prob.x_ref_init, sol0.x)
        u_prev = _sel_lane(div0, prob.u_init, sol0.u)
        K_prev = _sel_lane(div0, prob.K_init, sol0.K)
    consec = (consec0 if consec0 is not None
              else torch.zeros(B, dtype=torch.int32, device=dev))
    consec = torch.where(bad0, consec + 1, torch.zeros_like(consec))
    dead = dead_prior
    if mpc.freeze_diverged:
        dead = dead | (consec >= mpc.freeze_after)

    x_nom = prob.x_nom
    xs, costs, iters, divs = [], [sol0.cost], [sol0.iterations], [div0]
    for _ in range(mpc.num_resolves):
        u_guess = shift_warm_start_batched(u_prev, rs)
        x0 = x_prev[:, rs]
        if x_nom_shift is not None:
            x_nom = x_nom + x_nom_shift
        # rescue failed lanes with the safe default seed; the coast tapes
        # still back the handoff if this solve fails too.  x_ref_init
        # stays the coasted x_guess: with K_seed = 0 it never enters the
        # first rollout
        resc = ((consec >= 1) & ~dead) if rescue_ub is not None else None
        u_seed = (u_guess if resc is None
                  else _sel_lane(resc, rescue_ub, u_guess))
        p = prob._replace(x0=x0, x_nom=x_nom, u_init=u_seed)
        if mpc.freeze_diverged:
            p = p._replace(frozen=dead)
        if mpc.policy_warm_start:
            K_guess = _shift_tape(K_prev, rs, time_axis=1)
            x_guess = _shift_tape(x_prev, rs, time_axis=1)
            K_seed = (K_guess if resc is None
                      else _sel_lane(resc, torch.zeros_like(K_guess),
                                     K_guess))
            p = p._replace(K_init=K_seed, x_ref_init=x_guess)
        sol = solve(p)
        bad = (sol.diverged | ~(sol.cost <= mpc.resolve_cost_ceiling)) \
            & ~dead
        div = bad | dead
        x_prev, u_prev, K_prev = sol.x, sol.u, sol.K
        if mpc.policy_warm_start:
            # a failed solve's trajectory and gains are garbage: coast on
            # the shifted last-good policy instead
            x_prev = _sel_lane(div, x_guess, sol.x)
            u_prev = _sel_lane(div, u_guess, sol.u)
            K_prev = _sel_lane(div, K_guess, sol.K)
        consec = torch.where(bad, consec + 1, torch.zeros_like(consec))
        if mpc.freeze_diverged:
            dead = dead | (consec >= mpc.freeze_after)
        xs.append(x_prev)
        costs.append(sol.cost)
        iters.append(sol.iterations)
        divs.append(div)

    # stitch the playback trajectory: the initial solution occupies
    # [0, N); resolve i writes its full horizon at offset (i+1)*rs
    states = torch.zeros((B, N + rs * mpc.num_resolves, n),
                         dtype=sol0.x.dtype, device=dev)
    states[:, :N] = sol0.x
    for i, xi in enumerate(xs):
        states[:, (i + 1) * rs:(i + 1) * rs + N] = xi
    stack = lambda seq: torch.stack(seq, dim=1)
    return MPCResult(
        states=states, costs=stack(costs), iterations=stack(iters),
        diverged=stack(divs), final_x=x_prev, final_u=u_prev,
        final_K=K_prev, dead=dead, consec=consec)


def mpc_solve(
    system: DiscreteSystem,
    cfg: ILQRConfig,
    prob: ILQRProblem,
    mpc: MPCConfig,
    x_nom_shift: Optional[torch.Tensor] = None,
    consec0: Optional[torch.Tensor] = None,
    rescue_u: Optional[torch.Tensor] = None,
    timer=None,
) -> MPCResult:
    """Initial solve + ``mpc.num_resolves`` resolves of one scenario:
    ``prob`` without a batch axis (x0 (n,), u_init (N-1, m), ...), the
    MPCResult likewise (states (N + resolves*replan, n), costs
    (num_resolves + 1,), dead and consec 0-dim).

    :func:`mpc_solve_batched` at B = 1 on the kernels that
    :func:`~drake_ddp_tpu_torch.solver.ilqr.scenario_routes` picks by the
    system, as :func:`~drake_ddp_tpu_torch.solver.ilqr.solve_ilqr`.
    ``consec0`` (0-dim) and ``rescue_u`` ((N-1, m)) as there."""
    one = lambda a: None if a is None else a[None]
    return unbatch(mpc_solve_batched(
        system, cfg, ILQRProblem(*map(one, prob)), mpc,
        x_nom_shift=x_nom_shift, consec0=one(consec0), rescue_u=rescue_u,
        timer=timer, **scenario_routes(system)))
