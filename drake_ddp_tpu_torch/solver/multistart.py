"""Multi-start iLQR: several perturbed initial control tapes, one batched
solve, the best kept.

Port of ``drake_ddp_tpu/solver/multistart.py``.  Contact-implicit
problems are multi-modal (the cart-pole wall task's local optima span
costs 25..1100 by the initial tape).  The JAX package vmaps the
per-scenario solve over the starts; here the K starts are the batch axis
of one :func:`~drake_ddp_tpu_torch.solver.batched.solve_ilqr_batched`
call on the per-scenario kernels (:func:`~drake_ddp_tpu_torch.solver.
ilqr.scenario_routes`): for a multibody system every linesearch chunk is
one megaroll launch over K x ls_parallel lanes and every fresh
derivative round one cold megajac launch over K x (N-1) lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
from drake_ddp_tpu_torch.solver.ilqr import (
    ILQRConfig,
    ILQRProblem,
    ILQRSolution,
    scenario_routes,
    unbatch,
)


class MultistartResult(NamedTuple):
    best: ILQRSolution        # the selected (lowest finite cost) solution
    best_index: torch.Tensor  # int32, 0-dim
    costs: torch.Tensor       # (num_starts,) every start's final cost


def solve_starts(system: DiscreteSystem, cfg: ILQRConfig, prob: ILQRProblem,
                 u_inits: torch.Tensor, timer=None) -> MultistartResult:
    """Solve ``prob`` (no batch axis) from each of the (K, N-1, m) control
    tapes ``u_inits`` in one batched solve of B = K and keep the best:
    the lowest final cost among the starts that neither diverged nor
    ended non-finite.  ``timer`` as in
    :func:`~drake_ddp_tpu_torch.solver.ilqr.solve_ilqr`."""
    K = u_inits.shape[0]
    tile = lambda a: None if a is None else a[None].expand(
        K, *a.shape).contiguous()
    probs = ILQRProblem(*map(tile, prob))._replace(
        u_init=u_inits.to(prob.u_init.dtype))
    sols = solve_ilqr_batched(system, cfg, probs, timer=timer,
                              **scenario_routes(system))
    score = torch.where(sols.diverged | ~torch.isfinite(sols.cost),
                        torch.full_like(sols.cost, float("inf")), sols.cost)
    best = torch.argmin(score)
    return MultistartResult(best=unbatch(sols, best),
                            best_index=best.to(torch.int32),
                            costs=sols.cost)


def multistart_ilqr(system: DiscreteSystem, cfg: ILQRConfig,
                    prob: ILQRProblem, num_starts: int,
                    generator: torch.Generator, guess_scale: float = 1.0,
                    include_given: bool = True,
                    timer=None) -> MultistartResult:
    """Solve from ``num_starts`` perturbed initial control tapes and keep
    the best (:func:`solve_starts`).

    Start 0 is the problem's own ``u_init`` when ``include_given``; the
    rest add N(0, guess_scale^2) noise to it, drawn with ``generator``
    (on the problem's device)."""
    K = int(num_starts)
    u = prob.u_init
    noise = guess_scale * torch.randn((K,) + tuple(u.shape),
                                      generator=generator, dtype=u.dtype,
                                      device=u.device)
    if include_given:
        noise[0] = 0.0
    return solve_starts(system, cfg, prob, u[None] + noise, timer=timer)
