"""iLQR records, per-step costs, the batched Riccati sweep and the
per-scenario solve.

Port of ``drake_ddp_tpu/solver/ilqr.py``: the configuration and problem
records, the per-step cost and the Riccati backward pass, written with an
explicit leading batch axis B where the JAX package vmaps its
per-scenario functions, and :func:`solve_ilqr`, the per-scenario solve,
which runs the batched loop of :mod:`drake_ddp_tpu_torch.solver.batched`
on a batch of one (the JAX package pins its batched solver to
``jax.vmap(solve_ilqr)``, so one loop serves both).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from drake_ddp_tpu_torch.multibody.plant import is_multibody
from drake_ddp_tpu_torch.solver import keypoints as kp
from drake_ddp_tpu_torch.utils.linalg import solve_spd


class ILQRConfig(NamedTuple):
    """Static solver configuration (the JAX package's ILQRConfig).

    Attributes:
        num_steps: horizon length N (states x_0..x_{N-1}, controls
            u_0..u_{N-2}).
        delta: convergence tolerance on cost improvement.
        beta: linesearch backtracking factor in (0, 1).
        gamma: linesearch sufficient-decrease parameter.
        max_iters: bound on outer iterations.
        eps_min: linesearch failure threshold.
        cost_ceiling: candidates whose total cost exceeds this are
            rejected like infeasible (non-finite) rollouts; inf = off.
        reg: initial Quu Tikhonov regularization; adaptive (Levenberg)
            when > 0: a failed linesearch multiplies it by ``reg_mult`` and
            retries until ``reg_max``, success divides it back toward
            ``reg``.
        reg_mult: adaptive regularization growth/decay factor.
        reg_max: divergence is declared only once reg exceeds this.
        derivs: keypoint derivative-interpolation config.
        ls_parallel: linesearch candidates {1, beta, beta^2, ...} rolled
            out together, folded into the rollout's lane axis.
        parallel_backward: run the Riccati phase as the associative scan
            of :mod:`~drake_ddp_tpu_torch.solver.parscan` (O(log N)
            levels of batched products) instead of the sequential sweep.
        ls_expected_floor: skip candidates whose predicted decrease
            eps (1 - eps/2) sum(dV_coeff) is below this floor, and treat a
            lane that exhausts the schedule this way as converged.
    """

    num_steps: int
    delta: float = 1e-2
    beta: float = 0.95
    gamma: float = 0.0
    max_iters: int = 100
    eps_min: float = 1e-8
    cost_ceiling: float = float("inf")
    reg: float = 1e-6
    reg_mult: float = 10.0
    reg_max: float = 1e3
    derivs: kp.DerivsInterpolation = kp.BASELINE
    ls_parallel: int = 8
    parallel_backward: bool = False
    ls_expected_floor: float = 0.0


class ILQRProblem(NamedTuple):
    """Problem data, every field with a leading batch axis B for the
    batched solver (none for :func:`solve_ilqr`):
        x0 (B, n), x_nom (B, n), Q (B, n, n), R (B, m, m), Qf (B, n, n),
        u_init (B, N-1, m) time-major control tapes.

    Optional policy warm start (both None = open-loop tape warm start):
        K_init (B, N-1, m, n) feedback gains applied around
        x_ref_init (B, N, n) during the FIRST forward rollout.
    frozen: optional (B,) bool; a frozen lane exits at iteration 0 with
        its warm-start trajectory and L = inf (the MPC chain's latch).
    """

    x0: torch.Tensor
    x_nom: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    Qf: torch.Tensor
    u_init: torch.Tensor
    K_init: Optional[torch.Tensor] = None
    x_ref_init: Optional[torch.Tensor] = None
    frozen: Optional[torch.Tensor] = None


class ILQRStats(NamedTuple):
    """Per-iteration diagnostics (B, max_iters), masked by iterations
    ((max_iters,) from :func:`solve_ilqr`)."""

    cost: torch.Tensor
    eps: torch.Tensor
    ls_iters: torch.Tensor
    percent_derivs: torch.Tensor


class ILQRSolution(NamedTuple):
    x: torch.Tensor           # (B, N, n) optimal state trajectories
    u: torch.Tensor           # (B, N-1, m) optimal control tapes
    K: torch.Tensor           # (B, N-1, m, n) feedback gains
    kappa: torch.Tensor       # (B, N-1, m) feedforward terms
    cost: torch.Tensor        # (B,) final costs
    iterations: torch.Tensor  # (B,) int32 outer iterations executed
    diverged: torch.Tensor    # (B,) bool — linesearch exhausted
    stats: ILQRStats


class _LoopState(NamedTuple):
    x_bar: torch.Tensor
    u_bar: torch.Tensor
    fx: torch.Tensor        # (B, N-1, n, n) cached Jacobians at x_bar
    fu: torch.Tensor        # (B, N-1, n, m)
    kappa: torch.Tensor
    K: torch.Tensor
    dV_coeff: torch.Tensor
    L: torch.Tensor
    improvement: torch.Tensor
    iteration: torch.Tensor
    reg: torch.Tensor       # current adaptive Quu regularization
    retry: torch.Tensor     # bool — last linesearch failed, reg was raised
    diverged: torch.Tensor
    stats: ILQRStats


def _cost_steps(prob: ILQRProblem, x: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Per-step costs (..., B, N): running terms for t < N-1, terminal at
    N-1, for x (..., B, N, n), u (..., B, N-1, m); leading axes in front
    of B broadcast (the linesearch's candidate axis).  The linesearch
    sums per-step cost *differences*: in f32 the difference of two large
    cost sums loses the small improvements of late backtracking steps.

    The quadratic forms are elementwise products summed one axis at a
    time, so a lane's cost has the same bits at any batch size: a batched
    einsum's contraction order follows the batch, and a float32 chain
    amplifies a flipped linesearch acceptance (a scenario's answer would
    move with how its batch is sharded)."""
    quad = lambda a, M, b: (a[..., :, None] * M * b[..., None, :]).sum(
        -1).sum(-1)
    dx = x[..., :-1, :] - prob.x_nom[:, None]
    running = (quad(dx, prob.Q[:, None], dx)
               + quad(u, prob.R[:, None], u))
    dxf = x[..., -1, :] - prob.x_nom
    terminal = quad(dxf, prob.Qf, dxf)
    return torch.cat([running, terminal[..., None]], dim=-1)


def _lane_mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` over a batch (A (..., r, k), v (..., k)) as elementwise
    products summed over the last axis, so a lane gets the same bits in
    any batch.  A batched matrix-vector product on the card picks its
    kernel, and with it the summation order, by the batch count: a lane's
    feed-forward terms moved when its batch of 256 was split in two, and a
    float32 chain amplifies that into another answer for the scenario."""
    return (A * v[..., None, :]).sum(-1)


def _backward_pass(cfg: ILQRConfig, prob: ILQRProblem, x_bar, u_bar, fx, fu,
                   reg):
    """Riccati sweep over a batch: x_bar (B, N, n), u_bar (B, N-1, m), fx
    (B, N-1, n, n), fu (B, N-1, n, m), reg (B,) -> kappa (B, N-1, m),
    K (B, N-1, m, n), dV (B, N-1).

    Gauss-Newton iLQR update equations with a Cholesky gain solve and a
    Tikhonov term on Quu.  Full float32 on the card (TF32 is off, see the
    package ``__init__``): reduced-precision products compound over the
    value recursion and can overflow on stiff linearizations.  The
    matrix-vector products are :func:`_lane_mv`'s; with them a lane gets
    the same bits in a batch of 256 as in either half of it on an H100
    (the batched matrix products' kernels did not change between those
    batch counts), so a sharded batch solves each scenario as the whole
    batch does."""
    N = x_bar.shape[1]
    m = u_bar.shape[-1]
    x_nom, Q, R, Qf = prob.x_nom, prob.Q, prob.R, prob.Qf
    tr = lambda a: a.transpose(-1, -2)
    mv = _lane_mv

    Vx = 2.0 * mv(Qf, x_bar[:, -1] - x_nom)
    Vxx = 2.0 * Qf
    reg_eye = reg[:, None, None] * torch.eye(m, dtype=x_bar.dtype,
                                             device=x_bar.device)
    kappas, Ks, dVs = [None] * (N - 1), [None] * (N - 1), [None] * (N - 1)
    for t in reversed(range(N - 1)):
        fx_t, fu_t = fx[:, t], fu[:, t]
        lx = 2.0 * mv(Q, x_bar[:, t] - x_nom)
        lu = 2.0 * mv(R, u_bar[:, t])
        fxT_Vxx, fuT_Vxx = tr(fx_t) @ Vxx, tr(fu_t) @ Vxx
        Qx = lx + mv(tr(fx_t), Vx)
        Qu = lu + mv(tr(fu_t), Vx)
        Qxx = 2.0 * Q + fxT_Vxx @ fx_t
        Quu = 2.0 * R + fuT_Vxx @ fu_t + reg_eye
        Qux = fuT_Vxx @ fx_t
        sol = solve_spd(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
        kappa_t, K_t = sol[..., 0], sol[..., 1:]
        dVs[t] = torch.sum(Qu * kappa_t, dim=-1)
        # symmetrize Vxx every step: in f32 the asymmetry drift over the
        # horizon visibly degrades the gains
        Vx = Qx - mv(tr(Qux), kappa_t)
        Vxx = Qxx - tr(Qux) @ K_t
        Vxx = 0.5 * (Vxx + tr(Vxx))
        kappas[t], Ks[t] = kappa_t, K_t
    return (torch.stack(kappas, dim=1), torch.stack(Ks, dim=1),
            torch.stack(dVs, dim=1))


def scenario_routes(system, deriv_kernel: Optional[str] = None,
                    root_seed: Optional[bool] = None) -> dict:
    """The kernels of a per-scenario solve, by the system: a multibody
    system rolls out on megaroll (``rollout_kernel="fused"``) and
    differentiates with the cold-Newton megajac (``"megajac"``, the IFT
    at the step's own Newton root, as ``jax.jacfwd`` of the JAX
    per-scenario step gives); a system without kernel data, such as an
    analytic one, runs its own lane step and lane Jacobian (``"plain"``,
    ``"lane"``).  ``deriv_kernel`` names the Jacobian route instead;
    ``root_seed`` True linearizes at the rollout's own next states (the
    root-seeded Jacobian), False runs the Jacobian's own Newton, None
    takes the system's route.  Keyword arguments of
    :func:`~drake_ddp_tpu_torch.solver.batched.solve_ilqr_batched`."""
    multibody = is_multibody(system)
    return dict(rollout_kernel="fused" if multibody else "plain",
                deriv_kernel=deriv_kernel or ("megajac" if multibody
                                              else "lane"),
                root_seed=False if root_seed is None else bool(root_seed))


def unbatch(sol, i=0):
    """Batch element ``i`` of a batched record (a NamedTuple of tensors
    with a leading batch axis, whose fields may hold a nested NamedTuple,
    such as ILQRStats, or None)."""
    return type(sol)(*(
        None if f is None else unbatch(f, i) if isinstance(f, tuple)
        else f[i] for f in sol))


def solve_ilqr(system, cfg: ILQRConfig, prob: ILQRProblem,
               deriv_kernel: Optional[str] = None,
               timer=None) -> ILQRSolution:
    """The iLQR solve of one scenario: ``prob`` without a batch axis
    (x0 (n,), Q (n, n), u_init (N-1, m), ...); the solution likewise.

    The batched loop at B = 1 on the kernels :func:`scenario_routes`
    picks by the system (``deriv_kernel`` names another Jacobian route).
    On CPU tensors the kernel wrappers run their plain versions.
    ``timer`` as in :func:`~drake_ddp_tpu_torch.solver.batched.
    solve_ilqr_batched`."""
    from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched

    return unbatch(solve_ilqr_batched(
        system, cfg,
        ILQRProblem(*(None if a is None else a[None] for a in prob)),
        timer=timer, **scenario_routes(system, deriv_kernel)))
