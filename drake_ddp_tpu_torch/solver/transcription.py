"""Direct transcription baseline: the reference's SQP comparison path.

Port of ``drake_ddp_tpu/solver/transcription.py``.  States and controls
are decision variables; the dynamics defects carry an increasing
quadratic penalty (a penalty-SQP homotopy), and each penalty subproblem
takes Adam steps and then a damped Gauss-Newton polish.  The optimum
meets the constrained program's first-order conditions as rho -> inf.

The Adam update is written in tensor ops with optax's formula
(bias-corrected moments, eps outside the square root, the state reset
every round), so both packages take the same steps; ``torch.autograd``
gives the gradient where the JAX package uses ``jax.grad``.  The
Gauss-Newton Jacobian of the residuals is assembled from the step's
lane Jacobians (the system's ``lane_jac_fn``) into the same dense matrix
that ``jax.jacfwd`` of the residual function gives.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


class TranscriptionConfig(NamedTuple):
    """Penalty-method direct transcription settings.

    num_steps: horizon N (as ILQRConfig).
    rho_init/rho_mult/num_rounds: defect-penalty homotopy rho_k =
        rho_init * rho_mult^k for num_rounds rounds.
    inner_steps: Adam steps per round.
    lr: Adam learning rate.
    gn_steps: damped Gauss-Newton polish steps per round: the penalized
        program is a nonlinear least-squares, and first-order steps alone
        plateau on the stiff terminal cost.
    gn_damping: damping added to the normal equations.
    """

    num_steps: int
    rho_init: float = 0.1
    rho_mult: float = 10.0
    num_rounds: int = 6
    inner_steps: int = 300
    lr: float = 0.05
    gn_steps: int = 4
    gn_damping: float = 1e-6


class TranscriptionSolution(NamedTuple):
    x: torch.Tensor             # (N, n) transcribed states
    u: torch.Tensor             # (N-1, m) control tape
    cost: torch.Tensor          # cost of the transcribed (x, u)
    defect: torch.Tensor        # max dynamics defect of the transcribed vars
    rollout_cost: torch.Tensor  # cost of the open-loop rollout of u
    objective: torch.Tensor     # final penalized objective


def _total_cost(prob: ILQRProblem, x, u):
    """sum (x-x_nom)'Q(x-x_nom) + u'Ru over t = 0..N-2, plus terminal."""
    dx = x[:-1] - prob.x_nom
    running = (torch.einsum("ti,ij,tj->", dx, prob.Q, dx)
               + torch.einsum("ti,ij,tj->", u, prob.R, u))
    dxf = x[-1] - prob.x_nom
    return running + dxf @ prob.Qf @ dxf


def _sqrtm(A):
    """Square root of a symmetric PSD matrix."""
    w, V = torch.linalg.eigh(A)
    return (V * torch.sqrt(torch.clamp(w, min=0.0))) @ V.T


def solve_transcription(system: DiscreteSystem, cfg: TranscriptionConfig,
                        prob: ILQRProblem) -> TranscriptionSolution:
    """Solve min_{x,u} cost(x, u) + rho ||x_{t+1} - f(x_t, u_t)||^2 with x_0
    fixed, rho increasing.  ``prob`` without a batch axis; the solution
    lives on its device."""
    T = cfg.num_steps - 1
    n, m = prob.x0.shape[-1], prob.u_init.shape[-1]
    dtype, dev = prob.x0.dtype, prob.x0.device
    X = T * n

    def steps(x_full, u):
        """f(x_t, u_t) for t = 0..N-2, over the lane axis at once."""
        return system.lane_step_fn(x_full[:-1].T, u.T).T

    def full(xs):
        return torch.cat([prob.x0[None], xs], dim=0)

    def objective(xs, u, rho):
        x_full = full(xs)
        defects = steps(x_full, u) - x_full[1:]
        return _total_cost(prob, x_full, u) + rho * torch.sum(defects ** 2)

    sq_Q, sq_R, sq_Qf = _sqrtm(prob.Q), _sqrtm(prob.R), _sqrtm(prob.Qf)

    def split(z):
        return z[:X].reshape(T, n), z[X:].reshape(T, m)

    def residuals(z, rho):
        """The penalized objective as residuals: objective ==
        sum(residuals^2)."""
        xs, u = split(z)
        x_full = full(xs)
        return torch.cat([
            ((x_full[:-1] - prob.x_nom) @ sq_Q.T).reshape(-1),
            (u @ sq_R.T).reshape(-1),
            math.sqrt(rho) * (steps(x_full, u) - x_full[1:]).reshape(-1),
            sq_Qf @ (x_full[-1] - prob.x_nom)])

    t = torch.arange(T, device=dev)
    eye_n = torch.eye(n, dtype=dtype, device=dev)

    def jacobian(z, rho):
        """d residuals / dz, dense, from the step's Jacobians."""
        xs, u = split(z)
        x_full = full(xs)
        fx, fu = system.lane_jac_fn(x_full[:-1].T, u.T)
        fx, fu = fx.permute(2, 0, 1), fu.permute(2, 0, 1)
        s = math.sqrt(rho)
        J = torch.zeros(2 * X + T * m + n, X + T * m, dtype=dtype,
                        device=dev)

        def blocks(r0, nr, c0, nc):
            # rows r0.. as T blocks of nr, columns c0.. as T blocks of nc
            return J[r0:r0 + T * nr, c0:c0 + T * nc].view(T, nr, T, nc)

        r_state, r_input, r_defect = 0, X, X + T * m
        # x_t (t >= 1) is xs[t - 1]; x_0 is fixed
        blocks(r_state, n, 0, n)[t[1:], :, t[1:] - 1, :] = sq_Q
        blocks(r_input, m, X, m)[t, :, t, :] = sq_R
        defect_x = blocks(r_defect, n, 0, n)
        defect_x[t[1:], :, t[1:] - 1, :] = s * fx[1:]
        defect_x[t, :, t, :] = -s * eye_n
        blocks(r_defect, n, X, m)[t, :, t, :] = s * fu
        J[2 * X + T * m:, (T - 1) * n:X] = sq_Qf
        return J

    def gn_polish(xs, u, rho):
        """Damped Gauss-Newton on the residual form; a step is kept only
        if it lowers the objective."""
        z = torch.cat([xs.reshape(-1), u.reshape(-1)])
        damp = cfg.gn_damping * torch.eye(z.shape[0], dtype=dtype,
                                          device=dev)
        for _ in range(cfg.gn_steps):
            r = residuals(z, rho)
            J = jacobian(z, rho)
            dz = torch.linalg.solve(J.T @ J + damp, J.T @ r)
            z_new = z - dz
            better = (torch.sum(residuals(z_new, rho) ** 2)
                      < torch.sum(r ** 2))
            z = torch.where(better, z_new, z)
        return split(z)

    def adam_round(xs, u, rho):
        """``inner_steps`` Adam steps from a fresh optimizer state."""
        z = [xs, u]
        mu = [torch.zeros_like(a) for a in z]
        nu = [torch.zeros_like(a) for a in z]
        for count in range(1, cfg.inner_steps + 1):
            leaves = [a.detach().requires_grad_(True) for a in z]
            with torch.enable_grad():
                grads = torch.autograd.grad(objective(*leaves, rho), leaves)
            c1 = 1.0 - ADAM_B1 ** count
            c2 = 1.0 - ADAM_B2 ** count
            for i, g in enumerate(grads):
                mu[i] = (1.0 - ADAM_B1) * g + ADAM_B1 * mu[i]
                nu[i] = (1.0 - ADAM_B2) * g * g + ADAM_B2 * nu[i]
                step = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + ADAM_EPS)
                z[i] = z[i] + (-cfg.lr) * step
        return z[0].detach(), z[1].detach()

    # start from the rollout of the initial control tape
    u = prob.u_init.to(dtype)
    xs = system.rollout(prob.x0, u)[1:]
    rhos = [cfg.rho_init * cfg.rho_mult ** k for k in range(cfg.num_rounds)]
    for rho in rhos:
        xs, u = adam_round(xs, u, rho)
        if cfg.gn_steps > 0:
            xs, u = gn_polish(xs, u, rho)

    x_full = full(xs)
    defect = torch.max(torch.abs(steps(x_full, u) - x_full[1:]))
    return TranscriptionSolution(
        x=x_full, u=u, cost=_total_cost(prob, x_full, u), defect=defect,
        rollout_cost=_total_cost(prob, system.rollout(prob.x0, u), u),
        objective=objective(xs, u, rhos[-1]))
