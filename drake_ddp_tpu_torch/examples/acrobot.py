"""Acrobot swing-up, with optional receding-horizon MPC.

Port of ``drake_ddp_tpu/examples/acrobot.py``: T = 3, dt = 0.004
(N = 750, the longest horizon of the examples), x0 = 0,
x_nom = [pi, 0, 0, 0], Q = 0.01 diag([0, 0, 1, 1]), R = 0.01 I,
Qf = 100 I, beta = 0.5; the MPC mode runs 50 resolves at 2-step replans
through :func:`~drake_ddp_tpu_torch.mpc.driver.mpc_solve`.  The Riccati
phase is the associative scan by default (``parallel_backward``).  The
analytic system runs its own lane step and ``torch.func`` Jacobian.

    python -m drake_ddp_tpu_torch.examples.acrobot           # on the card
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from drake_ddp_tpu_torch._device import resolve_device
from drake_ddp_tpu_torch.dynamics.analytic import acrobot_system
from drake_ddp_tpu_torch.mpc.driver import MPCConfig, mpc_solve
from drake_ddp_tpu_torch.solver.api import IterativeLinearQuadraticRegulator
from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig, ILQRProblem


@dataclasses.dataclass(frozen=True)
class Config:
    T: float = 3.0
    dt: float = 0.004
    beta: float = 0.5
    # "ilqr" or "sqp" (the direct-transcription baseline)
    method: str = "ilqr"
    MPC: bool = False
    num_resolves: int = 50
    replan_steps: int = 2
    max_iters: int = 100
    verbose: bool = True
    # the associative-scan Riccati (solver/parscan.py)
    parallel_backward: bool = True


def build_system(cfg: Config):
    return acrobot_system(dt=cfg.dt)


def _cost_matrices(cfg: Config):
    Q = cfg.dt * 0.01 * np.diag([0.0, 0.0, 1.0, 1.0])
    R = cfg.dt * 0.01 * np.eye(1)
    Qf = 100.0 * np.eye(4)
    return Q, R, Qf


def run(cfg: Config = Config(), device="cuda", timer=None, on_solve=None):
    """One solve, or the MPC chain with ``cfg.MPC``, on ``device``.

    Returns (states (4, N), inputs (1, N-1), solve_time, cost), and in
    MPC mode (stitched states (4, N + resolves * replan), last control
    tape, solve_time, costs (num_resolves + 1,)).  ``timer``: a
    :class:`~drake_ddp_tpu_torch.utils.timing.PhaseTimer` for the
    solver's phases; ``on_solve``: optional callable that gets the
    ILQRSolution (numpy), or in MPC mode the MPCResult."""
    dev = resolve_device(device)
    system = build_system(cfg)
    num_steps = int(cfg.T / cfg.dt)
    Q, R, Qf = _cost_matrices(cfg)
    x_nom = np.array([np.pi, 0.0, 0.0, 0.0])

    if not cfg.MPC:
        ilqr = IterativeLinearQuadraticRegulator(
            system, num_steps, beta=cfg.beta, verbose=cfg.verbose,
            max_iters=cfg.max_iters,
            parallel_backward=cfg.parallel_backward, device=dev,
            timer=timer)
        ilqr.SetInitialState(np.zeros(4))
        ilqr.SetTargetState(x_nom)
        ilqr.SetRunningCost(Q, R)
        ilqr.SetTerminalCost(Qf)
        ilqr.SetInitialGuess(np.zeros((1, num_steps - 1)))
        if cfg.method == "sqp":
            states, inputs, solve_time, optimal_cost = \
                ilqr.SolveDirectTranscription()
        else:
            states, inputs, solve_time, optimal_cost = ilqr.Solve()
            if on_solve is not None:
                on_solve(ilqr._solution)
        print(f"Solved in {solve_time} seconds using {cfg.method}")
        print(f"Optimal cost: {optimal_cost}")
        return states, inputs, solve_time, optimal_cost

    solver_cfg = ILQRConfig(num_steps=num_steps, beta=cfg.beta,
                            max_iters=cfg.max_iters,
                            parallel_backward=cfg.parallel_backward)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
    prob = ILQRProblem(x0=t(np.zeros(4)), x_nom=t(x_nom), Q=t(Q), R=t(R),
                       Qf=t(Qf), u_init=t(np.zeros((num_steps - 1, 1))))
    mpc = MPCConfig(num_resolves=cfg.num_resolves,
                    replan_steps=cfg.replan_steps)
    st = time.time()
    res = mpc_solve(system, solver_cfg, prob, mpc, timer=timer)
    costs = res.costs.cpu().numpy()
    solve_time = time.time() - st
    if on_solve is not None:
        on_solve(res)
    print(f"Solved {cfg.num_resolves + 1} MPC solves in {solve_time} s")
    print(f"Final cost: {costs[-1]}")
    return (res.states.cpu().numpy().T, res.final_u.cpu().numpy().T,
            solve_time, costs)


if __name__ == "__main__":
    run()
