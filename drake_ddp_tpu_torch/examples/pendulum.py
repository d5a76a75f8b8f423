"""Swing-up control of a simple inverted pendulum.

Port of ``drake_ddp_tpu/examples/pendulum.py``: T = 2.0, dt = 1e-2,
x0 = [0, 0], x_nom = [pi, 0], Q = 0.01 diag([0, 1]), R = 0.01 I,
Qf = 100 I, solver defaults delta = 1e-2, beta = 0.95, gamma = 0.

    python -m drake_ddp_tpu_torch.examples.pendulum          # on the card
"""

from __future__ import annotations

import dataclasses

import numpy as np

from drake_ddp_tpu_torch.dynamics.analytic import pendulum_system
from drake_ddp_tpu_torch.solver.api import IterativeLinearQuadraticRegulator


@dataclasses.dataclass(frozen=True)
class Config:
    T: float = 2.0
    dt: float = 1e-2
    delta: float = 1e-2
    beta: float = 0.95
    gamma: float = 0.0
    # "ilqr" or "sqp" (the direct-transcription baseline,
    # solver/transcription.py)
    method: str = "ilqr"
    verbose: bool = True


def build_system(cfg: Config):
    return pendulum_system(dt=cfg.dt)


def build_solver(cfg: Config, device="cuda"):
    system = build_system(cfg)
    num_steps = int(cfg.T / cfg.dt)
    ilqr = IterativeLinearQuadraticRegulator(
        system, num_steps,
        delta=cfg.delta, beta=cfg.beta, gamma=cfg.gamma, verbose=cfg.verbose,
        device=device,
    )
    ilqr.SetInitialState(np.array([0.0, 0.0]))
    ilqr.SetTargetState(np.array([np.pi, 0.0]))
    ilqr.SetRunningCost(cfg.dt * 0.01 * np.diag([0.0, 1.0]),
                        cfg.dt * 0.01 * np.eye(1))
    ilqr.SetTerminalCost(100.0 * np.diag([1.0, 1.0]))
    ilqr.SetInitialGuess(np.zeros((1, num_steps - 1)))
    return ilqr


def run(cfg: Config = Config(), device="cuda"):
    ilqr = build_solver(cfg, device)
    if cfg.method == "sqp":
        states, inputs, solve_time, optimal_cost = \
            ilqr.SolveDirectTranscription()
    else:
        states, inputs, solve_time, optimal_cost = ilqr.Solve()
    print(f"Solved in {solve_time} seconds using {cfg.method}")
    print(f"Optimal cost: {optimal_cost}")
    return states, inputs, solve_time, optimal_cost


if __name__ == "__main__":
    run()
