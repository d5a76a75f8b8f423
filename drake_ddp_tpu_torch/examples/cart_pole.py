"""Cart-pole swing-up.

Port of ``drake_ddp_tpu/examples/cart_pole.py``: T = 2.0, dt = 0.01,
x0 = 0, x_nom = [0, pi, 0, 0], Q = diag([10, 10, 0.1, 0.1]), R = 0.001 I,
Qf = diag([100, 100, 10, 10]), beta = 0.9.  Derivative interpolation
(``use_derivative_interpolation``): setInterval, adaptiveJerk or
iterativeError, with the JAX example's thresholds.

    python -m drake_ddp_tpu_torch.examples.cart_pole         # on the card
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
from drake_ddp_tpu_torch.solver.api import IterativeLinearQuadraticRegulator
from drake_ddp_tpu_torch.solver.keypoints import from_config


@dataclasses.dataclass(frozen=True)
class Config:
    T: float = 2.0
    dt: float = 1e-2
    beta: float = 0.9
    # "ilqr" or "sqp" (the direct-transcription baseline,
    # solver/transcription.py)
    method: str = "ilqr"
    # derivative interpolation
    use_derivative_interpolation: bool = False
    keypoint_method: str = "adaptiveJerk"
    minN: int = 5
    maxN: int = 10
    jerk_threshold: float = 0.0001
    # keypoint budget: caps the iterativeError bisection per level and
    # bounds adaptiveJerk's keypoint count; None = uncapped
    max_keypoints: Optional[int] = None
    iterative_error_threshold: float = 5e-05
    verbose: bool = True


def build_system(cfg: Config):
    return cart_pole_system(dt=cfg.dt)


def build_solver(cfg: Config, device="cuda"):
    system = build_system(cfg)
    num_steps = int(cfg.T / cfg.dt)
    interp = from_config(cfg)
    ilqr = IterativeLinearQuadraticRegulator(
        system, num_steps, beta=cfg.beta,
        derivs_keypoint_method=interp, verbose=cfg.verbose, device=device,
    )
    ilqr.SetInitialState(np.zeros(4))
    ilqr.SetTargetState(np.array([0.0, np.pi, 0.0, 0.0]))
    ilqr.SetRunningCost(cfg.dt * np.diag([10.0, 10.0, 0.1, 0.1]),
                        cfg.dt * 0.001 * np.eye(1))
    ilqr.SetTerminalCost(np.diag([100.0, 100.0, 10.0, 10.0]))
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
