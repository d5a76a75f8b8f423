"""Mini Cheetah quadruped: contact-implicit gait generation + MPC.

Port of ``drake_ddp_tpu/examples/mini_cheetah.py``: floating-base
quadruped (n = 37: quaternion base 7 q + 12 joints, 18 v; m = 12),
T = 0.2 s at dt = 4e-3 (N = 50), standing pose + feed-forward standing
torques as the initial guess, a target moving at target_vel, compliant
ground (modulus 5e6, mu 0.6/0.5) as an analytic halfspace, beta = 0.5,
delta = 1e-2, receding-horizon resolves every replan_steps = 4 steps.

:func:`run` is the single-trajectory entry point: one solve and
``num_resolves`` warm-started resolves through
:class:`~drake_ddp_tpu_torch.solver.api.IterativeLinearQuadraticRegulator`
(megaroll rollouts and cold-Newton megajac derivatives on the card).
The batched MPC entry point is :func:`drake_ddp_tpu_torch.mpc.driver.
mpc_solve_batched`.  Derivative interpolation (``Config``'s
``use_derivative_interpolation``): setInterval, adaptiveJerk or
iterativeError, with the JAX example's thresholds.

    python -m drake_ddp_tpu_torch.examples.mini_cheetah     # on the card
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from drake_ddp_tpu_torch.contact.forces import ContactForceParams
from drake_ddp_tpu_torch.contact.geometry import (
    HALFSPACE,
    CollisionGeometry,
    ContactProps,
    GeometrySet,
    build_contact_model,
)
from drake_ddp_tpu_torch.io.urdf import add_urdf
from drake_ddp_tpu_torch.models import mini_cheetah as mini_cheetah_robot
from drake_ddp_tpu_torch.multibody.model import ModelBuilder
from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
from drake_ddp_tpu_torch.solver.api import IterativeLinearQuadraticRegulator
from drake_ddp_tpu_torch.solver.keypoints import from_config

# Standing configuration and feed-forward torques.
Q0 = np.asarray(
    [1.0, 0.0, 0.0, 0.0,          # base orientation (w, x, y, z)
     0.0, 0.0, 0.29,              # base position
     0.0, -0.8, 1.6,
     0.0, -0.8, 1.6,
     0.0, -0.8, 1.6,
     0.0, -0.8, 1.6]
)
U_STAND = np.array(
    [0.16370625, 0.42056475, -3.06492254, 0.16861717, 0.14882384,
     -2.43250739, 0.08305763, 0.26016952, -2.74586461, 0.08721941,
     0.02331732, -2.18319231]
)


@dataclasses.dataclass(frozen=True)
class Config:
    T: float = 0.2
    dt: float = 4e-3
    target_vel: float = 1.0
    # MPC
    num_resolves: int = 1
    replan_steps: int = 4
    # solver
    beta: float = 0.5
    delta: float = 1e-2
    gamma: float = 0.0
    # contact
    mu_static: float = 0.6
    mu_dynamic: float = 0.5
    dissipation: float = 0.0
    hydroelastic_modulus: float = 5e6
    resolution_hint: float = 0.1
    # implicit Newton iterations: 2 under-resolve fast foot impacts on
    # the stiff zero-dissipation ground; 100+-resolve chains need 8
    contact_iters: int = 4
    # narrow force smoothing: wider widths let hovering feet pick up
    # phantom forces that pump energy into the gait rollout
    smooth_width: float = 1e-3
    # derivative interpolation
    use_derivative_interpolation: bool = False
    keypoint_method: str = "adaptiveJerk"
    minN: int = 2
    maxN: int = 20
    jerk_threshold: float = 0.3
    # keypoint budget: caps the iterativeError bisection per level and
    # bounds adaptiveJerk's keypoint count; None = uncapped
    max_keypoints: Optional[int] = None
    iterative_error_threshold: float = 10.0
    verbose: bool = True


def build_system(cfg: Config = Config(), device="cuda"):
    """Robot + compliant ground -> (DiscreteSystem (n=37, m=12), model),
    on ``device``."""
    mb = ModelBuilder()
    gs = GeometrySet()
    add_urdf(mb, gs, mini_cheetah_robot(), floating=True)
    ground = ContactProps(
        modulus=cfg.hydroelastic_modulus,
        dissipation=cfg.dissipation,
        mu_static=cfg.mu_static,
        mu_dynamic=cfg.mu_dynamic,
        resolution_hint=cfg.resolution_hint,
    )
    gs.add(CollisionGeometry(-1, HALFSPACE, np.zeros(3), np.eye(3),
                             np.zeros(1), ground, name="ground"))
    model = mb.finalize(device=device)
    cm = build_contact_model(gs, device=device)
    system = make_multibody_system(
        model, cm, cfg.dt, contact_iters=cfg.contact_iters,
        force_params=ContactForceParams(smooth_width=cfg.smooth_width))
    return system, model


def costs(cfg: Config = Config()):
    """Quadratic weights (Q, R, Qf) as numpy arrays."""
    Qq_base = np.ones(7)
    Qq_base[0:4] += 2
    Qv_base = np.ones(6)
    Qq_legs = 0.0 * np.ones(12)
    Qv_legs = 0.01 * np.ones(12)
    Q = np.diag(np.hstack([Qq_base, Qq_legs, 0.01 * Qv_base, Qv_legs]))
    R = 0.01 * np.eye(12)
    Qf = np.diag(np.hstack([5 * Qq_base, 0.1 + Qq_legs, Qv_base, Qv_legs]))
    return Q, R, Qf


def initial_and_target(cfg: Config = Config()):
    """x0 and the moving target x_nom (numpy)."""
    x0 = np.hstack([Q0, np.zeros(18)])
    x_nom = np.hstack([Q0, np.zeros(18)])
    x_nom[4] += cfg.target_vel * cfg.T   # base x position
    x_nom[22] += cfg.target_vel          # base x velocity
    return x0, x_nom


def build_solver(cfg: Config = Config(), device="cuda",
                 deriv_kernel: Optional[str] = None, timer=None):
    """The single-trajectory solver on ``device``, set up for the first
    solve: (ilqr, x0, x_nom).  ``deriv_kernel`` and ``timer`` as in
    :class:`~drake_ddp_tpu_torch.solver.api.
    IterativeLinearQuadraticRegulator`."""
    system, _ = build_system(cfg, device=device)
    num_steps = int(cfg.T / cfg.dt)
    interp = from_config(cfg)
    ilqr = IterativeLinearQuadraticRegulator(
        system, num_steps, beta=cfg.beta, delta=cfg.delta, gamma=cfg.gamma,
        derivs_keypoint_method=interp, verbose=cfg.verbose,
        raise_on_divergence=False, device=device, deriv_kernel=deriv_kernel,
        timer=timer,
    )
    Q, R, Qf = costs(cfg)
    x0, x_nom = initial_and_target(cfg)
    ilqr.SetTargetState(x_nom)
    ilqr.SetRunningCost(cfg.dt * Q, cfg.dt * R)
    ilqr.SetTerminalCost(Qf)
    ilqr.SetInitialState(x0)
    ilqr.SetInitialGuess(np.repeat(U_STAND[None].T, num_steps - 1, axis=1))
    return ilqr, x0, x_nom


def run(cfg: Config = Config(), device="cuda",
        deriv_kernel: Optional[str] = None, timer=None, on_solve=None):
    """Initial solve + ``num_resolves`` MPC resolves; returns the
    stitched state history (37, N + replan_steps * num_resolves), the
    last control tape, the wall seconds and the last cost.

    ``on_solve``: optional callable that gets each solve's
    :class:`~drake_ddp_tpu_torch.solver.ilqr.ILQRSolution` (numpy)."""
    ilqr, x0, x_nom = build_solver(cfg, device, deriv_kernel, timer)
    num_steps = int(cfg.T / cfg.dt)
    rs = cfg.replan_steps
    total_steps = num_steps + rs * cfg.num_resolves
    states = np.zeros((37, total_steps))

    def solve():
        out = ilqr.Solve()
        if on_solve is not None:
            on_solve(ilqr._solution)
        return out

    st = time.time()
    x, u, _, cost = solve()
    states[:, 0:num_steps] = x

    for i in range(cfg.num_resolves):
        if cfg.verbose:
            print(f"\nRunning resolve {i + 1}/{cfg.num_resolves}\n")
        # warm start: shift the tape, repeat the last input
        u_guess = np.block([
            u[:, rs:], np.repeat(u[:, -1:], rs, axis=1)
        ])
        # open-loop handoff + moving target
        x_nom[4] += cfg.target_vel * cfg.dt * rs
        ilqr.SetInitialState(x[:, rs])
        ilqr.SetInitialGuess(u_guess)
        ilqr.SetTargetState(x_nom)
        x, u, _, cost = solve()
        start = (i + 1) * rs
        states[:, start:start + num_steps] = x

    solve_time = time.time() - st
    print(f"Solved in {solve_time} seconds using iLQR")
    return states, u, solve_time, cost


if __name__ == "__main__":
    run()
