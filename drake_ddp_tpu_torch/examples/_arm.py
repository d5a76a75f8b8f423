"""What the Panda and Kinova ball-pushing examples share: the free ball
and the ground, the quadratic weights, the solver set-up with the
gravity-compensation guess, the solve and the passive simulation.

Port of the common part of ``drake_ddp_tpu/examples/panda_fr3.py`` and
``kinova_gen3.py`` (the reference's panda_fr3.py and kinova_gen3.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from drake_ddp_tpu_torch.contact.geometry import (
    HALFSPACE,
    SPHERE,
    CollisionGeometry,
    ContactProps,
    GeometrySet,
)
from drake_ddp_tpu_torch.multibody.algorithms import gravity_compensation
from drake_ddp_tpu_torch.multibody.model import FREE, ModelBuilder
from drake_ddp_tpu_torch.solver.api import IterativeLinearQuadraticRegulator

BALL_RADIUS = 0.1
BALL_MASS = 0.258


def ball_states(q_start, start_x, scenario, lift_dz):
    """x0 and x_nom: the arm at ``q_start`` and at rest, the ball at (0.6,
    0, r) (lift: at x = ``start_x``) and its target 0.2 m forward, 0.15 m
    to the side or ``lift_dz`` up."""
    r = BALL_RADIUS
    q_ball_start = np.array([0, 0, 0, 1, 0.6, 0.0, r], float)
    q_ball_target = np.array([0, 0, 0, 1, 0.6, 0.0, r], float)
    if scenario == "lift":
        q_ball_start[4] = start_x
        q_ball_target[6] += lift_dz
    elif scenario == "forward":
        q_ball_target[4] += 0.2
    elif scenario == "side":
        q_ball_target[5] += 0.15
    else:
        raise RuntimeError(f"Unknown scenario {scenario}")
    x0 = np.hstack([q_start, q_ball_start, np.zeros(13)])
    x_nom = np.hstack([q_start, q_ball_target, np.zeros(13)])
    return x0, x_nom


def arm_costs(scenario):
    """Quadratic weights (Q, R, Qf): the ball's position (not its height
    and x in the lift scenario), every velocity lightly, the torques."""
    Qq_robot = 0.0 * np.ones(7)
    Qv_robot = 0.1 * np.ones(7)
    Qq_ball = 1.0 * np.array([0, 0, 0, 0, 100, 100, 100], float)
    if scenario == "lift":
        Qq_ball[4] = 0
        Qq_ball[5] = 0
    Qv_ball = 0.1 * np.ones(6)
    Q = np.diag(np.hstack([Qq_robot, Qq_ball, Qv_robot, Qv_ball]))
    R = 0.01 * np.eye(7)
    Qf = np.diag(np.hstack([Qq_robot, Qq_ball, Qv_robot, 10 * Qv_ball]))
    return Q, R, Qf


def add_ball_and_ground(mb: ModelBuilder, gs: GeometrySet, cfg):
    """A free 0.1 m hollow ball and a compliant ground halfspace (0.7 of
    the ball's friction)."""
    friction = dict(mu_static=cfg.mu_static, mu_dynamic=cfg.mu_dynamic)
    ball_props = ContactProps(
        modulus=cfg.hydroelastic_modulus, dissipation=cfg.dissipation,
        resolution_hint=cfg.resolution_hint, **friction)
    ground_props = ContactProps(
        modulus=cfg.hydroelastic_modulus, dissipation=cfg.dissipation,
        resolution_hint=cfg.resolution_hint,
        mu_static=0.7 * cfg.mu_static, mu_dynamic=0.7 * cfg.mu_dynamic)
    I_ball = (2.0 / 3.0) * BALL_MASS * BALL_RADIUS ** 2 * np.eye(3)
    ball = mb.add_body("ball", -1, FREE, mass=BALL_MASS, inertia=I_ball)
    gs.add(CollisionGeometry(ball, SPHERE, np.zeros(3), np.eye(3),
                             np.array([BALL_RADIUS]), ball_props, "ball"))
    gs.add(CollisionGeometry(-1, HALFSPACE, np.zeros(3), np.eye(3),
                             np.zeros(1), ground_props, "ground"))


def arm_solver(system, model, cfg, x0, x_nom, costs, delta, device,
               deriv_kernel=None, timer=None, interp=None):
    """The single-trajectory solver with the task's weights and the
    gravity-compensation guess (the arm held still at x0)."""
    num_steps = int(cfg.T / cfg.dt)
    ilqr = IterativeLinearQuadraticRegulator(
        system, num_steps, beta=cfg.beta, delta=delta, gamma=cfg.gamma,
        derivs_keypoint_method=interp, verbose=cfg.verbose,
        raise_on_divergence=False, device=device, deriv_kernel=deriv_kernel,
        timer=timer)
    Q, R, Qf = costs
    ilqr.SetInitialState(x0)
    ilqr.SetTargetState(x_nom)
    ilqr.SetRunningCost(cfg.dt * Q, cfg.dt * R)
    ilqr.SetTerminalCost(Qf)
    q0 = torch.as_tensor(x0[:model.nq], dtype=torch.float32,
                         device=model.device)
    u_gc = gravity_compensation(model, q0).cpu().numpy()
    ilqr.SetInitialGuess(np.repeat(u_gc[None].T, num_steps - 1, axis=1))
    return ilqr


def solve(ilqr, save_file: Optional[str] = None, on_solve=None):
    """One solve; ``on_solve`` gets its ILQRSolution (numpy)."""
    x, u, solve_time, cost = ilqr.Solve()
    if on_solve is not None:
        on_solve(ilqr._solution)
    print(f"Solved in {solve_time} seconds using iLQR")
    print(f"Optimal cost: {cost}")
    if save_file:
        ilqr.SaveSolution(save_file)
    return x, u, solve_time, cost


def passive(system, x0, steps: int, device):
    """States (n, steps) of the plant from x0 with zero torques, one
    megastep launch a step on the card (the plain lane step on the
    CPU)."""
    from drake_ddp_tpu_torch.ops.megastep import megastep_for_system
    step = megastep_for_system(system)
    x = torch.as_tensor(x0, dtype=torch.float32, device=device)[:, None]
    u = torch.zeros((system.m, 1), dtype=torch.float32, device=device)
    xs = []
    for _ in range(steps):
        x = step(x.contiguous(), u)
        xs.append(x[:, 0])
    return torch.stack(xs, dim=1).cpu().numpy()
