"""Mini Cheetah quadruped: the flagship batched MPC task.

Port of the task definition in ``drake_ddp_tpu/examples/mini_cheetah.py``:
floating-base quadruped (n = 37: quaternion base 7 q + 12 joints, 18 v;
m = 12), T = 0.2 s at dt = 4e-3 (N = 50), standing pose + feed-forward
standing torques as the initial guess, a target moving at target_vel,
compliant ground (modulus 5e6, mu 0.6/0.5) as an analytic halfspace.
The single-solve ``run`` loop and its viewer are not ported yet; the
batched MPC entry point is :func:`drake_ddp_tpu_torch.mpc.driver.
mpc_solve_batched`.
"""

from __future__ import annotations

import dataclasses

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
    replan_steps: int = 4
    # solver
    beta: float = 0.5
    delta: float = 1e-2
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
