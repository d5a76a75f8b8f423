"""Franka FR3 whole-arm ball manipulation (contact-implicit).

Port of ``drake_ddp_tpu/examples/panda_fr3.py``: a 7-dof Franka FR3 arm
(fixed hand, reflected rotor inertias) pushes a 0.1 m ball on the
ground.  n = 27 (7 arm q + 7 ball q + 13 v), m = 7; T = 0.5, dt = 1e-2
(N = 50); scenarios "lift", "forward" and "side"; beta 0.5, delta 1e-3,
gamma 0; a gravity-compensation initial guess.  The arm's mesh
collisions are spheres (35 with the ball); the side scenario has 69
contacts (35 sphere-ground, 34 arm-ball sphere-sphere).

:func:`run` solves through
:class:`~drake_ddp_tpu_torch.solver.api.IterativeLinearQuadraticRegulator`
(megaroll rollouts and cold-Newton megajac derivatives on the card).
:func:`simulate` rolls the plant out passively, optionally into the HTML
player (:mod:`~drake_ddp_tpu_torch.viz`).

    python -m drake_ddp_tpu_torch.examples.panda_fr3     # on the card
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from drake_ddp_tpu_torch.contact.forces import ContactForceParams
from drake_ddp_tpu_torch.contact.geometry import (GeometrySet,
                                                  build_contact_model)
from drake_ddp_tpu_torch.examples import _arm
from drake_ddp_tpu_torch.io.urdf import add_urdf
from drake_ddp_tpu_torch.models import panda_fr3
from drake_ddp_tpu_torch.multibody.model import ModelBuilder
from drake_ddp_tpu_torch.multibody.plant import make_multibody_system

# Joint-angle definitions.
Q_HOME = np.array([0., -0.785, 0., -2.356, 0., 1.57, .785])
Q_PUSH = np.array([0., 0.7, 0., -2.356, 0., 4.4, .785])
Q_WRAP = np.array([-2.0, -1.8, 2., -2.0, 0.0057, 1.1, -0.083])

BALL_RADIUS = _arm.BALL_RADIUS
BALL_MASS = _arm.BALL_MASS


@dataclasses.dataclass(frozen=True)
class Config:
    scenario: str = "side"      # "lift", "forward", or "side"
    T: float = 0.5
    dt: float = 1e-2
    beta: float = 0.5
    delta: float = 1e-3
    gamma: float = 0.0
    # contact
    dissipation: float = 5.0
    hydroelastic_modulus: float = 5e6
    resolution_hint: float = 0.05
    mu_static: float = 0.3
    mu_dynamic: float = 0.2
    contact_iters: int = 8
    smooth_width: float = 1e-2
    verbose: bool = True
    mesh_max_spheres: int = 4


def scenario_states(cfg: Config):
    """x0 and x_nom of the scenario."""
    q_start = Q_WRAP if cfg.scenario == "lift" else Q_PUSH
    return _arm.ball_states(q_start, 0.17, cfg.scenario, 0.15)


def costs(cfg: Config):
    """Quadratic weights (Q, R, Qf)."""
    return _arm.arm_costs(cfg.scenario)


def build_system(cfg: Config = Config(), device="cuda"):
    """Arm (welded base, +1.5 cm) + free ball + ground -> (DiscreteSystem
    (n=27, m=7), model), on ``device``."""
    mb = ModelBuilder()
    gs = GeometrySet()
    add_urdf(mb, gs, panda_fr3(), floating=False, base_pos=(0, 0, 0.015),
             mesh_max_spheres=cfg.mesh_max_spheres)
    _arm.add_ball_and_ground(mb, gs, cfg)
    model = mb.finalize(device=device)
    cm = build_contact_model(gs, device=device)
    system = make_multibody_system(
        model, cm, cfg.dt, contact_iters=cfg.contact_iters,
        force_params=ContactForceParams(smooth_width=cfg.smooth_width))
    return system, model


def build_solver(cfg: Config = Config(), device="cuda",
                 deriv_kernel: Optional[str] = None, timer=None):
    """The single-trajectory solver on ``device``, set up to solve.
    ``deriv_kernel`` and ``timer`` as in
    :class:`~drake_ddp_tpu_torch.solver.api.
    IterativeLinearQuadraticRegulator`."""
    system, model = build_system(cfg, device=device)
    x0, x_nom = scenario_states(cfg)
    return _arm.arm_solver(system, model, cfg, x0, x_nom, costs(cfg),
                           cfg.delta, device, deriv_kernel, timer)


def run(cfg: Config = Config(), save_file: Optional[str] = None,
        device="cuda", deriv_kernel: Optional[str] = None, timer=None,
        on_solve=None):
    """Solve; returns (x (27, N), u (7, N-1), solve seconds, cost).
    ``on_solve`` gets the solve's ILQRSolution (numpy)."""
    return _arm.solve(build_solver(cfg, device, deriv_kernel, timer),
                      save_file, on_solve)


def simulate(cfg: Config = Config(), sim_time: Optional[float] = None,
             device="cuda", html_out: Optional[str] = None):
    """Passive (zero-torque) simulation from the scenario's initial state:
    states (n, T / dt); optionally writes the HTML player to
    ``html_out``."""
    system, _ = build_system(cfg, device=device)
    x0, _ = scenario_states(cfg)
    steps = int((cfg.T if sim_time is None else sim_time) / cfg.dt)
    return _arm.passive(system, x0, steps, device, html_out)


if __name__ == "__main__":
    run()
