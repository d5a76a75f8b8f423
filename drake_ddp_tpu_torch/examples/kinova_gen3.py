"""Kinova Gen3 whole-arm ball manipulation (contact-implicit).

Port of ``drake_ddp_tpu/examples/kinova_gen3.py``: a 7-dof Kinova Gen3
arm with a welded static Robotiq 2F-85 gripper pushes or lifts a 0.1 m
ball on the ground.  n = 27, m = 7; T = 0.5, dt = 1e-2 (N = 50);
scenarios "lift", "forward" and "side"; beta 0.5, gamma 0, delta 1e-3
(1e-5 for lift); a gravity-compensation initial guess.  The arm and
gripper meshes are spheres (55 with the ball), the finger pads boxes;
the side scenario has 127 contacts (55 sphere-ground, 54 sphere-sphere,
2 pad-ball sphere-box, 2 x 8 pad-ground corners), 141 with
``pad_face_quadrature`` (the pads against the ball as 2 x 8 box-face
corners instead).

:func:`run` solves through
:class:`~drake_ddp_tpu_torch.solver.api.IterativeLinearQuadraticRegulator`
(megaroll rollouts and cold-Newton megajac derivatives on the card).
:func:`simulate` rolls the plant out passively and :func:`playback`
replays a saved solution, each optionally into the HTML player
(:mod:`~drake_ddp_tpu_torch.viz`).
Derivative interpolation (``use_derivative_interpolation``):
setInterval, adaptiveJerk or iterativeError, with the JAX example's
thresholds.

    python -m drake_ddp_tpu_torch.examples.kinova_gen3     # on the card
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
from drake_ddp_tpu_torch.models import gripper_static, kinova_gen3
from drake_ddp_tpu_torch.multibody.model import ModelBuilder
from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
from drake_ddp_tpu_torch.solver.keypoints import from_config
from drake_ddp_tpu_torch.utils.spatial import rpy_to_rot

# Joint-angle definitions.
Q_HOME = np.pi / 180 * np.array([0, 15, 180, 230, 0, 55, 90])
Q_RETRACT = np.array([0, 5.93 - 2 * np.pi, np.pi, 3.734 - 2 * np.pi,
                      0, 5.408 - 2 * np.pi, np.pi / 2])
Q_PUSH = np.array([0.0, np.pi / 4 + 0.13, np.pi, 4.4 - 2 * np.pi,
                   0, 1.2, np.pi / 2])
Q_WRAP = np.pi / 180 * np.array([55, 125, 114, 244, 217, 45, 8])

BALL_RADIUS = _arm.BALL_RADIUS
BALL_MASS = _arm.BALL_MASS


@dataclasses.dataclass(frozen=True)
class Config:
    scenario: str = "side"        # "lift", "forward", or "side"
    T: float = 0.5
    dt: float = 1e-2
    beta: float = 0.5
    # convergence threshold; None: 1e-3, and 1e-5 for lift
    delta: Optional[float] = None
    gamma: float = 0.0
    # contact
    dissipation: float = 5.0
    hydroelastic_modulus: float = 5e6
    resolution_hint: float = 0.05
    mu_static: float = 0.3
    mu_dynamic: float = 0.2
    contact_iters: int = 8
    smooth_width: float = 1e-2
    # derivative interpolation (off: dense derivatives)
    use_derivative_interpolation: bool = False
    keypoint_method: str = "adaptiveJerk"
    minN: int = 5
    maxN: int = 40
    jerk_threshold: float = 1e-4
    max_keypoints: Optional[int] = None
    iterative_error_threshold: float = 1e-2
    verbose: bool = True
    mesh_max_spheres: int = 4
    # the finger pads against the ball as 8-corner box-face quadrature
    # (bs pairs) instead of one closest-point contact (sb pairs)
    pad_face_quadrature: bool = False


def scenario_states(cfg: Config):
    """x0 and x_nom of the scenario."""
    q_start = Q_WRAP if cfg.scenario == "lift" else Q_PUSH
    return _arm.ball_states(q_start, 0.155, cfg.scenario, 0.2)


def costs(cfg: Config):
    """Quadratic weights (Q, R, Qf)."""
    return _arm.arm_costs(cfg.scenario)


def build_system(cfg: Config = Config(), device="cuda"):
    """Arm (welded base, +1.5 cm) + static gripper (welded at the end
    effector, yaw pi/2; no gripper-arm collisions) + free ball + ground ->
    (DiscreteSystem (n=27, m=7), model), on ``device``."""
    mb = ModelBuilder()
    gs = GeometrySet()
    arm_idx = add_urdf(mb, gs, kinova_gen3(), floating=False,
                       base_pos=(0, 0, 0.015),
                       mesh_max_spheres=cfg.mesh_max_spheres)
    grip_idx = add_urdf(
        mb, gs, gripper_static(),
        base_parent=arm_idx["end_effector_link"],
        base_rot=rpy_to_rot((0.0, 0.0, np.pi / 2)),
        floating=False, mesh_max_spheres=cfg.mesh_max_spheres)
    for gb in grip_idx.values():
        for ab in arm_idx.values():
            gs.exclude_body_pair(gb, ab)
    _arm.add_ball_and_ground(mb, gs, cfg)
    model = mb.finalize(device=device)
    cm = build_contact_model(gs, box_face_quadrature=cfg.pad_face_quadrature,
                             device=device)
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
    interp = from_config(cfg)
    delta = cfg.delta if cfg.delta is not None else (
        1e-5 if cfg.scenario == "lift" else 1e-3)
    x0, x_nom = scenario_states(cfg)
    return _arm.arm_solver(system, model, cfg, x0, x_nom, costs(cfg), delta,
                           device, deriv_kernel, timer, interp)


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


def playback(save_file: str, cfg: Config = Config(),
             html_out: Optional[str] = None, device="cuda"):
    """Replay a saved solution (:meth:`~drake_ddp_tpu_torch.solver.api.
    IterativeLinearQuadraticRegulator.SaveSolution`) without
    re-optimizing: returns (t, x_bar), and with ``html_out`` writes the
    HTML player at the reference's playback rate of 0.125."""
    from drake_ddp_tpu_torch.io.solution import load_solution

    sol = load_solution(save_file)
    if html_out is not None:
        from drake_ddp_tpu_torch.viz import export_html

        system, model = build_system(cfg, device=device)
        export_html(html_out, model, system.params[1], sol["x_bar"],
                    cfg.dt, playback_rate=0.125, device=device)
    return sol["t"], sol["x_bar"]


if __name__ == "__main__":
    run()
