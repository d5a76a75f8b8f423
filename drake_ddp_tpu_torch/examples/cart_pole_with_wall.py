"""Cart-pole with a wall: contact through iLQR, solved by multi-start.

Port of ``drake_ddp_tpu/examples/cart_pole_with_wall.py``: a compliant
ball on the pole tip and a rigid wall at x = -0.5; T = 1.0, dt = 1e-2,
x0 = [0, pi + 0.5, 0, 0], x_nom = [0, pi, 0, 0],
Q = diag([0.1, 1, 0.01, 0.01]), R = 0.001, Qf = diag([200, 200, 10, 10]),
beta = 0.5, dissipation 0, modulus 2e6.  The optimizer finds the
contact sequence (a bounce off the wall) on its own.

The plant is the multibody engine's: a prismatic cart, a revolute pole,
a sphere at the pole tip and a world-fixed box as the wall, so on the
card every start's linesearch chunk runs on megaroll and its
Jacobians on the cold megajac.  The pole angle's sign makes the tip lean
toward the wall at theta = pi + 0.5 (tip x = +0.5 sin theta).  The
contact task is multi-modal (local optima span costs 25..1100), so
:func:`solve_multistart` solves ``num_starts`` perturbed tapes in one
batched solve and keeps the best.

Derivative interpolation (``use_derivative_interpolation``):
setInterval, adaptiveJerk or iterativeError, with the JAX example's
thresholds.

    python -m drake_ddp_tpu_torch.examples.cart_pole_with_wall   # card
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from drake_ddp_tpu_torch._device import resolve_device
from drake_ddp_tpu_torch.contact.geometry import (
    BOX,
    SPHERE,
    CollisionGeometry,
    ContactProps,
    GeometrySet,
    build_contact_model,
)
from drake_ddp_tpu_torch.multibody.model import (PRISMATIC, REVOLUTE,
                                                 ModelBuilder)
from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
from drake_ddp_tpu_torch.solver.api import IterativeLinearQuadraticRegulator
from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig, ILQRProblem
from drake_ddp_tpu_torch.solver.keypoints import from_config
from drake_ddp_tpu_torch.solver.multistart import multistart_ilqr


@dataclasses.dataclass(frozen=True)
class Config:
    T: float = 1.0
    dt: float = 1e-2
    beta: float = 0.5
    # contact model parameters
    dissipation: float = 0.0
    hydroelastic_modulus: float = 2e6
    resolution_hint: float = 0.05
    ball_radius: float = 0.05
    # wall: box(0.1, 1, 2) at x = -0.5
    wall_x: float = -0.5
    # derivative interpolation
    use_derivative_interpolation: bool = False
    keypoint_method: str = "setInterval"
    minN: int = 1
    maxN: int = 100
    jerk_threshold: float = 0.0007
    # keypoint budget: caps the iterativeError bisection per level and
    # bounds adaptiveJerk's keypoint count; None = uncapped
    max_keypoints: Optional[int] = None
    iterative_error_threshold: float = 5e-5
    contact_iters: int = 2
    # one batched multi-start solve finds the wall-bounce basin
    num_starts: int = 8
    guess_scale: float = 10.0
    seed: int = 0
    # the multi-start solve's iteration bound
    max_iters: int = 60
    verbose: bool = True


X0 = np.array([0.0, np.pi + 0.5, 0.0, 0.0])
X_NOM = np.array([0.0, np.pi, 0.0, 0.0])


def build_system(cfg: Config = Config(), device="cuda"):
    """Cart, pole, tip ball and wall -> DiscreteSystem (n 4, m 1) on
    ``device``."""
    # Drake cart_pole.sdf parameters: cart 10 kg, pole point mass 1 kg at
    # 0.5 m; +Y rotation axis, theta = 0 hanging down
    mb = ModelBuilder()
    cart = mb.add_body("cart", -1, PRISMATIC, axis=(1, 0, 0),
                       mass=10.0, actuated=True)
    pole = mb.add_body("pole", cart, REVOLUTE, axis=(0, -1, 0),
                       mass=1.0, com=(0, 0, -0.5))
    model = mb.finalize(device=device)
    props = ContactProps(
        modulus=cfg.hydroelastic_modulus, dissipation=cfg.dissipation,
        mu_static=1.0, mu_dynamic=1.0, resolution_hint=cfg.resolution_hint)
    gs = GeometrySet()
    # compliant ball at the pole tip (the pole frame sits at the point mass)
    gs.add(CollisionGeometry(pole, SPHERE, np.array([0.0, 0.0, -0.5]),
                             np.eye(3), np.array([cfg.ball_radius]), props))
    # rigid wall: box l, w, h = 0.1, 1, 2 at x = wall_x
    wall_props = ContactProps(modulus=np.inf, dissipation=cfg.dissipation,
                              mu_static=1.0, mu_dynamic=1.0)
    gs.add(CollisionGeometry(-1, BOX, np.array([cfg.wall_x, 0.0, 0.0]),
                             np.eye(3), np.array([0.05, 0.5, 1.0]),
                             wall_props))
    cm = build_contact_model(gs, device=device)
    return make_multibody_system(model, cm, cfg.dt,
                                 contact_iters=cfg.contact_iters)


def costs(cfg: Config = Config()):
    """Quadratic weights (Q, R, Qf) as numpy arrays."""
    return (cfg.dt * np.diag([0.1, 1.0, 0.01, 0.01]),
            cfg.dt * 0.001 * np.eye(1),
            np.diag([200.0, 200.0, 10.0, 10.0]))


def build_solver(cfg: Config = Config(), device="cuda", timer=None):
    """The single-start solver on ``device``, set up to solve."""
    interp = from_config(cfg)
    system = build_system(cfg, device=device)
    num_steps = int(cfg.T / cfg.dt)
    ilqr = IterativeLinearQuadraticRegulator(
        system, num_steps, beta=cfg.beta, derivs_keypoint_method=interp,
        verbose=cfg.verbose, device=device, timer=timer)
    Q, R, Qf = costs(cfg)
    ilqr.SetInitialState(X0)
    ilqr.SetTargetState(X_NOM)
    ilqr.SetRunningCost(Q, R)
    ilqr.SetTerminalCost(Qf)
    ilqr.SetInitialGuess(np.zeros((1, num_steps - 1)))
    return ilqr


def problem(cfg: Config = Config(), device="cuda"):
    """The multi-start solve's (ILQRConfig, ILQRProblem), float32 on
    ``device``, the zero tape as u_init."""
    dev = resolve_device(device)
    N = int(cfg.T / cfg.dt)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=dev)
    Q, R, Qf = costs(cfg)
    prob = ILQRProblem(x0=t(X0), x_nom=t(X_NOM), Q=t(Q), R=t(R), Qf=t(Qf),
                       u_init=t(np.zeros((N - 1, 1))))
    interp = from_config(cfg)
    scfg = ILQRConfig(num_steps=N, beta=cfg.beta, max_iters=cfg.max_iters,
                      **({} if interp is None else dict(derivs=interp)))
    return scfg, prob


def solve_multistart(cfg: Config = Config(), device="cuda", timer=None):
    """The batched multi-start solve: ``num_starts`` tapes, start 0 the
    zero tape, the rest N(0, guess_scale^2) draws of a ``torch.Generator``
    seeded with ``cfg.seed`` on ``device``.  Returns (MultistartResult,
    system)."""
    dev = resolve_device(device)
    scfg, prob = problem(cfg, dev)
    system = build_system(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    res = multistart_ilqr(system, scfg, prob, cfg.num_starts, gen,
                          cfg.guess_scale, timer=timer)
    return res, system


def run(cfg: Config = Config(), device="cuda", timer=None,
        on_result=None):
    """The multi-start solve; returns the best start's (states (4, N),
    inputs (1, N-1), solve_time, cost).  ``on_result``: optional callable
    that gets the MultistartResult."""
    st = time.time()
    res, _ = solve_multistart(cfg, device, timer)
    optimal_cost = float(res.best.cost)
    solve_time = time.time() - st
    states = res.best.x.cpu().numpy().T
    inputs = res.best.u.cpu().numpy().T
    if on_result is not None:
        on_result(res)
    if cfg.verbose:
        print(f"multi-start costs: "
              f"{np.round(res.costs.cpu().numpy(), 2)}")
    print(f"Solved in {solve_time} seconds using iLQR")
    print(f"Optimal cost: {optimal_cost}")
    return states, inputs, solve_time, optimal_cost


if __name__ == "__main__":
    run()
