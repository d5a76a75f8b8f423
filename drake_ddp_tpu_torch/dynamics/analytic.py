"""Hand-derived analytic models of the classic benchmark tasks.

Port of ``drake_ddp_tpu/dynamics/analytic.py``: closed-form Lagrangian
dynamics with the physical parameters of Drake's example models,
integrated with the semi-implicit Euler scheme of Drake's discrete plant
(velocities from forces at (q_t, v_t), positions with the new
velocities):

    v' = v + dt * M(q)^{-1} (B u + tau_g(q) - C(q,v) v - D v)
    q' = q + dt * v'

Each step reads the rows of ``x`` as one-row slices (``_row(x, 0)`` is
``x[0:1]``) and makes every array from the input, so one function takes
a scenario ``x (n,), u (m,)`` and a lane batch ``x (n, L), u (m, L)`` on
any device: the system's lane step is the step itself
(:class:`~drake_ddp_tpu_torch.dynamics.base.DiscreteSystem`).  Slices,
not ``x[0]``: under ``torch.func.jvp`` a 0-dim tensor times a Python
float comes out float64.  The 2 x 2 solves are the closed form that the
JAX package's ``solve_spd`` uses at that size.
"""

from __future__ import annotations

import dataclasses

import torch

from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem


def _semi_implicit_euler(q, v, vdot, dt):
    v_next = v + dt * vdot
    q_next = q + dt * v_next
    return torch.cat([q_next, v_next])


def _row(a, i):
    """Row i of a as a one-row slice: (1,) or (1, L)."""
    return a[i:i + 1]


def _solve_2x2(a, c, d, b0, b1):
    """[[a, c], [c, d]]^{-1} [b0, b1] for one-row entries -> (2, ...)."""
    det = a * d - c * c
    return torch.cat([(d * b0 - c * b1) / det, (a * b1 - c * b0) / det])


# ---------------------------------------------------------------------------
# Pendulum: drake/examples/pendulum (mass 1.0 kg, length 0.5 m, viscous
# damping 0.1, g = 9.81).  x = [theta, theta_dot], theta = 0 hanging down.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PendulumParams:
    mass: float = 1.0
    length: float = 0.5
    damping: float = 0.1
    gravity: float = 9.81


def pendulum_system(dt: float,
                    params: PendulumParams | None = None) -> DiscreteSystem:
    p = params or PendulumParams()

    def step(params: PendulumParams, x, u):
        theta, theta_dot = _row(x, 0), _row(x, 1)
        m, l, b, g = params.mass, params.length, params.damping, params.gravity
        theta_dd = (_row(u, 0) - b * theta_dot
                    - m * g * l * torch.sin(theta)) / (m * l * l)
        return _semi_implicit_euler(theta, theta_dot, theta_dd, dt)

    return DiscreteSystem(step_fn=step, params=p, n=2, m=1, dt=dt)


# ---------------------------------------------------------------------------
# Cart-pole: drake/examples/multibody/cart_pole/cart_pole.sdf (cart 10 kg,
# point-mass pole 1 kg at 0.5 m).  x = [cart_pos, pole_angle, cart_vel,
# pole_vel]; angle 0 = hanging down, pi = upright.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CartPoleParams:
    cart_mass: float = 10.0
    pole_mass: float = 1.0
    pole_length: float = 0.5
    gravity: float = 9.81


def cart_pole_system(dt: float,
                     params: CartPoleParams | None = None) -> DiscreteSystem:
    p = params or CartPoleParams()

    def step(params: CartPoleParams, x, u):
        mc, mp, l, g = (params.cart_mass, params.pole_mass,
                        params.pole_length, params.gravity)
        q, v = x[:2], x[2:]
        s, c = torch.sin(_row(q, 1)), torch.cos(_row(q, 1))
        v1 = _row(v, 1)
        bias0 = -mp * l * v1 * v1 * s           # centrifugal on cart
        bias1 = mp * g * l * s                  # gravity torque on pole
        vdot = _solve_2x2(mc + mp, mp * l * c, mp * l * l,
                          _row(u, 0) - bias0, -bias1)
        return _semi_implicit_euler(q, v, vdot, dt)

    return DiscreteSystem(step_fn=step, params=p, n=4, m=1, dt=dt)


# ---------------------------------------------------------------------------
# Acrobot: drake/examples/acrobot/Acrobot.urdf (the Spong model: m1=m2=1,
# l1=1, l2=2, lc1=0.5, lc2=1, Ic1=0.083, Ic2=0.33, b1=b2=0.1).  Only the
# elbow is actuated.  x = [q1, q2, v1, v2], q measured from hanging down.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AcrobotParams:
    m1: float = 1.0
    m2: float = 1.0
    l1: float = 1.0
    l2: float = 2.0
    lc1: float = 0.5
    lc2: float = 1.0
    Ic1: float = 0.083
    Ic2: float = 0.33
    b1: float = 0.1
    b2: float = 0.1
    gravity: float = 9.81


def acrobot_system(dt: float,
                   params: AcrobotParams | None = None) -> DiscreteSystem:
    p = params or AcrobotParams()

    def step(params: AcrobotParams, x, u):
        q, v = x[:2], x[2:]
        q1, q2 = _row(q, 0), _row(q, 1)
        v1, v2 = _row(v, 0), _row(v, 1)
        m1, m2 = params.m1, params.m2
        l1 = params.l1
        lc1, lc2 = params.lc1, params.lc2
        g = params.gravity
        I1 = params.Ic1 + m1 * lc1 * lc1
        I2 = params.Ic2 + m2 * lc2 * lc2
        s1, s2 = torch.sin(q1), torch.sin(q2)
        c2 = torch.cos(q2)
        s12 = torch.sin(q1 + q2)

        m2l1lc2 = m2 * l1 * lc2
        M00 = I1 + I2 + m2 * l1 * l1 + 2 * m2l1lc2 * c2
        M01 = I2 + m2l1lc2 * c2
        # Coriolis matrix times v, plus joint damping
        C_v0 = (-2 * m2l1lc2 * s2 * v2 * v1 - m2l1lc2 * s2 * v2 * v2
                + params.b1 * v1)
        C_v1 = m2l1lc2 * s2 * v1 * v1 + params.b2 * v2
        tau_g0 = -(m1 * g * lc1 * s1 + m2 * g * (l1 * s1 + lc2 * s12))
        tau_g1 = -m2 * g * lc2 * s12
        vdot = _solve_2x2(M00, M01, I2, tau_g0 - C_v0,
                          _row(u, 0) + tau_g1 - C_v1)
        return _semi_implicit_euler(q, v, vdot, dt)

    return DiscreteSystem(step_fn=step, params=p, n=4, m=1, dt=dt)
