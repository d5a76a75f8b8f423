"""The dynamics contract: a pure discrete-time step function.

Port of ``drake_ddp_tpu/dynamics/base.py``.  A system is its
per-scenario step ``step_fn(params, x, u) -> x_next`` and the lane-major
functions the solver drives (trailing lane axis): the lane step and the
lane Jacobians.  A system that gives only ``step_fn`` gets both lane
functions from that step: the lane step is the step itself applied to
``(n, L)`` states (its arithmetic is written over a leading state axis),
and the lane Jacobian is ``torch.func.vmap`` of ``torch.func.jacfwd`` of
the step over the lane axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import jacfwd, vmap

# A step function maps (params, x, u) -> x_next; ``params`` is any
# structure of model data (masses, inertias, contact parameters, ...).
StepFn = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiscreteSystem:
    """A discrete-time system x_{t+1} = f(x_t, u_t).

    Attributes:
        step_fn: per-scenario step (params, x (n,), u (m,)) -> x_next (n,),
            differentiable by ``torch.func.jacfwd``; or None.
        params: model parameters, e.g. (MultibodyModel, ContactModel).
        n, m: state and control dimensions.
        dt: the timestep [s].
        lane_step_fn: (x (n, L), u (m, L)) -> x_next (n, L), plain torch.
            None with a ``step_fn``: the step itself over lanes.
        lane_jac_fn: (x (n, L), u (m, L)) -> (fx (n, n, L), fu (n, m, L)),
            the cold-Newton lane Jacobian: it runs the step's own contact
            Newton and linearizes at that root.  None with a ``step_fn``
            and no ``lane_step_fn``: ``vmap(jacfwd(step))`` over lanes.
        lane_jac_root_fn: (x (n, L), u (m, L), x_next (n, L)) ->
            (fx (n, n, L), fu (n, m, L)), the root-seeded lane Jacobian
            linearized at the step's own next state x_next.
    """

    step_fn: Optional[StepFn]
    params: Any
    n: int
    m: int
    dt: float
    lane_step_fn: Optional[Callable] = None
    lane_jac_fn: Optional[Callable] = None
    lane_jac_root_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.step_fn is None or self.lane_step_fn is not None:
            return
        step = self.bound_step()
        object.__setattr__(self, "lane_step_fn", step)
        if self.lane_jac_fn is None:
            object.__setattr__(self, "lane_jac_fn", vmap(
                jacfwd(step, argnums=(0, 1)), in_dims=-1, out_dims=-1))

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """x_next = f(x, u)."""
        return self.step_fn(self.params, x, u)

    def bound_step(self) -> Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor]:
        """``f(x, u)`` with the params bound (for jacfwd and rollouts)."""
        params, step_fn = self.params, self.step_fn
        return lambda x, u: step_fn(params, x, u)

    def linearize(self, x: torch.Tensor, u: torch.Tensor):
        """The Jacobians ``fx = df/dx`` (n, n) and ``fu = df/du`` (n, m)
        at one point, by forward-mode autodiff through the step."""
        return jacfwd(self.bound_step(), argnums=(0, 1))(x, u)

    def rollout(self, x0: torch.Tensor, u_traj: torch.Tensor) -> torch.Tensor:
        """Roll out an open-loop control tape: u_traj (N-1, m) -> (N, n)."""
        f = self.bound_step()
        xs = [x0]
        for u in u_traj:
            xs.append(f(xs[-1], u))
        return torch.stack(xs)
