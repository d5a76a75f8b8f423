"""The dynamics contract of the batched solver.

Port of ``drake_ddp_tpu/dynamics/base.py``.  The batched solver drives a
system through its lane-major functions (trailing batch axis); the
per-scenario step ``step_fn`` is not ported yet, so it may be None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class DiscreteSystem:
    """A discrete-time system x_{t+1} = f(x_t, u_t).

    Attributes:
        step_fn: per-scenario step (params, x, u) -> x_next, or None.
        params: model parameters, e.g. (MultibodyModel, ContactModel).
        n, m: state and control dimensions.
        dt: the timestep [s].
        lane_step_fn: (x (n, L), u (m, L)) -> x_next (n, L), plain torch.
        lane_jac_fn: (x (n, L), u (m, L)) -> (fx (n, n, L), fu (n, m, L)),
            the cold-Newton lane Jacobian: it runs the step's own contact
            Newton and linearizes at that root.
        lane_jac_root_fn: (x (n, L), u (m, L), x_next (n, L)) ->
            (fx (n, n, L), fu (n, m, L)), the root-seeded lane Jacobian
            linearized at the step's own next state x_next.
    """

    step_fn: Optional[Callable]
    params: Any
    n: int
    m: int
    dt: float
    lane_step_fn: Optional[Callable] = None
    lane_jac_fn: Optional[Callable] = None
    lane_jac_root_fn: Optional[Callable] = None
