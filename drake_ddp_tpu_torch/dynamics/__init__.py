"""dynamics (PyTorch port; see the package docstring)."""

from drake_ddp_tpu_torch.dynamics.analytic import (
    acrobot_system,
    cart_pole_system,
    pendulum_system,
)
from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem

__all__ = [
    "DiscreteSystem",
    "pendulum_system",
    "cart_pole_system",
    "acrobot_system",
]
