"""multibody (PyTorch port; see the package docstring): the model
builder and joint kinds, the rigid-body algorithms, and the contact
plant."""

from drake_ddp_tpu_torch.multibody.model import (
    FIXED,
    FREE,
    PRISMATIC,
    REVOLUTE,
    ModelBuilder,
    MultibodyModel,
)
from drake_ddp_tpu_torch.multibody.algorithms import (
    dynamics_terms,
    forward_kinematics,
    integrate_positions,
    mass_matrix,
)
from drake_ddp_tpu_torch.multibody.plant import (make_multibody_system,
                                                 multibody_step)

__all__ = [
    "FIXED",
    "FREE",
    "PRISMATIC",
    "REVOLUTE",
    "ModelBuilder",
    "MultibodyModel",
    "dynamics_terms",
    "forward_kinematics",
    "integrate_positions",
    "mass_matrix",
    "make_multibody_system",
    "multibody_step",
]
