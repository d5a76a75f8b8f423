"""contact (PyTorch port; see the package docstring): the scene
description, its contact tables, and the smooth force law."""

from drake_ddp_tpu_torch.contact.forces import (
    ContactForceParams,
    contact_forces,
    contact_forces_implicit,
)
from drake_ddp_tpu_torch.contact.geometry import (
    CollisionGeometry,
    ContactProps,
    GeometrySet,
    build_contact_model,
    narrowphase,
)

__all__ = [
    "CollisionGeometry",
    "ContactProps",
    "GeometrySet",
    "build_contact_model",
    "contact_forces",
    "ContactForceParams",
    "contact_forces_implicit",
    "narrowphase",
]
