"""io (PyTorch port; see the package docstring): URDF/SDF model loading,
OBJ meshes, solution and MPC checkpoint files."""

from drake_ddp_tpu_torch.io.checkpoint import (
    load_mpc_checkpoint,
    save_mpc_checkpoint,
)
from drake_ddp_tpu_torch.io.mesh import approximate_spheres, load_obj_vertices
from drake_ddp_tpu_torch.io.solution import (
    load_solution,
    policy,
    save_solution,
)
from drake_ddp_tpu_torch.io.urdf import UrdfRobot, add_urdf, parse_urdf

__all__ = [
    "UrdfRobot",
    "add_urdf",
    "approximate_spheres",
    "load_mpc_checkpoint",
    "load_obj_vertices",
    "load_solution",
    "parse_urdf",
    "policy",
    "save_mpc_checkpoint",
    "save_solution",
]
