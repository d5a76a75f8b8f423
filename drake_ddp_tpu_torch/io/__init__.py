"""io (PyTorch port; see the package docstring): model records, solution
and MPC checkpoint files."""

from drake_ddp_tpu_torch.io.checkpoint import (
    load_mpc_checkpoint,
    save_mpc_checkpoint,
)
from drake_ddp_tpu_torch.io.solution import (
    load_solution,
    policy,
    save_solution,
)

__all__ = [
    "load_mpc_checkpoint",
    "load_solution",
    "policy",
    "save_mpc_checkpoint",
    "save_solution",
]
