"""utils (PyTorch port; see the package docstring)."""

from drake_ddp_tpu_torch.utils.linalg import inv_spd, solve_small, solve_spd

__all__ = ["solve_spd", "inv_spd", "solve_small"]
