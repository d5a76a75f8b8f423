"""mpc (PyTorch port; see the package docstring)."""

from drake_ddp_tpu_torch.mpc.driver import (
    MPCConfig,
    MPCResult,
    mpc_solve,
    mpc_solve_batched,
    shift_warm_start,
    shift_warm_start_batched,
)

__all__ = ["MPCConfig", "MPCResult", "mpc_solve", "mpc_solve_batched",
           "shift_warm_start", "shift_warm_start_batched"]
