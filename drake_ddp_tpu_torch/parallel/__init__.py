"""Scenario data parallelism over cards and processes.

Port of ``drake_ddp_tpu/parallel``: a batch of independent iLQR / MPC
scenarios is split over a mesh of devices (:mod:`.sharding`), and over
processes (:mod:`.multihost`); only three summary sums cross devices.
"""

from drake_ddp_tpu_torch.parallel import multihost
from drake_ddp_tpu_torch.parallel.sharding import (
    BatchStats,
    batched_mpc,
    batched_solve,
    scenario_mesh,
    shard_problems,
)

__all__ = [
    "BatchStats",
    "batched_mpc",
    "batched_solve",
    "multihost",
    "scenario_mesh",
    "shard_problems",
]
