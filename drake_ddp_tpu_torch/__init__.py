"""PyTorch/CUDA port of drake_ddp_tpu: contact-implicit iLQR/MPC on an
NVIDIA Hopper card.

The package mirrors the JAX package's layout module for module
(``drake_ddp_tpu_torch/multibody/lanestep.py`` is the counterpart of
``drake_ddp_tpu/multibody/lanestep.py``) and is held to it by the
``tests/test_torch_*.py`` parity tests.  It imports torch and numpy only.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU with ``device="cpu"``; the CUDA kernels under ``csrc/`` are
built at first use into ``build/drake_ddp_tpu_torch/``.  The per-scenario
surface is :class:`IterativeLinearQuadraticRegulator` (and
:func:`solve_ilqr` under it, :func:`mpc_solve`,
:func:`multistart_ilqr` and the direct-transcription baseline
:func:`solve_transcription`); the batched one is
:func:`mpc_solve_batched` and :func:`solve_ilqr_batched`, and over a
mesh of cards and processes :func:`batched_mpc` and :func:`batched_solve`
(:mod:`~drake_ddp_tpu_torch.parallel`).
"""

import torch

# Full float32 everywhere on the card.  TF32 keeps ~3 decimal digits, the
# H100 analogue of the TPU's default bf16 matmul passes that the JAX
# package pins off inside its Riccati sweep (solver/ilqr.py): stiff
# contact linearizations overflow or lose their descent directions at
# that precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from drake_ddp_tpu_torch._device import resolve_device  # noqa: E402
from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem  # noqa: E402
from drake_ddp_tpu_torch.mpc.driver import (  # noqa: E402
    MPCConfig,
    mpc_solve,
    mpc_solve_batched,
)
from drake_ddp_tpu_torch.parallel import (  # noqa: E402
    batched_mpc,
    batched_solve,
    scenario_mesh,
)
from drake_ddp_tpu_torch.solver.api import (  # noqa: E402
    IterativeLinearQuadraticRegulator,
)
from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched  # noqa: E402
from drake_ddp_tpu_torch.solver.ilqr import (  # noqa: E402
    ILQRConfig,
    ILQRProblem,
    ILQRSolution,
    solve_ilqr,
)
from drake_ddp_tpu_torch.solver.keypoints import (  # noqa: E402
    DerivsInterpolation,
)
from drake_ddp_tpu_torch.solver.multistart import (  # noqa: E402
    multistart_ilqr,
)
from drake_ddp_tpu_torch.solver.transcription import (  # noqa: E402
    TranscriptionConfig,
    solve_transcription,
)

__all__ = [
    "resolve_device",
    "DiscreteSystem",
    "ILQRConfig",
    "ILQRProblem",
    "ILQRSolution",
    "solve_ilqr",
    "IterativeLinearQuadraticRegulator",
    "DerivsInterpolation",
    "MPCConfig",
    "mpc_solve",
    "mpc_solve_batched",
    "batched_mpc",
    "batched_solve",
    "scenario_mesh",
    "solve_ilqr_batched",
    "multistart_ilqr",
    "TranscriptionConfig",
    "solve_transcription",
]
