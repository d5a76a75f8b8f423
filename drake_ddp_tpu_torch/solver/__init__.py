"""solver (PyTorch port; see the package docstring): the per-scenario
and batched iLQR, its class API, multi-start, the direct-transcription
baseline and the phase-timed solve."""

from drake_ddp_tpu_torch.solver.ilqr import (
    ILQRConfig,
    ILQRProblem,
    ILQRSolution,
    solve_ilqr,
)
from drake_ddp_tpu_torch.solver.keypoints import DerivsInterpolation
from drake_ddp_tpu_torch.solver.api import IterativeLinearQuadraticRegulator
from drake_ddp_tpu_torch.solver.multistart import (MultistartResult,
                                                   multistart_ilqr)
from drake_ddp_tpu_torch.solver.profile import (
    PhaseTimes,
    format_phase_table,
    profiled_solve,
    profiled_solve_batched,
)
from drake_ddp_tpu_torch.solver.transcription import (
    TranscriptionConfig,
    TranscriptionSolution,
    solve_transcription,
)

__all__ = [
    "ILQRConfig",
    "ILQRProblem",
    "ILQRSolution",
    "solve_ilqr",
    "DerivsInterpolation",
    "IterativeLinearQuadraticRegulator",
    "MultistartResult",
    "multistart_ilqr",
    "TranscriptionConfig",
    "TranscriptionSolution",
    "solve_transcription",
    "PhaseTimes",
    "format_phase_table",
    "profiled_solve",
    "profiled_solve_batched",
]
