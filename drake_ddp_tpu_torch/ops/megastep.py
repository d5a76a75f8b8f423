"""megastep: one multibody contact step for L lanes, as one CUDA kernel.

Port of ``drake_ddp_tpu/ops/megastep.py`` (``make_pallas_step``).  The
kernel (``csrc/megastep.cu``) runs the device step of
``csrc/lanestep.cuh``, one team of threads per lane with the lane's
working set in shared memory; its plain version is the lane step of
:mod:`drake_ddp_tpu_torch.multibody.lanestep`.  The batched
solver launches it once per horizon step on its ``rollout_kernel=
"megastep"`` path; the fused whole-horizon rollout is :mod:`.megaroll`.
"""

from __future__ import annotations

import ctypes

import torch

from drake_ddp_tpu_torch.ops import _cuda
from drake_ddp_tpu_torch.ops._table import (StepKernelData,
                                            kernel_data_for_system)


def _check_lanes(name, t, rows, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                        f"got {t.dtype}")
    if tuple(t.shape[:-1]) != tuple(rows):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(rows)} + (L,)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def team_lane_floats(kd: StepKernelData, lib, extra: int = 0) -> int:
    """Scalars of one lane's working set in a team kernel (the
    ``Layout`` of ``csrc/lanestep.cuh``).  Raises ValueError, before any
    launch, when the table and one lane's working set plus ``extra``
    floats do not fit the shared memory of one block."""
    per_lane = lib.ddp_scratch_per_lane(*kd.sizes, 0)
    need = (-(-lib.ddp_table_bytes() // 16) * 16
            + 4 * (-(-(per_lane + extra) // 4) * 4))
    limit = lib.ddp_smem_optin()
    if need > limit:
        raise ValueError(
            f"the step table and one lane's working set take {need} bytes "
            f"of shared memory; a block of this card has {limit}")
    return per_lane


def _config(fn, *args):
    out = (ctypes.c_int * 4)()
    rc = fn(*args, out)
    if rc != 0:
        raise RuntimeError(f"launch configuration failed: CUDA error {rc}")
    return dict(zip(("threads_per_lane", "lanes_per_block",
                     "shared_bytes_per_block", "blocks"), out))


def launch_config(kd: StepKernelData, L: int) -> dict:
    """How megastep launches L lanes on the current card: threads per
    lane, lanes per block, dynamic shared bytes per block, blocks."""
    lib = _cuda.load("megastep")
    return _config(lib.megastep_config, L, team_lane_floats(kd, lib))


def megastep(kd: StepKernelData, x: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """x (n, L), u (m, L) -> x_next (n, L).

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation); a CPU tensor runs the plain lane step."""
    if x.device.type == "cpu":
        return kd.step(x, u)
    if x.device.type != "cuda":
        raise ValueError(f"megastep runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    L = x.shape[-1]
    _check_lanes("x", x, (kd.n,), x.device)
    _check_lanes("u", u, (kd.m,), x.device)
    if u.shape[-1] != L:
        raise ValueError(f"u has {u.shape[-1]} lanes, x has {L}")
    lib = _cuda.load("megastep")
    per_lane = team_lane_floats(kd, lib)
    table = kd.table(x.device, lib)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.megastep_launch(table.data_ptr(), x.data_ptr(), u.data_ptr(),
                             out.data_ptr(), L, per_lane, stream)
    if rc != 0:
        raise RuntimeError(f"megastep launch failed: CUDA error {rc}")
    megastep.launches += 1
    return out


megastep.launches = 0


def megastep_for_system(system):
    """The kernel step ``(x (n, L), u (m, L)) -> x_next`` of a multibody
    DiscreteSystem (the JAX package's ``pallas_step_for_system``)."""
    kd = kernel_data_for_system(system)
    return lambda x, u: megastep(kd, x, u)
