"""megajac: the structured-IFT step Jacobian as one CUDA kernel library.

Port of ``drake_ddp_tpu/ops/megajac.py`` (``make_pallas_jac``) and of the
cold-Newton probe kernel ``tools/probe_megajac_compile.py``
(``build_kernel``): for each lane, fx = d x'/d x (n, n) and fu = d x'/d u
(n, m) of the contact step, linearized by the implicit function theorem
at the step's root v'.  Root-seeded (``x_next`` given) the root is the
velocity of the rollout's own next state; cold, the kernel runs the
step's own contact Newton first.  Lane-last float32: x (n, L), u (m, L),
x_next (n, L) -> fx (n, n, L), fu (n, m, L), the direction on the second
axis.  The kernels (``csrc/megajac.cu``: a float64 primal with a team of
threads per lane and its working set in shared memory, then one
tangent-only dual-number pass per lane and direction) run the device step
of ``csrc/lanestep.cuh``; the plain version is
:func:`drake_ddp_tpu_torch.multibody.lanejac.make_lane_jac`.
"""

from __future__ import annotations

import torch

from drake_ddp_tpu_torch.ops import _cuda
from drake_ddp_tpu_torch.ops._table import (StepKernelData,
                                            kernel_data_for_system)
from drake_ddp_tpu_torch.ops.megastep import (_check_lanes, _config,
                                               check_fits_shared)


def _per_lane(kd: StepKernelData, lib) -> int:
    """Doubles of one lane's working set in the primal's shared memory,
    checked to fit (ValueError before any launch otherwise)."""
    per_lane = lib.ddp_scratch_per_lane(*kd.sizes)
    check_fits_shared(lib, per_lane, scalar_bytes=8)
    return per_lane


def launch_config(kd: StepKernelData, L: int, lib=None) -> dict:
    """How the primal launches L lanes on the current card: threads per
    lane, lanes per block, dynamic shared bytes per block, blocks.  ``lib``
    is a build of the kernel library (default: ``_cuda.load("megajac")``)."""
    lib = lib or _cuda.load("megajac")
    return _config(lib.megajac_config, L, _per_lane(kd, lib))


def _buffers(kd: StepKernelData, lib, L: int, dev: torch.device) -> dict:
    """One call's launch data, after the shared-memory check: the primal's
    working set in doubles per lane (``per_lane``), the outputs, and the
    float64 buffers: G^-1 (nv, nv, L), the primal's store of its working
    set (lane-strided), and the tangent passes' scratch: one double per
    (lane, direction) for each stored field that the direction's pass
    writes (``megajac_scratch_per_lane``)."""
    n, m, nv = kd.n, kd.m, kd.model.nv
    per_lane = _per_lane(kd, lib)
    fields = lib.megajac_store_per_lane(*kd.sizes)
    tangents = lib.megajac_scratch_per_lane(*kd.sizes)
    f64 = dict(dtype=torch.float64, device=dev)
    return dict(per_lane=per_lane,
                ginv=torch.empty((nv, nv, L), **f64),
                store=torch.empty(fields * L, **f64),
                scratch=torch.empty(tangents * L, **f64),
                fx=torch.empty((n, n, L), dtype=torch.float32, device=dev),
                fu=torch.empty((n, m, L), dtype=torch.float32, device=dev))


def _primal(lib, kd: StepKernelData, b, x, u, x_next=None):
    """Launch the primal: G^-1 and the store into the buffers ``b``."""
    L, dev = x.shape[-1], x.device
    rc = lib.megajac_primal_launch(
        kd.table(dev, lib).data_ptr(), x.data_ptr(), u.data_ptr(),
        None if x_next is None else x_next.data_ptr(), b["ginv"].data_ptr(),
        b["store"].data_ptr(), L, b["per_lane"],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"megajac primal launch failed: CUDA error {rc}")


def _tangent(lib, kd: StepKernelData, b):
    """Launch the tangent passes on the primal's buffers: fx and fu."""
    L, dev = b["fx"].shape[-1], b["fx"].device
    rc = lib.megajac_tangent_launch(
        kd.table(dev, lib).data_ptr(), b["ginv"].data_ptr(),
        b["store"].data_ptr(), b["fx"].data_ptr(), b["fu"].data_ptr(),
        b["scratch"].data_ptr(), L, kd.n + kd.m,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"megajac tangent launch failed: CUDA error {rc}")


def _launch(lib, kd: StepKernelData, x, u, x_next=None):
    """Both kernels of the library ``lib`` on checked CUDA inputs: (fx,
    fu, G^-1)."""
    b = _buffers(kd, lib, x.shape[-1], x.device)
    _primal(lib, kd, b, x, u, x_next)
    _tangent(lib, kd, b)
    return b["fx"], b["fu"], b["ginv"]


def megajac(kd: StepKernelData, x: torch.Tensor, u: torch.Tensor,
            x_next=None):
    """(fx, fu) of the step at (x, u); root-seeded at ``x_next`` when it
    is given, else cold-Newton.

    CUDA tensors launch the kernels on the current stream (no
    synchronisation); CPU tensors run the plain lane Jacobian."""
    root = x_next is not None
    if x.device.type == "cpu":
        jac = kd.lane_jac(root)
        return jac(x, u, x_next) if root else jac(x, u)
    if x.device.type != "cuda":
        raise ValueError(f"megajac runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    n, m = kd.n, kd.m
    L, dev = x.shape[-1], x.device
    ins = (("x", x, n), ("u", u, m)) + ((("x_next", x_next, n),)
                                        if root else ())
    for name, t, rows in ins:
        _check_lanes(name, t, (rows,), dev)
        if t.shape[-1] != L:
            raise ValueError(f"{name} has {t.shape[-1]} lanes, x has {L}")
    nc = kd.sizes[4]
    if nc and kd.contact_iters < 1:
        raise ValueError("megajac needs the implicit contact step "
                         "(contact_iters >= 1)")
    fx, fu, _ = _launch(_cuda.load("megajac"), kd, x, u, x_next)
    megajac.launches += 1
    return fx, fu


megajac.launches = 0


def megajac_for_system(system, root_seed: bool):
    """The kernel Jacobian of a multibody DiscreteSystem (the JAX
    package's ``pallas_jac_for_system``): ``(x, u, x_next) -> (fx, fu)``
    root-seeded, ``(x, u) -> (fx, fu)`` cold."""
    kd = kernel_data_for_system(system)
    if root_seed:
        return lambda x, u, x_next: megajac(kd, x, u, x_next)
    return lambda x, u: megajac(kd, x, u)
