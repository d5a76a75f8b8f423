"""megajac: the structured-IFT step Jacobian as one CUDA kernel library.

Port of ``drake_ddp_tpu/ops/megajac.py`` (``make_pallas_jac``) and of the
cold-Newton probe kernel ``tools/probe_megajac_compile.py``
(``build_kernel``): for each lane, fx = d x'/d x (n, n) and fu = d x'/d u
(n, m) of the contact step, linearized by the implicit function theorem
at the step's root v'.  Root-seeded (``x_next`` given) the root is the
velocity of the rollout's own next state; cold, the kernel runs the
step's own contact Newton first.  Lane-last float32: x (n, L), u (m, L),
x_next (n, L) -> fx (n, n, L), fu (n, m, L), the direction on the second
axis.  The kernels (``csrc/megajac.cu``: a primal pass per lane, then one
dual-number pass per lane and direction) run the device step of
``csrc/lanestep.cuh``; the plain version is
:func:`drake_ddp_tpu_torch.multibody.lanejac.make_lane_jac`.
"""

from __future__ import annotations

import torch

from drake_ddp_tpu_torch.ops import _cuda
from drake_ddp_tpu_torch.ops._table import (StepKernelData,
                                            kernel_data_for_system)
from drake_ddp_tpu_torch.ops.megastep import _check_lanes


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
    n, m, nv = kd.n, kd.m, kd.model.nv
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
    lib = _cuda.load("megajac")
    table = kd.table(dev, lib)
    ndir = n + m
    per_lane = lib.ddp_scratch_per_lane(*kd.sizes, 1)   # team of one
    # the kernels compute in float64 (csrc/megajac.cu says why): a
    # working set per lane, and one of Duals {value, tangent} per (lane,
    # direction)
    f64 = dict(dtype=torch.float64, device=dev)
    scratch = torch.empty(per_lane * L, **f64)
    dual = torch.empty(2 * per_lane * L * ndir, **f64)
    ginv = torch.empty((nv, nv, L), **f64)
    vp = torch.empty((nv, L), **f64)
    fx = torch.empty((n, n, L), dtype=torch.float32, device=dev)
    fu = torch.empty((n, m, L), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.megajac_launch(
        table.data_ptr(), x.data_ptr(), u.data_ptr(),
        x_next.data_ptr() if root else None, fx.data_ptr(), fu.data_ptr(),
        ginv.data_ptr(), vp.data_ptr(), scratch.data_ptr(), dual.data_ptr(),
        L, ndir, stream)
    if rc != 0:
        raise RuntimeError(f"megajac launch failed: CUDA error {rc}")
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
