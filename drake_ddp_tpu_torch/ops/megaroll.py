"""megaroll: the whole closed-loop linesearch rollout as one CUDA kernel.

Port of ``drake_ddp_tpu/ops/megaroll.py`` (``make_pallas_rollout``).
For each lane and t < T:

    u_t = u_bar_t - eps * kappa_t - K_t (x_t - x_bar_t)
    x_{t+1} = step(x_t, u_t)

with ``xs[t]`` the state AFTER step t (x0 is not repeated).  Lane-last
float32: x0 (n, L), eps (L,), u_bar / kappa (T, m, L), K (T, m, n, L),
x_bar (T, n, L) -> xs (T, n, L), us (T, m, L).  The kernel
(``csrc/megaroll.cu``) runs the time loop inside one launch; its plain
version, :func:`rollout_plain`, loops the plain lane step in Python.
"""

from __future__ import annotations

from typing import Callable

import torch

from drake_ddp_tpu_torch.ops import _cuda
from drake_ddp_tpu_torch.ops._table import (StepKernelData,
                                            kernel_data_for_system)
from drake_ddp_tpu_torch.ops.megastep import _check_lanes


def rollout_plain(step_T: Callable, x0, eps, u_bar, kappa, K, x_bar):
    """The plain version: the same closed-loop policy around any lane
    step, one step per Python iteration."""
    xs, us = [], []
    x = x0
    for t in range(u_bar.shape[0]):
        Kdx = torch.sum(K[t] * (x - x_bar[t])[None], dim=1)   # (m, L)
        u = u_bar[t] - eps[None] * kappa[t] - Kdx
        x = step_T(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)


def megaroll(kd: StepKernelData, x0, eps, u_bar, kappa, K, x_bar):
    """The fused rollout (see module docstring).

    CUDA tensors launch the kernel on the current stream (no
    synchronisation); CPU tensors run :func:`rollout_plain`."""
    if x0.device.type == "cpu":
        return rollout_plain(kd.step, x0, eps, u_bar, kappa, K, x_bar)
    if x0.device.type != "cuda":
        raise ValueError(f"megaroll runs on CUDA or CPU tensors, not "
                         f"{x0.device}")
    n, m = kd.n, kd.m
    T, L = u_bar.shape[0], x0.shape[-1]
    dev = x0.device
    for name, t, rows in (("x0", x0, (n,)), ("eps", eps, ()),
                          ("u_bar", u_bar, (T, m)), ("kappa", kappa, (T, m)),
                          ("K", K, (T, m, n)), ("x_bar", x_bar, (T, n))):
        _check_lanes(name, t, rows, dev)
        if t.shape[-1] != L:
            raise ValueError(f"{name} has {t.shape[-1]} lanes, x0 has {L}")
    lib = _cuda.load("megaroll")
    table = kd.table(dev, lib)
    scratch = kd.scratch(L, dev, lib)
    xs = torch.empty((T, n, L), dtype=torch.float32, device=dev)
    us = torch.empty((T, m, L), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.megaroll_launch(
        table.data_ptr(), x0.data_ptr(), eps.data_ptr(), u_bar.data_ptr(),
        kappa.data_ptr(), K.data_ptr(), x_bar.data_ptr(), xs.data_ptr(),
        us.data_ptr(), scratch.data_ptr(), L, T, stream)
    if rc != 0:
        raise RuntimeError(f"megaroll launch failed: CUDA error {rc}")
    megaroll.launches += 1
    return xs, us


megaroll.launches = 0


def megaroll_for_system(system):
    """The fused rollout of a multibody DiscreteSystem (the JAX package's
    ``pallas_rollout_for_system``)."""
    kd = kernel_data_for_system(system)
    return lambda *tapes: megaroll(kd, *tapes)
