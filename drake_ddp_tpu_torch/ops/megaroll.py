"""megaroll: the whole closed-loop linesearch rollout as one CUDA kernel.

Port of ``drake_ddp_tpu/ops/megaroll.py`` (``make_pallas_rollout``).
For each lane and t < T:

    u_t = u_bar_t - eps * kappa_t - K_t (x_t - x_bar_t)
    x_{t+1} = step(x_t, u_t)

with ``xs[t]`` the state AFTER step t (x0 is not repeated).  Lane-last
float32: x0 (n, L), eps (L,), u_bar / kappa (T, m, L), K (T, m, n, L),
x_bar (T, n, L) -> xs (T, n, L), us (T, m, L).  The kernel
(``csrc/megaroll.cu``) runs the time loop inside one launch, one team of
threads per lane with the lane's working set in shared memory; its plain
version, :func:`rollout_plain`, loops the plain lane step in Python.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from drake_ddp_tpu_torch.ops import _cuda
from drake_ddp_tpu_torch.ops._table import (StepKernelData,
                                            kernel_data_for_system)
from drake_ddp_tpu_torch.ops.megastep import (_check_lanes, _config,
                                               team_lane_floats)


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


def tape_floats(kd: StepKernelData) -> int:
    """Floats a lane keeps beside its working set: one step's K slice,
    u_bar, kappa and x_bar (``roll_tape_floats`` in csrc/megaroll.cu)."""
    return kd.m * kd.n + 2 * kd.m + kd.n


def launch_config(kd: StepKernelData, L: int, lib=None) -> dict:
    """How megaroll launches L lanes on the current card: threads per
    lane, lanes per block, dynamic shared bytes per block, blocks.  ``lib``
    is a build of the kernel library (default: ``_cuda.load("megaroll")``)."""
    lib = lib or _cuda.load("megaroll")
    per_lane = team_lane_floats(kd, lib, tape_floats(kd))
    return _config(lib.megaroll_config, L, per_lane, kd.n, kd.m)


def _launch(lib, kd: StepKernelData, x0, eps, u_bar, kappa, K, x_bar):
    """One launch of the kernel library ``lib`` on checked CUDA tapes."""
    n, m = kd.n, kd.m
    T, L, dev = u_bar.shape[0], x0.shape[-1], x0.device
    per_lane = team_lane_floats(kd, lib, tape_floats(kd))
    table = kd.table(dev, lib)
    xs = torch.empty((T, n, L), dtype=torch.float32, device=dev)
    us = torch.empty((T, m, L), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.megaroll_launch(
        table.data_ptr(), x0.data_ptr(), eps.data_ptr(), u_bar.data_ptr(),
        kappa.data_ptr(), K.data_ptr(), x_bar.data_ptr(), xs.data_ptr(),
        us.data_ptr(), L, T, per_lane, n, m, stream)
    if rc != 0:
        raise RuntimeError(f"megaroll launch failed: CUDA error {rc}")
    return xs, us


# the phases of csrc/lanestep.cuh StepPhase, in order
PHASES = ("tape", "policy", "kinematics", "mass_matrix", "bias",
          "predictor", "contact_geometry", "residual_with_G", "gauss_jordan",
          "residual", "newton_step", "integrate", "out")


def phase_cycles(kd: StepKernelData, x0, eps, u_bar, kappa, K, x_bar):
    """Where one launch's time goes: clock cycles per lane-step in each
    phase of the step (``PHASES``), on each team's first thread, from the
    kernel built with a phase-clocking team (``csrc/megaroll_clocks.cu``).
    CUDA tapes only; synchronises."""
    lib = _cuda.load("megaroll_clocks")
    n, m = kd.n, kd.m
    T, L, dev = u_bar.shape[0], x0.shape[-1], x0.device
    per_lane = team_lane_floats(kd, lib, tape_floats(kd))
    table = kd.table(dev, lib)
    xs = torch.empty((T, n, L), dtype=torch.float32, device=dev)
    us = torch.empty((T, m, L), dtype=torch.float32, device=dev)
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.megaroll_clocks_launch(
        table.data_ptr(), x0.data_ptr(), eps.data_ptr(), u_bar.data_ptr(),
        kappa.data_ptr(), K.data_ptr(), x_bar.data_ptr(), xs.data_ptr(),
        us.data_ptr(), L, T, per_lane, n, m, cycles, stream)
    if rc != 0:
        raise RuntimeError(f"megaroll_clocks launch failed: CUDA error {rc}")
    return {p: c / (L * T) for p, c in zip(PHASES, cycles)}


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
    xs, us = _launch(_cuda.load("megaroll"), kd, x0, eps, u_bar, kappa, K,
                     x_bar)
    _cuda.count_launch(megaroll)
    return xs, us


megaroll.launches = 0


def megaroll_for_system(system):
    """The fused rollout of a multibody DiscreteSystem (the JAX package's
    ``pallas_rollout_for_system``)."""
    kd = kernel_data_for_system(system)
    return lambda *tapes: megaroll(kd, *tapes)
