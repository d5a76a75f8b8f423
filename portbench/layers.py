"""What the metric readers share: the window's solver phases per iLQR
round, and the work a phase did, counted from the problem's sizes
(``portbench.yardstick``), over its measured time."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench import yardstick as ys


def rounds(run) -> int:
    """iLQR rounds in the window (one Riccati sweep each)."""
    return run.counts.get("riccati", 0)


def ms_per_round(run, phase: str) -> Optional[float]:
    r = rounds(run)
    if not r or phase not in run.phases_ms:
        return None
    return run.phases_ms[phase] / r


def rollout_work(run):
    """(operations, bytes) of the window's rollout calls: every call rolls
    out ``rollout_lanes`` lanes over N - 1 steps."""
    sz, sh = run.cfg["sizes"], run.shapes
    calls = run.counts.get("rollout", 0)
    steps = sh["N"] - 1
    ops = calls * sh["rollout_lanes"] * steps * ys.rollout_lane_step_ops(sz)
    return ops, calls * ys.rollout_call_bytes(sz, sh["rollout_lanes"], steps)


def jac_work(run):
    """(operations, bytes) of the window's Jacobian calls: every call
    differentiates ``jac_lanes`` lane steps."""
    sz, sh = run.cfg["sizes"], run.shapes
    calls = run.counts.get("jac", 0)
    ops = calls * sh["jac_lanes"] * ys.jac_ops(sz, sh["root"])
    return ops, calls * ys.jac_call_bytes(sz, sh["jac_lanes"], sh["root"])


def riccati_ops(run) -> float:
    sh = run.shapes
    return (rounds(run) * sh["B"] * (sh["N"] - 1)
            * ys.riccati_step_ops(sh["n"], sh["m"]))


def roofline(run, work, phase: str) -> Optional[float]:
    """The least time of a phase's work over its measured time, in %."""
    ms = run.phases_ms.get(phase)
    if not ms or not run.counts.get(phase):
        return None
    ops, n_bytes = work(run)
    return 100.0 * ys.bound_s(ops, n_bytes) / (ms * 1e-3)


def step_mfu(run) -> Optional[float]:
    """The window's rollout, Jacobian and Riccati operations over the
    window's seconds at the float32 peak, in %."""
    if not rounds(run):
        return None
    ops = rollout_work(run)[0] + jac_work(run)[0] + riccati_ops(run)
    return 100.0 * ops / (run.window_s * ys.PEAK_FP32_FLOPS)


def idle_share(run) -> Optional[float]:
    st = run.stretch
    if st is None or not st.window_s or not st.kernels:
        return None
    return 100.0 * max(0.0, 1.0 - st.busy_s / st.window_s)


def p90_ms(values) -> float:
    """The 90th percentile of the step times, in ms."""
    if len(values) < 2:
        return 1e3 * values[0]
    return 1e3 * statistics.quantiles(values, n=10, method="inclusive")[8]
