"""Per-iteration phase-timed iLQR solve (the reference's solver-phase
timers).

Port of ``drake_ddp_tpu/solver/profile.py``.  The reference brackets each
solver phase with wall-clock timers and prints per-iteration
``time_fp`` / ``time_getDerivs`` / ``time_bp`` columns (reference
ilqr.py:364-372, 685-704).  The JAX package needs a second, host-stepped
copy of its fused XLA loop for that; the port's loop is already driven
from the host, so these functions run the ordinary solver
(:func:`~drake_ddp_tpu_torch.solver.ilqr.solve_ilqr`,
:func:`~drake_ddp_tpu_torch.solver.batched.solve_ilqr_batched`) with a
timer that closes one record per iLQR round:

- ``forward``: the round's whole linesearch (its rollouts and costs);
- ``derivs``: the derivative phase (0 in a round that reuses the cached
  Jacobians, a per-scenario regularization retry);
- ``backward``: the Riccati sweep (or the associative scan).

On the card the timer records CUDA events on the current stream and
reads them once, after the solve: nothing inside the solve waits for
them.  On the CPU, where the work runs synchronously, it reads the host
clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from drake_ddp_tpu_torch._device import resolve_device
from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
from drake_ddp_tpu_torch.solver.ilqr import (
    ILQRConfig,
    ILQRProblem,
    ILQRSolution,
    solve_ilqr,
)
from drake_ddp_tpu_torch.utils.timing import phase

# the solver's phase names that close a round's record, by PhaseTimes field
_ROUND_PHASES = {"linesearch": "forward", "derivs": "derivs",
                 "riccati": "backward"}


class PhaseTimes(NamedTuple):
    """Per-iteration phase seconds (device time on the card)."""

    forward: List[float]      # linesearch rollouts (reference time_fp)
    derivs: List[float]       # Jacobian stack (reference time_getDerivs)
    backward: List[float]     # Riccati sweep (reference time_bp)

    def totals(self):
        return {
            "forward": float(sum(self.forward)),
            "derivs": float(sum(self.derivs)),
            "backward": float(sum(self.backward)),
        }

    def fractions(self):
        t = self.totals()
        s = max(sum(t.values()), 1e-12)
        return {k: v / s for k, v in t.items()}


class RoundTimer:
    """The solver's phase timer (``timer=`` of the solve functions) that
    keeps one record per iLQR round of its linesearch, derivative and
    Riccati phases.  Every phase, these and the nested ones (rollout,
    jac), also goes to ``inner``, an optional
    :class:`~drake_ddp_tpu_torch.utils.timing.PhaseTimer`."""

    def __init__(self, device, inner=None):
        self.cuda = torch.device(device).type == "cuda"
        self.inner = inner
        self._rounds: List[dict] = []

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def phase(self, name: str):
        with phase(self.inner, name):
            if name not in _ROUND_PHASES:
                yield
                return
            if name == "linesearch":
                self._rounds.append({})
            record = self._rounds[-1]
            start = self._mark()
            try:
                yield
            finally:
                record[_ROUND_PHASES[name]] = (start, self._mark())

    def times(self) -> PhaseTimes:
        """The records as seconds (on the card: one synchronisation)."""
        if self.cuda:
            torch.cuda.synchronize()
            secs = lambda se: se[0].elapsed_time(se[1]) / 1e3
        else:
            secs = lambda se: se[1] - se[0]
        return PhaseTimes(*([secs(r[f]) if f in r else 0.0
                             for r in self._rounds]
                            for f in PhaseTimes._fields))


def _on_device(prob: ILQRProblem, device) -> ILQRProblem:
    """``prob`` with its leaves on ``device`` (arrays as float32)."""
    dev = resolve_device(device)
    move = lambda a: (a.to(dev) if torch.is_tensor(a)
                      else torch.as_tensor(np.asarray(a),
                                           dtype=torch.float32, device=dev))
    return ILQRProblem(*(None if a is None else move(a) for a in prob))


def profiled_solve(system: DiscreteSystem, cfg: ILQRConfig,
                   prob: ILQRProblem, device=None,
                   deriv_kernel: Optional[str] = None, timer=None):
    """The per-scenario solve (:func:`~drake_ddp_tpu_torch.solver.ilqr.
    solve_ilqr`, the same call) with per-iteration phase times.

    ``prob`` has no batch axis.  ``device``: where the solve runs, its
    leaves moved there (None: where they are).  ``deriv_kernel`` as in
    ``solve_ilqr``; ``timer`` an optional
    :class:`~drake_ddp_tpu_torch.utils.timing.PhaseTimer` that also gets
    every phase.  Returns ``(ILQRSolution, PhaseTimes)``."""
    if device is not None:
        prob = _on_device(prob, device)
    rounds = RoundTimer(prob.x0.device, inner=timer)
    sol = solve_ilqr(system, cfg, prob, deriv_kernel=deriv_kernel,
                     timer=rounds)
    return sol, rounds.times()


def profiled_solve_batched(system: DiscreteSystem, cfg: ILQRConfig,
                           prob: ILQRProblem, rollout_kernel: str = "fused",
                           deriv_kernel: str = "megajac"):
    """The batched solve (:func:`~drake_ddp_tpu_torch.solver.batched.
    solve_ilqr_batched`, the same call and kernels) with phase times per
    round of the batch loop.  Returns ``(ILQRSolution, PhaseTimes)``."""
    rounds = RoundTimer(prob.x0.device)
    sol = solve_ilqr_batched(system, cfg, prob,
                             rollout_kernel=rollout_kernel,
                             deriv_kernel=deriv_kernel, timer=rounds)
    return sol, rounds.times()


def format_phase_table(sol: ILQRSolution, times: PhaseTimes) -> str:
    """The reference's iteration table with the per-phase timing columns
    (reference ilqr.py:685-704: iter / cost / eps / ls / time_fp /
    time_derivs / time_bp) and a totals line.  ``sol`` is one scenario's
    solution (tensors or numpy)."""
    stats = sol.stats
    it = int(sol.iterations)
    bar = "-" * 92
    lines = [bar,
             "| iter |    cost    |   eps   | ls | derivs % | "
             "time_fp  | time_derivs | time_bp  |",
             bar]
    for i in range(it):
        tf = times.forward[i] if i < len(times.forward) else 0.0
        td = times.derivs[i] if i < len(times.derivs) else 0.0
        tb = times.backward[i] if i < len(times.backward) else 0.0
        lines.append(
            f"{i + 1:^8}{float(stats.cost[i]):11.4f} "
            f"{float(stats.eps[i]):^9.4f}{int(stats.ls_iters[i]):^5}"
            f"{float(stats.percent_derivs[i]):^9.1f} "
            f"{tf:9.4f}  {td:11.4f} {tb:9.4f}")
    t = times.totals()
    tot = sum(t.values())
    lines.append(bar)
    lines.append(
        "phase totals: forward %.4f s (%.0f%%), derivs %.4f s (%.0f%%), "
        "backward %.4f s (%.0f%%)" % (
            t["forward"], 100.0 * t["forward"] / max(tot, 1e-12),
            t["derivs"], 100.0 * t["derivs"] / max(tot, 1e-12),
            t["backward"], 100.0 * t["backward"] / max(tot, 1e-12)))
    return "\n".join(lines)
