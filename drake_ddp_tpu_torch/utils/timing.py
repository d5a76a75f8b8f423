"""Per-phase device time from CUDA events.

The batched solver brackets its stages (the linesearch and its
rollouts, lane Jacobian, derivative total, Riccati sweep) with
:meth:`PhaseTimer.phase` when it is given a timer
(:mod:`drake_ddp_tpu_torch.solver.profile` keeps them per iLQR round).  Events are only recorded, never waited on, inside
the solve; :meth:`PhaseTimer.totals_ms` synchronises once and sums the
elapsed times per phase.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    """Sums the device time of named phases on the current stream."""

    def __init__(self):
        self._events = defaultdict(list)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events[name].append((start, end))
            self.counts[name] += 1

    def totals_ms(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self._events.items()}


def phase(timer, name: str):
    """``timer.phase(name)``, or a no-op context without a timer."""
    return contextlib.nullcontext() if timer is None else timer.phase(name)
