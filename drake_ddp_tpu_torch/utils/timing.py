"""The port's phase timer: device time from CUDA events, host time from
the host clock, counters, and profiler annotations.

The batched solver (:mod:`drake_ddp_tpu_torch.solver.batched`) and the
MPC driver bracket their work when they are given a timer
(:mod:`drake_ddp_tpu_torch.solver.profile` keeps the phases per iLQR
round):

- :func:`phase`: device work (the linesearch and its rollouts, lane
  Jacobian, derivative total, Riccati sweep): CUDA events on the current
  stream, and the host clock at entry and exit;
- :func:`span`: host-only spans (a whole solve, the host blocked on a
  read of the card), the host clock alone; :func:`spanned` makes a
  function's every call one;
- :func:`count`: counters (the lanes still iterating).

These module functions are the one place that knows what a timer
offers: a timer needs only ``phase``; one without ``span`` or ``count``
(one that brackets phases alone) gets the profiler's annotation in place
of its spans and keeps no counters.

Events are only recorded, never waited on, inside the solve, and the host
clock is read with no synchronisation: a phase's host time is what the
host took to enqueue it, and its event time runs from when the card
reached the phase (after the work enqueued before it) to when it finished
it.  :meth:`PhaseTimer.totals_ms` synchronises once and sums both.

While a ``torch.profiler`` session is active every span, with or without
a timer, is also a ``record_function("ddp/<name>")`` range, so a device
trace shows the solver's phases on the kernels' clock
(:func:`~drake_ddp_tpu_torch.utils.profiling.idle_by_span`).  Without a
timer and without a profiler a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time
from collections import defaultdict
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

_NULL = contextlib.nullcontext()


def annotation(name: str):
    """``record_function("ddp/<name>")`` while a profiler is active, else
    a no-op context."""
    # the module flag every torch.profiler session sets: a plain read,
    # where asking the profiler itself would cross into C++ on every span
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function("ddp/" + name)
    return _NULL


class PhaseTimer:
    """Sums named spans: each phase's device time on the current stream
    (where a card is available) and every span's host time; counts spans
    and counters in ``counts``.  Without a card the timer keeps host
    spans and counters only."""

    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self._events = defaultdict(list)
        self._host_s: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def phase(self, name: str):
        """Device work: CUDA events and the host clock."""
        return self._span(name, self.cuda)

    def span(self, name: str):
        """Host-only: the host clock, no events."""
        return self._span(name, False)

    def count(self, name: str, k: int) -> None:
        self.counts[name] += int(k)

    @contextlib.contextmanager
    def _span(self, name: str, events: bool):
        with annotation(name):
            t0 = time.perf_counter()
            if events:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            try:
                yield
            finally:
                if events:
                    end.record()
                    self._events[name].append((start, end))
                self._host_s[name] += time.perf_counter() - t0
                self.counts[name] += 1

    def totals_ms(self) -> Dict[str, float]:
        """Each phase's device ms under its name, and every span's host ms
        under ``host:<name>``."""
        if self._events:
            torch.cuda.synchronize()
        out = {name: sum(s.elapsed_time(e) for s, e in pairs)
               for name, pairs in self._events.items()}
        out.update((f"host:{name}", 1e3 * s)
                   for name, s in self._host_s.items())
        return out


def phase(timer, name: str):
    """``timer.phase(name)``, or without a timer the profiler's
    annotation."""
    return annotation(name) if timer is None else timer.phase(name)


def span(timer, name: str):
    """``timer.span(name)``, or the profiler's annotation without a timer
    or with one that brackets phases alone."""
    s = getattr(timer, "span", None)
    return annotation(name) if s is None else s(name)


def count(timer, name: str, k: int) -> None:
    """``timer.count(name, k)``; nothing without a timer or with one that
    keeps no counters."""
    c = getattr(timer, "count", None)
    if c is not None:
        c(name, k)


def spanned(name: str):
    """Decorator: each call of the function is the host-only span
    ``name`` of the timer passed as its ``timer`` argument."""
    def wrap(fn):
        at = list(inspect.signature(fn).parameters).index("timer")

        @functools.wraps(fn)
        def call(*args, **kwargs):
            timer = args[at] if len(args) > at else kwargs.get("timer")
            with span(timer, name):
                return fn(*args, **kwargs)
        return call
    return wrap
