"""Profiling instrumentation: host wall-clock spans and a device trace.

Port of ``drake_ddp_tpu/utils/profiling.py``:

- :class:`phase_timer`: host-side wall-clock bracketing of named spans
  (compile or build, solves, MPC chunks);
- :func:`trace`: a ``torch.profiler`` trace of a block, CPU activity and,
  when a card is present, its CUDA kernels, written as a Chrome/Perfetto
  JSON trace (the device timeline: every kernel launch with its time).

The solver's own per-phase device times come from CUDA events
(:mod:`drake_ddp_tpu_torch.utils.timing`, :mod:`drake_ddp_tpu_torch.
solver.profile`).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Iterator, Optional


class phase_timer:
    """Accumulate named wall-clock spans.

    >>> t = phase_timer()
    >>> with t("solve"):
    ...     run()
    >>> t.report()
    {'solve': 1.23}
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        st = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - st
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return dict(self.totals)

    def pretty(self) -> str:
        rows = [
            f"  {k:<24s} {v:8.3f} s  (x{self.counts[k]})"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "phase timings:\n" + "\n".join(rows)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``log_dir`` (default: ``drake_ddp_tpu_torch_trace`` in the temporary
    directory) as ``trace.json``, a Chrome/Perfetto trace (open it in
    ``chrome://tracing`` or ui.perfetto.dev).  Yields the directory.
    Keep traced regions short (one solve, not a whole benchmark): traces
    are large."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "drake_ddp_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
