"""Profiling instrumentation: a device trace and its idle summary.

Port of ``drake_ddp_tpu/utils/profiling.py``'s ``trace``:

- :func:`trace`: a ``torch.profiler`` trace of a block, CPU activity and,
  when a card is present, its CUDA kernels, written as a Chrome/Perfetto
  JSON trace (the device timeline: every kernel launch with its time);
- :func:`idle_by_span`: the card's idle time in such a trace, by the
  solver's ``ddp/`` span around each gap.

The solver's own per-phase device and host times, its spans and its
counters come from :class:`~drake_ddp_tpu_torch.utils.timing.PhaseTimer`
(:mod:`drake_ddp_tpu_torch.solver.profile` keeps them per round); while
a trace is taken, every span of the solver is a ``ddp/<name>`` range in
it, with or without a timer.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple


# Kineto's settings that tear CUPTI down when a trace stops and keep it
# from re-arming lazily: without both, every later launch pays for it
_CUPTI_RELEASE = ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace around a block and write it to
    ``log_dir`` (default: ``drake_ddp_tpu_torch_trace`` in the temporary
    directory) as ``trace.json``, a Chrome/Perfetto trace (open it in
    ``chrome://tracing`` or ui.perfetto.dev).  Yields the directory.
    Keep traced regions short (one solve, not a whole benchmark): traces
    are large.

    With a card present it sets Kineto's ``TEARDOWN_CUPTI`` and
    ``DISABLE_CUPTI_LAZY_REINIT`` to 1 unless the caller has set them:
    without them a trace left the process's later host-bound work slower
    (a Panda solve 1.28x on an H100, ``trace_slowdown.py``), with them
    it is not (0.98x), and the trace still records the card's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "drake_ddp_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        for key in _CUPTI_RELEASE:
            os.environ.setdefault(key, "1")
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# the trace's categories of work on the card, and of the solver's spans
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_SPAN_CAT, _SPAN_PREFIX = "user_annotation", "ddp/"


def idle_by_span(trace_json) -> Dict[str, float]:
    """The card's idle seconds between its operations in a Chrome trace
    that :func:`trace` wrote (a path, or the loaded JSON), grouped by the
    innermost ``ddp/`` span (the solver's, :mod:`~drake_ddp_tpu_torch.
    utils.timing`) that holds each gap's midpoint; gaps outside every span
    under ``"outside"``.  The largest first; empty without device
    operations (a CPU trace)."""
    if not isinstance(trace_json, dict):
        with open(trace_json) as f:
            trace_json = json.load(f)
    busy: List[Tuple[float, float]] = []
    spans: List[Tuple[float, float, str]] = []
    for ev in trace_json["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        if ev.get("cat") in _DEVICE_CATS:
            busy.append((s, e))
        elif (ev.get("cat") == _SPAN_CAT
              and ev.get("name", "").startswith(_SPAN_PREFIX)):
            spans.append((s, e, ev["name"]))
    merged: List[List[float]] = []
    for s, e in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    # the spans nest (one thread's ranges): one sweep over the gaps'
    # midpoints in order with a stack of the open spans
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    idle: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][0] <= mid:
            stack.append(spans[i])
            i += 1
        stack = [sp for sp in stack if sp[1] >= mid]
        idle[stack[-1][2] if stack else "outside"] += (b - a) * 1e-6
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))
