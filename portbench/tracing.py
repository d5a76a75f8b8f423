"""The device trace of a short stretch of a traced run, and what the
benchmark reads from it: the seconds an operation ran on the card, the
stretch's length, the operations that took the most device time, and the
longest idle gaps of the card by what the host was doing.

The trace is ``torch.profiler``'s (CUPTI through Kineto), written as a
Chrome trace into a temporary directory under ``TMPDIR`` and read back;
Kineto's CUPTI is torn down after it (``TEARDOWN_CUPTI``,
``DISABLE_CUPTI_LAZY_REINIT``), or the process stays slower after a
trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


class Stretch:
    """What one traced stretch read: ``busy_s``, ``window_s`` (host clock
    around the stretch, which ends in a synchronise), ``device_ops`` and
    ``idle_gaps`` (lists of [name, seconds], the largest first), and the
    number of device operations."""

    def __init__(self):
        self.busy_s = self.window_s = 0.0
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.kernels = 0


@contextlib.contextmanager
def traced(stretch: Stretch) -> Iterator[None]:
    """Trace the block (which must end with the card idle) into
    ``stretch``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for key in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT"):
        os.environ.setdefault(key, "1")
    with tempfile.TemporaryDirectory(prefix="portbench_trace_") as d:
        path = os.path.join(d, "trace.json")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            stretch.window_s = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    reduce_events(events, stretch)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: List[Dict], stretch: Stretch) -> Stretch:
    """Fill ``stretch`` from a Chrome trace's events (times in us)."""
    dev = []
    host = defaultdict(list)
    by_name = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((s, s + dur))
            by_name[ev["name"][:120]] += dur * 1e-6
        elif cat in HOST_CATS:
            host[ev.get("tid")].append((s, s + dur, ev["name"][:120]))
    busy = _merge(dev)
    stretch.kernels = len(dev)
    stretch.busy_s = sum(e - s for s, e in busy) * 1e-6
    stretch.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # idle gaps between device work, each named by the innermost event
    # of the busiest host thread around its middle (its Python where
    # none is); events of one thread nest, so one sweep with a stack
    gaps = sorted((a[1], b[0]) for a, b in zip(busy, busy[1:])
                  if b[0] > a[1])
    main = (sorted(max(host.values(), key=len), key=lambda h: (h[0], -h[1]))
            if host else [])
    idle = defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while i < len(main) and main[i][0] <= mid:
            while stack and stack[-1][1] < main[i][0]:
                stack.pop()
            stack.append(main[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host python (no traced op)"
        idle[name] += (e - s) * 1e-6
    stretch.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return stretch
