#!/usr/bin/env python3
"""Does a ``torch.profiler`` trace leave the process slower, and what
releases it?

    python3 trace_slowdown.py [--modes M1,M2,...] [--rounds 2] [--reps 5]
    python3 trace_slowdown.py --one MODE [--reps 5]

For each mode a fresh process (``--one``) times, on the card:

- ``launch_us``: the host's microseconds per launch of a tiny kernel
  (20,000 in-place adds on a 16-float tensor, one synchronisation at the
  end), the cost that a host-bound solve pays per operator;
- ``python_us``: microseconds per iteration of a pure-Python loop that
  allocates (no torch): whether the whole process slowed, or only its
  torch operators;
- ``solve_s``: the Panda side task's solve (``panda_fr3.build_solver
  (Config())``, ``Solve()``), a host-bound per-scenario solve;

``--reps`` times each before a trace of one such solve, and again after
it, and prints one JSON line per mode with the medians, the ratios after
/ before of the medians and of the fastest reps (the host's other load
only adds time, so the fastest rep is the steadier statistic) and the
trace's CUDA kernel events (a release must keep the device in the
trace).  ``--rounds`` repeats the list of modes.
The modes:

- ``none``: no trace (the solve runs unprofiled in its place): the
  control;
- ``plain``: ``torch.profiler.profile`` with CPU and CUDA activity, as
  the parent's ``utils.profiling.trace``;
- ``cpu_only``: CPU activity only;
- ``env_both``: ``plain`` with Kineto's ``TEARDOWN_CUPTI=1`` and
  ``DISABLE_CUPTI_LAZY_REINIT=1`` in the process's environment from its
  start; ``env_late``: the same set by the process itself after
  ``import torch``, before the card is first used;
- ``trace``: this tree's ``utils.profiling.trace``;
- ``trace_twice``: ``trace`` twice, timed after each (the second trace
  must hold the kernels too).

Prints the card's name and power limit first.  Needs a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MODES = ("none", "plain", "cpu_only", "env_both", "env_late", "trace",
         "trace_twice")
ENV = {"env_both": {"TEARDOWN_CUPTI": "1",
                    "DISABLE_CUPTI_LAZY_REINIT": "1"}}


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def one(mode, reps):
    import torch
    if mode == "env_late":
        os.environ.update(ENV["env_both"])
    sys.path.insert(0, str(REPO))
    from drake_ddp_tpu_torch.examples import panda_fr3
    from drake_ddp_tpu_torch.utils.profiling import trace
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    a = torch.zeros(16, device=dev)

    def launch_us(k=20000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            a.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k * 1e6

    def python_us(k=200000):
        t0 = time.perf_counter()
        for i in range(k):
            [i, (i, i), {"i": i}]
        return (time.perf_counter() - t0) / k * 1e6

    ilqr = panda_fr3.build_solver(panda_fr3.Config(verbose=False),
                                  device="cuda")

    def solve_s():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ilqr.Solve()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def measure():
        out = {k: [] for k in ("launch_us", "python_us", "solve_s")}
        for _ in range(reps):
            out["launch_us"].append(launch_us())
            out["python_us"].append(python_us())
            out["solve_s"].append(solve_s())
        return out

    def traced(tag):
        log_dir = REPO / "build" / "trace_slowdown" / tag
        log_dir.mkdir(parents=True, exist_ok=True)
        if mode == "none":
            ilqr.Solve()
            torch.cuda.synchronize()
            return 0
        if mode.startswith("trace"):
            with trace(str(log_dir)):
                ilqr.Solve()
                torch.cuda.synchronize()
        else:
            acts = [ProfilerActivity.CPU]
            if mode != "cpu_only":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                ilqr.Solve()
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(log_dir / "trace.json"))
            del prof
        events = json.loads((log_dir / "trace.json").read_text())[
            "traceEvents"]
        return sum(e.get("cat") == "kernel" for e in events)

    solve_s()                                     # build and warm
    launch_us()
    runs = [measure()]
    kernels = [traced(mode)]
    runs.append(measure())
    if mode == "trace_twice":
        kernels.append(traced(mode + "_2"))
        runs.append(measure())
    out = {"mode": mode, "env": ENV.get(mode, {}), "kernel_events": kernels,
           "runs": runs}
    for k in runs[0]:
        meds = [_median(r[k]) for r in runs]
        mins = [min(r[k]) for r in runs]
        out[k] = meds
        out[f"{k}_ratio"] = [m / meds[0] for m in meds[1:]]
        out[f"{k}_min_ratio"] = [m / mins[0] for m in mins[1:]]
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--one", choices=MODES)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_slowdown: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.one:
        return one(args.one, args.reps)
    sys.path.insert(0, str(REPO))
    import chip_smoke
    print(chip_smoke.card_line(), flush=True)
    for _ in range(args.rounds):
        for mode in args.modes.split(","):
            env = dict(os.environ, **ENV.get(mode, {}))
            subprocess.run([sys.executable, __file__, "--one", mode,
                            "--reps", str(args.reps)], env=env, check=False)


if __name__ == "__main__":
    main()
