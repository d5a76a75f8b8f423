"""Run one cell of the port's benchmark on the card this process sees.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the repository root.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``portbench/configs/<config>.json``) and a
traffic mix (``portbench/traffic/<traffic>.json``, whose ``driver``
names the module of ``portbench/drivers`` that drives it); each metric
is read by ``portbench/metrics/<metric>.py``; the check's limits are in
``portbench/limits/<workload>.json``.

Set-up (``setup_s``: imports, the kernel build or load, the system, a
warm-up on another seed) is timed from the process's start; then the
cell's traffic runs for ``--seconds``, and once the window has closed
its output is checked against the plain reference.  ``--trace 0``
reports the cell's end-to-end metrics; ``--trace 1`` times the solver's
phases over the window, traces a short stretch after it, and reports the
per-layer metrics.  The last line of standard output is the result; the
last lines of standard error are the check's numbers beside their limits.
Exits non-zero, printing no result, without enough cards, without the
program, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "drake_ddp_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str):
    """(benchmark, cell, configuration, traffic, limits) of a workload."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return bench, cell, cfg, traffic, limits


def cell_metrics(bench: Dict, workload: str, trace: bool) -> List[Dict]:
    """The metrics a run of this cell reports: its end-to-end metrics, or
    with a trace its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    """``portbench/metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def measure(args, bench, cell, cfg, traffic, limits, dev) -> Dict:
    """Set up, run the window, trace, check; the result record.  On a CPU
    ``dev`` (the tests' tiny cells) the program runs its plain versions
    and nothing is timed on a card."""
    import torch

    from portbench import check
    from portbench.program import Program
    from portbench.tracing import Stretch, traced

    card = dev.type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    # set-up's parts, each ended on the clock of the process's start
    parts = dict(getattr(args, "setup_parts_s", {}))
    parts["imports"] = time.perf_counter() - T_START
    program = Program()
    program.build_kernels(cfg["kernels"])
    if card:
        torch.cuda.init()
    sync()
    parts["kernels"] = time.perf_counter() - T_START
    driver_mod = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}")
    drv = driver_mod.Driver(program, cfg, traffic, args.seed, dev)
    sync()
    parts["system"] = time.perf_counter() - T_START
    drv.warm_up()
    sync()
    setup_s = parts["warm_up"] = time.perf_counter() - T_START

    timer = program.PhaseTimer() if args.trace else None
    program.zero_counters()
    times = []
    sync()
    t0 = t1 = time.perf_counter()
    while t1 - t0 < args.seconds:
        a = time.perf_counter()
        drv.step(timer)
        sync()
        t1 = time.perf_counter()
        times.append(t1 - a)
    window_s = t1 - t0
    summary = drv.summary()
    run = SimpleNamespace(
        kind=drv.kind, cfg=cfg, traffic=traffic, shapes=drv.shapes(),
        setup_s=setup_s, window_s=window_s, step_s=times, summary=summary,
        counters=program.counters(), phases_ms={}, counts={}, stretch=None)
    if timer is not None:
        run.phases_ms = timer.totals_ms()
        run.counts = dict(timer.counts)
        run.stretch = Stretch()
        with traced(run.stretch):
            drv.trace_step()
    memory_peak = torch.cuda.max_memory_allocated() if card else 0

    # the check, once the window has closed and the program's state is
    # freed but its outputs
    drv.release()
    if card:
        torch.cuda.empty_cache()
    ref = check.Reference(cfg, dev)
    readings = drv.readings(ref)
    judged = check.judge(readings, limits["numbers"])
    run.readings = readings

    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if card else "cpu",
              "kind": torch.cuda.get_device_name(dev) if card else "cpu",
              "count": cell["chips"], "memory_peak_bytes": memory_peak}
    out = {"correct": check.passed(judged),
           "attempted": summary["attempted"], "failed": summary["failed"],
           "metrics": metrics, "device": device}
    if run.stretch is not None:
        device.update(busy_s=run.stretch.busy_s,
                      window_s=run.stretch.window_s)
        out["breakdown"] = {
            "device_ops": [list(kv) for kv in run.stretch.device_ops],
            "idle_gaps": [list(kv) for kv in run.stretch.idle_gaps]}
    # what the log shows besides: the window's work and every reading
    print(json.dumps({"window": {
        "setup_parts_s": parts, "seconds": window_s, "steps": len(times), "summary": {
            k: v for k, v in summary.items() if not isinstance(v, list)},
        "counters": run.counters, "phases_ms": run.phases_ms,
        "counts": run.counts, "readings": readings}}), file=sys.stderr)
    out["checks"] = judged
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, cfg, traffic, limits = load_cell(args.workload)

    import torch
    args.setup_parts_s = {"torch": time.perf_counter() - T_START}
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    args.setup_parts_s["cuda"] = time.perf_counter() - T_START
    out = measure(args, bench, cell, cfg, traffic, limits,
                  torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 4
    emit(out)
    return 0


def emit(out: Dict) -> None:
    """The check's numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard
    output."""
    for name, v in out["checks"].items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
