"""Readings of the check over many seeds in one process, for the
program and for the control, to set the check's limits from.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
        --steps <resolves or batches per seed> [--control-seeds <k>] \\
        [--out <file.jsonl>]

Per seed: the cell's traffic for ``--steps`` resolves (or batches) from
that seed's start, then the check's readings of what the program produced
and of the control (the reference in the program's place one precision
below the configuration's: ``portbench.check``), on the same checked
trajectories (the control on the first ``--control-seeds`` seeds only).
One JSON line per seed and side.  The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import check
    from portbench.program import Program
    from portbench.run import load_cell

    _, cell, cfg, traffic, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    program = Program()
    program.build_kernels(cfg["kernels"])
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ref = check.Reference(cfg, dev)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        drv = mod.Driver(program, cfg, traffic, seed, dev)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            drv.step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        sides = ("program", "control")[:2 if i < args.control_seeds else 1]
        for side in sides:
            t1 = time.perf_counter()
            r = drv.readings(ref, control=side == "control")
            line = {"workload": cell["name"], "seed": seed, "side": side,
                    "steps": args.steps, "run_s": secs,
                    "check_s": time.perf_counter() - t1, "readings": r}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
        del drv
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
