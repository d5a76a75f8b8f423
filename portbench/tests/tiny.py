"""A cell of the benchmark cut to a size the CPU runs in seconds, through
the harness's own set-up, window, check and result, on the program's
plain route (its kernel wrappers run their plain versions on CPU
tensors).  For the tests; a CPU run is never a measurement.

    python -m portbench.tests.tiny <workload> [seconds]

prints the harness's result as the last line of standard output, and on
standard error the top-level names of the loaded modules that are JAX or
the JAX package.
"""

from __future__ import annotations

import copy
import json
import sys
import types


def tiny_cell(workload: str):
    """(bench, cell, cfg, traffic, limits) of ``workload`` at N 10, two
    iterations, three lanes or starts, and no kernel build."""
    from portbench.run import load_cell
    bench, cell, cfg, traffic, limits = load_cell(workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["kernels"] = []
    cfg["N"] = 10
    cfg["solver"]["max_iters"] = 2
    if traffic["driver"] == "mpc_chain":
        traffic.update(batch=3, warmup_resolves=1)
    else:
        traffic.update(starts=3, warmup_max_iters=1)
    return bench, cell, cfg, traffic, limits


def run_tiny(workload: str, seconds: float = 0.5, seed: int = 2 ** 31 + 5,
             trace: int = 0):
    """The harness's result record of a tiny run on the CPU."""
    import torch

    from portbench import run
    torch.set_num_threads(1)
    bench, cell, cfg, traffic, limits = tiny_cell(workload)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return run.measure(args, bench, cell, cfg, traffic, limits,
                       torch.device("cpu"))


def main(argv) -> int:
    from portbench import run
    out = run_tiny(argv[1], float(argv[2]) if len(argv) > 2 else 0.5)
    run.emit(out)
    print(json.dumps({"forbidden": run.forbidden_modules()}),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
