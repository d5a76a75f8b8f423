#!/usr/bin/env python3
"""The two Riccati routes of the port timed against each other on the card.

    python3 riccati_routes.py [--passes 3] [--sweeps 5]

Runs ``chip_smoke.riccati_route_rows`` (the sequential sweep and the
associative scan on seeded float32 sweeps over batch B, horizon N and
state size n: the cheetah's n 37, m 12 and the acrobot's n 4, m 1)
``--passes`` times, each pass drawing new problems, and prints one JSON
line per (n, N, B) with the median ms per sweep of each route over the
passes, the smallest and largest, and the median speedup of the scan,
then the card's name and power limit.  Needs a CUDA card.
"""

import argparse
import json
import statistics
import sys

import chip_smoke


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--sweeps", type=int, default=5,
                    help="timed sweeps per route and pass (1 at the "
                         "largest sizes)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("riccati_routes: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import drake_ddp_tpu_torch  # noqa: F401  (full-f32 matmuls)
    gen = torch.Generator(device="cuda").manual_seed(31)
    passes = [chip_smoke.riccati_route_rows(gen, args.sweeps)
              for _ in range(args.passes)]
    for rows in zip(*passes):
        seq = [r["sequential_ms"] for r in rows]
        par = [r["parscan_ms"] for r in rows]
        print(json.dumps({
            **{k: rows[0][k] for k in ("n", "m", "N", "B")},
            "sequential_ms_median": statistics.median(seq),
            "sequential_ms_range": [min(seq), max(seq)],
            "parscan_ms_median": statistics.median(par),
            "parscan_ms_range": [min(par), max(par)],
            "speedup_median": statistics.median(
                r["speedup"] for r in rows),
            "rel_err_max": max(r["rel_err"] for r in rows)}), flush=True)
    print(chip_smoke.card_line())


if __name__ == "__main__":
    main()
