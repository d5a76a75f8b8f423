#!/usr/bin/env python3
"""How far the per-scenario mini-cheetah run moves with its Jacobian.

    python3 scenario_chaos.py [--device cuda|cpu] [--route NAME]

Runs the mini-cheetah example's ``run()`` at its ``Config()`` (one solve
and one resolve, N 50, contact_iters 4) once for each Jacobian route in
ROUTES (or the one named) and prints one JSON line per route with each
solve's iterations and cost:

- ``default``: the system's own route (on the card the cold megajac; on
  the CPU its plain version, the float32 lane Jacobian);
- ``lane_f32``: the plain lane Jacobian (``deriv_kernel="lane"``);
- ``lane_f64``: the plain lane Jacobian computed in float64 from the
  float32 inputs, megajac's own precision;
- ``lane_f64_noise_1e-7``, ``lane_f64_noise_1e-6``: that with seeded
  relative noise of that size on every entry;
- ``default_noise_1e-6``: the default route with such noise.

Prints the device first (on the card its name and power limit).  The
default device is the card, which must then be present.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROUTES = ("default", "lane_f32", "lane_f64", "lane_f64_noise_1e-7",
          "lane_f64_noise_1e-6", "default_noise_1e-6")


def wrapped(system, route, device):
    """``system`` with the lane Jacobian that ``route`` names."""
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac_for_system
    base, _, noise = route.partition("_noise_")
    if base == "lane_f64":
        lane = system.lane_jac_fn
        jac = lambda x, u: tuple(J.float()
                                 for J in lane(x.double(), u.double()))
    elif noise:
        jac = megajac_for_system(system, root_seed=False)
    else:
        return system
    if noise:
        gen = torch.Generator(device=device).manual_seed(13)
        clean, rel = jac, float(noise)
        jac = lambda x, u: tuple(J * (1 + rel * torch.randn(
            J.shape, generator=gen, device=J.device, dtype=J.dtype))
            for J in clean(x, u))
    return dataclasses.replace(system, lane_jac_fn=jac)


def run_route(route, device):
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    build, sols = mc.build_system, []
    mc.build_system = lambda cfg, device: (
        lambda sm: (wrapped(sm[0], route, device), sm[1]))(
            build(cfg, device=device))
    try:
        t0 = time.perf_counter()
        mc.run(mc.Config(verbose=False), device=device,
               deriv_kernel=None if route == "default" else "lane",
               on_solve=sols.append)
        secs = time.perf_counter() - t0
    finally:
        mc.build_system = build
    return {"route": route, "device": device,
            "iterations": [int(s.iterations) for s in sols],
            "costs": [float(s.cost) for s in sols],
            "diverged": [bool(s.diverged) for s in sols], "seconds": secs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--route", choices=ROUTES)
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scenario_chaos: no CUDA device; pass --device cpu",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import drake_ddp_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    if args.device == "cuda":
        import chip_smoke
        print(chip_smoke.card_line(), flush=True)
    else:
        print("cpu", flush=True)
    for route in ([args.route] if args.route else ROUTES):
        print(json.dumps(run_route(route, args.device)), flush=True)


if __name__ == "__main__":
    main()
