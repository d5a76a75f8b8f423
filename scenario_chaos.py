#!/usr/bin/env python3
"""How far a per-scenario example run moves with its Jacobian.

    python3 scenario_chaos.py [--device cuda|cpu] [--route NAME]
                              [--example mini_cheetah|panda_fr3|kinova_gen3]
                              [--seed S] [--draws K]
                              [--rollout fused|megastep|plain]

Runs the example's ``run()`` at its ``Config()`` (the mini cheetah, the
default: one solve and one resolve, N 50, contact_iters 4; the arms:
the side task, N 50, contact_iters 8) once for each Jacobian route in
ROUTES (or the one named) and prints one JSON line per route with each
solve's iterations and cost (for an arm also how far the ball moved
sideways, ``ball_dy``, and whether the run meets the JAX goldens' task
checks, ``met``):

- ``default``: the system's own route (on the card the cold megajac; on
  the CPU its plain version, the float32 lane Jacobian);
- ``lane_f32``: the plain lane Jacobian (``deriv_kernel="lane"``);
- ``lane_f64``: the plain lane Jacobian computed in float64 from the
  float32 inputs, megajac's own precision;
- ``lane_f64_noise_1e-7``, ``lane_f64_noise_1e-6``: that with relative
  noise of that size on every entry, seeded by ``--seed`` (13);
- ``default_noise_1e-7`` to ``default_noise_1e-3``, ``lane_f32_noise_1e-7``:
  the default route, or the plain float32 one, with such noise;
- ``megajac_root``: the root-seeded megajac, linearized at megaroll's own
  next states (``root_seed=True``), and ``megajac_root_noise_1e-7``;
- ``lane_f32_root_f64``: the plain float32 root-seeded lane Jacobian at
  the float64 step's roots (the plain lane step in float64 from the
  float32 inputs, megajac's own Newton precision), and its
  ``_noise_1e-7`` draws.

With ``--draws K`` a noise route runs K times, seeded ``--seed`` to
``--seed`` + K - 1, and a summary line follows its runs (for an arm the
runs that met the task).  ``--rollout`` names the linesearch rollout of
a multibody system: ``fused`` (megaroll, the default), ``megastep`` (the
step kernel once per step) or ``plain`` (the plain lane step).

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
          "lane_f64_noise_1e-6", "default_noise_1e-7", "default_noise_1e-6",
          "lane_f32_noise_1e-7", "default_noise_1e-5", "default_noise_1e-4",
          "default_noise_1e-3", "megajac_root", "megajac_root_noise_1e-7",
          "lane_f32_root_f64", "lane_f32_root_f64_noise_1e-7")
# routes on the root-seeded Jacobian, at the rollout's own next states
ROOT_ROUTES = ("megajac_root", "lane_f32_root_f64")
ROLLOUTS = ("fused", "megastep", "plain")
EXAMPLES = ("mini_cheetah", "panda_fr3", "kinova_gen3")


DY = {"panda_fr3": 0.09, "kinova_gen3": 0.10}   # the goldens' ball checks


def wrapped(system, route, device, seed=13):
    """``system`` with the lane Jacobian that ``route`` names (the
    root-seeded one for a ``ROOT_ROUTES`` route)."""
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac_for_system
    base, _, noise = route.partition("_noise_")
    root = base in ROOT_ROUTES
    if base == "lane_f64":
        lane = system.lane_jac_fn
        jac = lambda x, u: tuple(J.float()
                                 for J in lane(x.double(), u.double()))
    elif base == "lane_f32_root_f64":
        lane_root, step = system.lane_jac_root_fn, system.lane_step_fn
        jac = lambda x, u, x_next: lane_root(
            x, u, step(x.double(), u.double()).float())
    elif base == "lane_f32" and noise:
        jac = system.lane_jac_fn
    elif noise:
        jac = megajac_for_system(system, root_seed=root)
    else:
        return system
    if noise:
        gen = torch.Generator(device=device).manual_seed(seed)
        clean, rel = jac, float(noise)
        jac = lambda *a: tuple(J * (1 + rel * torch.randn(
            J.shape, generator=gen, device=J.device, dtype=J.dtype))
            for J in clean(*a))
    field = "lane_jac_root_fn" if root else "lane_jac_fn"
    return dataclasses.replace(system, **{field: jac})


def run_route(route, device, example="mini_cheetah", seed=13,
              rollout="fused"):
    import importlib
    from drake_ddp_tpu_torch.solver import batched, ilqr
    ex = importlib.import_module(f"drake_ddp_tpu_torch.examples.{example}")
    build, sols = ex.build_system, []
    ex.build_system = lambda cfg, device: (
        lambda sm: (wrapped(sm[0], route, device, seed), sm[1]))(
            build(cfg, device=device))
    rollout_for = batched._rollout_for
    batched._rollout_for = lambda system, kernel: rollout_for(
        system, rollout if kernel == "fused" else kernel)
    routes = ilqr.scenario_routes
    if route.partition("_noise_")[0] in ROOT_ROUTES:
        ilqr.scenario_routes = lambda system, deriv_kernel=None: routes(
            system, deriv_kernel, root_seed=True)
    try:
        t0 = time.perf_counter()
        states, _, _, _ = ex.run(
            ex.Config(verbose=False), device=device,
            deriv_kernel=(None if route in ("default", "megajac_root")
                          else "lane"),
            on_solve=sols.append)
        secs = time.perf_counter() - t0
    finally:
        ex.build_system, batched._rollout_for = build, rollout_for
        ilqr.scenario_routes = routes
    out = {"route": route, "rollout": rollout, "device": device,
           "example": example,
           "iterations": [int(s.iterations) for s in sols],
           "costs": [float(s.cost) for s in sols],
           "diverged": [bool(s.diverged) for s in sols], "seconds": secs}
    if example != "mini_cheetah":
        x0, _ = ex.scenario_states(ex.Config())
        out["ball_dy"] = float(states[12, -1] - x0[12])
        out["met"] = bool(out["ball_dy"] > DY[example]
                          and abs(states[13, -1] - 0.1) < 0.03
                          and float(states[13].min()) > 0.08)
    if "_noise_" in route:
        out["seed"] = seed
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--route", choices=ROUTES)
    ap.add_argument("--example", default="mini_cheetah", choices=EXAMPLES)
    ap.add_argument("--seed", type=int, default=13,
                    help="the noise routes' seed")
    ap.add_argument("--draws", type=int, default=1,
                    help="runs of a noise route, one seed each")
    ap.add_argument("--rollout", default="fused", choices=ROLLOUTS)
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
        k = args.draws if "_noise_" in route else 1
        runs = []
        for i in range(k):
            runs.append(run_route(route, args.device, args.example,
                                  args.seed + i, args.rollout))
            print(json.dumps(runs[-1]), flush=True)
        if k > 1:
            print(json.dumps({"route": route, "rollout": args.rollout,
                              "example": args.example, "draws": k,
                              "seeds": [args.seed, args.seed + k - 1],
                              "met": sum(r.get("met", False) for r in runs)}),
                  flush=True)


if __name__ == "__main__":
    main()
