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
- ``default_noise_1e-7`` to ``default_noise_1e-3``, ``lane_f32_noise_1e-7``,
  ``lane_f32_noise_1e-5``, ``lane_f64_noise_1e-5``: the default route, or
  the plain float32 or float64 one, with such noise;
- ``megajac_root``: the root-seeded megajac, linearized at megaroll's own
  next states (``root_seed=True``), and ``megajac_root_noise_1e-7``;
- ``lane_f32_root_f64``: the plain float32 root-seeded lane Jacobian at
  the float64 step's roots (the plain lane step in float64 from the
  float32 inputs, megajac's own Newton precision), and its
  ``_noise_1e-7`` draws;
- ``swap_<group>_noise_1e-7`` (an arm's example): the default route's
  Jacobian with one group of entries taken from the plain float32 lane
  Jacobian of the same call, then the noise: rows ``arm_q``,
  ``ball_quat``, ``ball_pos``, ``arm_v``, ``ball_v`` (the free ball's
  quaternion, position, and velocity: ``ball_w`` angular, ``ball_vl``
  linear), columns ``cols_q``, ``cols_v``, ``cols_u``, ``cols_arm_v``,
  ``cols_ball_v``, or a block ``<rows>_x_cols_<columns>``;
- ``lane_f64_ginv32``, ``lane_f64_D32`` (and their ``_noise_1e-7``
  draws): ``lane_f64`` with one piece computed in float32 from its
  float64 inputs: G^-1, or the contact force Jacobian D (in the Newton
  and in G).

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
          "lane_f32_root_f64", "lane_f32_root_f64_noise_1e-7",
          "lane_f32_noise_1e-5", "lane_f64_noise_1e-5")
# groups of Jacobian entries of an arm with a free ball (swap routes):
# (start, stop) of the rows, or of the columns of (fx | fu), by the
# model's (nq, nv); the ball's free joint comes last (quaternion and
# position, then angular and linear velocity)
SWAP_ROWS = {
    "arm_q": lambda nq, nv: (0, nq - 7),
    "ball_quat": lambda nq, nv: (nq - 7, nq - 3),
    "ball_pos": lambda nq, nv: (nq - 3, nq),
    "arm_v": lambda nq, nv: (nq, nq + nv - 6),
    "ball_v": lambda nq, nv: (nq + nv - 6, nq + nv),
    "ball_w": lambda nq, nv: (nq + nv - 6, nq + nv - 3),
    "ball_vl": lambda nq, nv: (nq + nv - 3, nq + nv),
}
SWAP_COLS = {
    "q": lambda nq, nv: (0, nq),
    "v": lambda nq, nv: (nq, nq + nv),
    "u": lambda nq, nv: (nq + nv, None),
    "arm_v": lambda nq, nv: (nq, nq + nv - 6),
    "ball_v": lambda nq, nv: (nq + nv - 6, nq + nv),
}
SWAP_GROUPS = (tuple(SWAP_ROWS) + tuple(f"cols_{c}" for c in SWAP_COLS)
               + tuple(f"{r}_x_cols_{c}" for r in SWAP_ROWS
                       for c in SWAP_COLS))
ROUTES += tuple(f"swap_{g}_noise_1e-7" for g in SWAP_GROUPS)
# the plain float64 lane Jacobian with one piece computed in float32 from
# its float64 inputs: G^-1, or the force Jacobian D (the Newton's and G's)
F32_PIECES = ("ginv32", "D32")
ROUTES += tuple(f"lane_f64_{p}{n}" for p in F32_PIECES
                for n in ("", "_noise_1e-7"))
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
    elif base.startswith("lane_f64_") and base[9:] in F32_PIECES:
        jac = f32_piece(system, base[9:])
    elif base.startswith("swap_"):
        jac = swapped(system, base[len("swap_"):])
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


def f32_piece(system, piece):
    """The plain cold lane Jacobian in float64 from the float32 inputs,
    ``piece`` (F32_PIECES) computed in float32 from its float64 inputs
    and cast back: ``(x, u) -> (fx, fu)`` float32."""
    import torch
    from drake_ddp_tpu_torch.multibody import lanejac
    name = {"ginv32": "inv_small_T",
            "D32": "_contact_forces_implicit_T"}[piece]
    full = getattr(lanejac, name)
    cast = lambda t, dt: (t.to(dt) if torch.is_tensor(t) else
                          tuple(cast(a, dt) for a in t)
                          if type(t) is tuple else t)

    def low(*a, **k):
        out = full(*cast(a, torch.float32),
                   **{key: cast(v, torch.float32) for key, v in k.items()})
        return cast(out, torch.float64)

    # D32: the force stays float64, its Jacobian D is the float32 one
    patch = ((lambda *a, **k: (full(*a, **k)[0], low(*a, **k)[1]))
             if piece == "D32" else low)
    lane = system.lane_jac_fn

    def jac(x, u):
        setattr(lanejac, name, patch)
        try:
            return tuple(J.float() for J in lane(x.double(), u.double()))
        finally:
            setattr(lanejac, name, full)
    return jac


def swapped(system, group):
    """The default route's cold Jacobian ``(x, u) -> (fx, fu)`` with the
    entries of ``group`` (SWAP_GROUPS: a row group, ``cols_`` a column
    group, or ``<rows>_x_cols_<cols>`` their block) taken from the plain
    float32 lane Jacobian of the same inputs."""
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac_for_system
    model = system.params[0]
    rows, _, cols = group.partition("cols_")
    rows = rows.removesuffix("_x_")
    span = lambda table, key: (slice(*table[key](model.nq, model.nv))
                               if key else slice(None))
    block = (span(SWAP_ROWS, rows), span(SWAP_COLS, cols))
    kernel, plain = megajac_for_system(system, root_seed=False), \
        system.lane_jac_fn

    def jac(x, u):
        n = x.shape[0]
        J, P = (torch.cat(f(x, u), dim=1) for f in (kernel, plain))
        J = J.clone()
        J[block] = P[block]
        return J[:, :n].contiguous(), J[:, n:].contiguous()
    return jac


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
