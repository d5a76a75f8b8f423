#!/usr/bin/env python
"""The JAX package's arm side task under seeded Jacobian noise.

    python tools/arm_chaos_jax.py [--example panda_fr3|kinova_gen3]
                                  [--draws 10] [--rel 1e-7] [--T 0.5]
                                  [--contact-iters 8] [--step-noise REL]

Runs ``build_solver(Config())`` of the example (the side task) once as
it is and then once per draw with every dense Jacobian entry multiplied
by (1 + rel z), z standard normal from a key folded from the draw and
the trajectory, and prints one JSON line per run: iterations, cost, how
far the ball moved sideways (``ball_dy``) and whether the run meets the
goldens' task checks of tests/test_robot_examples.py (``met``), then a
summary line.  One compiled solve serves every run (the draw and the
noise size are arguments).  This is the reference side of the arm draws
that the port's ``chip_smoke.py`` makes on the card (``scenario_panda``,
``scenario_kinova``): how often the JAX solve itself stalls under the
same size of perturbation.  ``--step-noise REL`` also perturbs every
step of the linesearch rollouts (not the derivatives) by a fixed,
deterministic function of the step's input, each output entry times
(1 + REL sin(...)) with phases that change completely when the input
moves by 1e-4: a model of a step whose rounding differs, for asking
how the share of runs that meet the task moves with the rollout's own
error.  CPU only.
"""

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DY = {"panda_fr3": 0.09, "kinova_gen3": 0.10}   # the goldens' ball checks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--example", default="panda_fr3", choices=sorted(DY))
    ap.add_argument("--draws", type=int, default=10)
    ap.add_argument("--rel", type=float, default=1e-7)
    ap.add_argument("--T", type=float, default=None)
    ap.add_argument("--contact-iters", type=int, default=None)
    ap.add_argument("--step-noise", type=float, default=0.0)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from drake_ddp_tpu.solver import ilqr as il
    from drake_ddp_tpu.solver import keypoints as kp
    from drake_ddp_tpu.solver.ilqr import solve_ilqr

    ex = importlib.import_module(f"drake_ddp_tpu.examples.{args.example}")
    over = {k: v for k, v in (("T", args.T),
                              ("contact_iters", args.contact_iters))
            if v is not None}
    cfg = dataclasses.replace(ex.Config(), scenario="side", verbose=False,
                              **over)
    ilqr = ex.build_solver(cfg)
    x0, _ = ex.scenario_states(cfg)

    dense, noise = kp._dense_jacobians, {}

    def noisy_dense(step, x, u, chunk=None):
        fx, fu = dense(step, x, u, chunk)
        key = jax.random.fold_in(jax.random.PRNGKey(13), noise["draw"])
        key = jax.random.fold_in(key, jax.lax.bitcast_convert_type(
            jnp.sum(x).astype(jnp.float32), jnp.int32))
        kx, ku = jax.random.split(key)
        z = lambda k, a: jax.random.normal(k, a.shape, a.dtype)
        return (fx * (1 + noise["rel"] * z(kx, fx)),
                fu * (1 + noise["rel"] * z(ku, fu)))

    n, m = ilqr.n, ilqr.m
    rs = np.random.default_rng(7)
    A = jnp.asarray(rs.standard_normal((n, n)) * 1e4, jnp.float32)
    Bm = jnp.asarray(rs.standard_normal((m, n)) * 1e4, jnp.float32)

    def rough(step):
        def f(x, u):
            y = step(x, u)
            return y * (1 + args.step_noise * jnp.sin(x @ A + u @ Bm))
        return f

    linesearch = il._linesearch

    def solve(prob, draw, rel):
        noise.update(draw=draw, rel=rel)
        return solve_ilqr(ilqr.system, ilqr.config, prob)

    kp._dense_jacobians = noisy_dense
    if args.step_noise:
        il._linesearch = lambda step, *a: linesearch(rough(step), *a)
    try:
        fn = jax.jit(solve)
        runs = []
        for d in range(args.draws + 1):
            t0 = time.perf_counter()
            sol = jax.device_get(fn(ilqr._problem(), jnp.int32(d),
                                    jnp.float32(args.rel if d else 0.0)))
            x = np.asarray(sol.x).T
            dy = float(x[12, -1] - x0[12])
            met = bool(dy > DY[args.example]
                       and abs(x[13, -1] - 0.1) < 0.03
                       and float(x[13].min()) > 0.08)
            run = {"draw": d, "rel": args.rel if d else 0.0,
                   "iterations": int(sol.iterations),
                   "cost": float(sol.cost), "ball_dy": dy, "met": met,
                   "diverged": bool(sol.diverged),
                   "seconds": time.perf_counter() - t0}
            runs.append(run)
            print(json.dumps(run), flush=True)
    finally:
        kp._dense_jacobians, il._linesearch = dense, linesearch
    costs = sorted(r["cost"] for r in runs)
    print(json.dumps({"example": args.example, "config": over or "Config()",
                      "step_noise": args.step_noise,
                      "runs": len(runs),
                      "runs_meeting_task": sum(r["met"] for r in runs),
                      "median_cost": costs[len(costs) // 2]}))


if __name__ == "__main__":
    main()
