#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``drake_ddp_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card (megastep, megaroll,
and megajac root-seeded and cold-Newton, with its primal's team-size
sweep and the time of each of its two kernels), checks a small MPC chain
against the plain float64 chain on the CPU, and drives the flagship
batched mini-cheetah MPC (n 37, m 12, N 50, 16 contacts, contact_iters
8, setInterval-8, ls_parallel 2, max_iters 8, batch 256) through
``mpc_solve_batched`` with the fused megaroll rollout and the megajac
derivatives; then one entry solve each with the plain lane Jacobian
(held to the megajac one by the loose chain pin over the batch, beside
a noise control, with megajac checked on that solve's own Jacobian
inputs), with the cold-Newton megajac, and with one megastep launch per
horizon step.  Then scenario data parallelism and playback: the
flagship cut (an entry solve and two resolves) through ``batched_mpc``
over ``scenario_mesh()`` against a direct ``mpc_solve_batched`` bit for
bit, its two halves each in a host thread of its own (the multi-card
path's threads, both on the one card) against the halves run in order,
the same problems split over two processes on the one card under gloo
(``--worker`` runs of this script) with their all-reduced stats, every
lane bit for bit that of the 256-lane run,
NCCL at world size 1 and its refusal of two ranks on one card, and the
mini-cheetah example's ``run()`` recorded by an ``MPCStream``, its frames
on the card against the CPU's and its HTML player written under
``build/``.  Then the per-scenario path: megaroll and the cold megajac
held and timed at its shapes (8 and 49 lanes, contact_iters 4), the
pendulum and cart-pole examples through
``IterativeLinearQuadraticRegulator`` against the JAX package's goldens,
and the mini-cheetah example's ``run()`` at its ``Config()`` (one solve
and one resolve, N 50) on megaroll and the cold megajac, with megajac
held on every Jacobian call of the same run with the plain Jacobian,
and its chain held by distribution: the median final cost over seeded
1e-7 Jacobian-noise draws of the megajac route against the plain float64
route's, with routes under larger noise printed beside as controls.
Then the manipulation slice: the Panda and Kinova examples' ``run()``
at their ``Config()`` (side task, N 50, 69 and 127 contacts:
sphere-ground, arm-ball sphere-sphere, pad-ball sphere-box, pad-ground
box face) on megaroll and the cold megajac, every Jacobian call held to
the plain float64 one, the Kinova run held to the JAX goldens' ball
checks (the Panda's printed: the task's margin decides it, PERF.md) and a
run of each on the plain float32 Jacobian held to them, the Panda's
default route under 40 seeded Jacobian-noise draws with the count that
meets the checks printed; and each kernel held
and timed on the Panda, the Kinova with its pads as box-face quadrature
(141 contacts) and a small model with sphere-world pairs.  Then the
classic tasks: the cart-pole wall's ``run()`` at its ``Config()`` (8
starts of one batched solve on megaroll and the cold megajac; a
prismatic cart, a rigid world box) held to the JAX golden's task checks,
and the three kernels held and timed on that model at the inputs of the
run's last megaroll and megajac calls (64 and 792 lanes); the acrobot
(N 750) with the associative-scan Riccati and the sequential sweep
against the JAX golden, its MPC chain (``mpc_solve``, 51 solves) against
JAX's own run of it, the pendulum, cart-pole and acrobot with
``method="sqp"`` (direct transcription) against JAX's costs, and the two
Riccati routes alone over batch, horizon and state size.  Then the
keypoint and model-file slice: adaptiveJerk and iterativeError (with and
without a binding keypoint budget) on seeded cheetah trajectories,
root-seeded at B 256 and cold at B 1, every mask held to a host
recomputation, the lazy bisection to its replay on a dense megajac stack
bit for bit, every megajac call to the plain float64 Jacobian; the
cheetah's and the Kinova's ``run()`` with dynamic keypoints beside
setInterval-8 (launches per derivative call or bisection level, lanes
per mask, the Kinova's task); a cut of the flagship with adaptiveJerk
beside setInterval-8; the cart-pole from ``cart_pole.sdf`` with no
contact model on megastep, megaroll and the cold megajac and its
swing-up, and an OBJ-covered arm from URDF text on megastep.  Last, the
mini-cheetah's ``run()`` with every solve through ``SolveProfiled``
(per-iteration phase times against a CUDA-event bracket of the rounds)
and a ``utils.profiling.trace`` of a solve that must show megaroll and
megajac.  Every phase prints one JSON line; the line before the last lists the
kernels, and the last line is ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero without that line.  Needs a CUDA card; exits 2
without one.  ``chip_smoke.py --worker gloo|nccl <rank> <world> <port>``
is one process of the two-process phase.
"""

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

H100_FP32_FLOPS = 67e12      # FP32 outside the tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12   # HBM3
BATCH = 256
JAC_LANES = 7 * BATCH        # the flagship's derivative call: 7 keypoints
FLAGSHIP_BUDGET_S = 180.0    # wall time the flagship resolves may take

REPO = Path(__file__).resolve().parent


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops, flops=H100_FP32_FLOPS):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# narrowphase operations of one contact row by kind (csrc/lanestep.cuh
# C_SH .. C_BS): sphere-halfspace 15 (distance, penetration, point);
# sphere-box 90 (box frame, clamp, gaps, normal, point); sphere-sphere and
# sphere-world 24 (distance, normal, penetration, point); a box-face
# corner 24 (corner, penetration) and its pair's projected area (25, and
# for a body sphere the direction to it, 13) once per 8 corners, with 12
# more for the corner's distance and normal against a sphere
ROW_OPS = {0: 15, 1: 90, 2: 24 + 25 / 8, 3: 24, 4: 24, 5: 36 + 38 / 8}


def op_counts(kd):
    """Floating-point operations that one lane needs for each part of the
    step at this model's sizes, not what csrc/lanestep.cuh happens to
    execute: each body's ancestor dofs only, each Jacobian column once,
    the symmetric half of the mass matrix, a triangular Cholesky, each
    contact's Jacobian products over its nonzero columns (the dofs of its
    bodies' ancestors), and the unpivoted Gauss-Jordan solves that the
    reference runs, on the columns not yet eliminated."""
    import numpy as np
    from drake_ddp_tpu_torch.multibody.model import ancestor_dof_mask
    model = kd.model
    nb, nv, nu = model.nb, model.nv, model.nu
    T = kd._struct
    anc = ancestor_dof_mask(model) > 0
    na = anc.sum(axis=1)                                  # ancestors/body
    pjc = 15                      # point-Jacobian column: lever, cross, blend
    c = dict(fk=nb * (63 + 45))
    # mass matrix: com and world inertia per body, each ancestor column
    # once (angular 3, linear pjc, I a 15), the symmetric half of the
    # column products (13 each)
    c["mass"] = int(np.sum(108 + na * (3 + pjc + 15)
                           + na * (na + 1) // 2 * 13))
    c["bias"] = (int(np.sum(na * 6 + na * 3 + 90 + na * (pjc + 12)))
                 + nv * 13 + nb * 40 + nu)
    # Crout Cholesky (the dot products of the lower triangle), its
    # square roots and divisions, then two triangular solves
    c["chol"] = (sum(2 * j * (nv - j) for j in range(nv))
                 + nv * (nv + 3) // 2 + 2 * nv * nv + 2 * nv)
    # the Gauss-Jordan inverse of G: each row's factor and the pivot
    # row's remaining left columns and right half, then the diagonal
    c["inv"] = ((nv - 1) * sum(1 + 2 * (nv - k - 1) + 2 * nv
                               for k in range(nv)) + nv * nv)
    c["integ"] = 40
    c["res"] = nv + 2 * nv * nv + 4 * nv                  # M (vp - v) - dt ..
    c["geom"] = c["tau"] = c["with_g"] = c["newton"] = 0
    if T.has_contact:
        c["geom"] = T.ns * 18 + T.nbox * 63
        for ci in range(T.nc):
            a, b = T.c_body_a[ci], T.c_body_b[ci]
            ma = anc[a] if a >= 0 else np.zeros(nv, bool)
            mb = anc[b] if b >= 0 else np.zeros(nv, bool)
            cols = int((ma | mb).sum())                   # nonzero Jc columns
            c["geom"] += (ROW_OPS[T.c_kind[ci]]
                          + int(ma.sum() + mb.sum()) * pjc
                          + int((ma & mb).sum()) * 3)
            c["tau"] += 6 * cols + 60 + 6 * cols          # Jc v, f, Jc' f
            c["with_g"] += 40 + 15 * cols + 6 * cols * cols   # D, D Jc, Jc' E
        gj = (nv - 1) * sum(1 + 2 * (nv - k) for k in range(nv)) + nv
        c["newton"] = T.contact_iters * (
            2 * c["tau"] + c["with_g"] + 2 * c["res"] + 2 * nv * nv + gj
            + 3 * nv)
    return c


def step_ops(kd):
    """Operations one lane's step needs (see op_counts)."""
    c = op_counts(kd)
    return (c["fk"] + c["mass"] + c["bias"] + c["chol"] + c["geom"]
            + c["newton"] + c["integ"])


def jac_ops(kd, root):
    """Operations one lane's Jacobian needs: the primal once (cold: with
    the step's predictor and Newton), G at the root and its inverse; a
    forward-mode tangent at 2 operations per primal operation (a
    product's tangent is two products and a sum, a sum's one sum) for
    each of the nq q-directions through kinematics, mass matrix, bias,
    narrowphase and the residual, and each of the nv v-directions through
    the bias and the residual; dv' = -G^-1 dres for the n x-directions;
    and the integrator's tangent for all n + m directions."""
    c = op_counts(kd)
    nq, nv, nu = kd.model.nq, kd.model.nv, kd.model.nu
    n = nq + nv
    kin = c["fk"] + c["mass"] + c["bias"]
    at_root = c["tau"] + c["with_g"] + c["res"] if c["geom"] else 0
    primal = (kin + c["geom"] + at_root + c["inv"]
              + (0 if root else c["chol"] + c["newton"]))
    q_dirs = nq * 2 * (kin + c["geom"] + c["tau"] + c["res"])
    v_dirs = nv * 2 * (c["bias"] + c["res"])
    return (primal + q_dirs + v_dirs + 2 * n * nv * nv + nu * nv
            + (n + nu) * 2 * c["integ"])


TEAM_SIZES = (32, 64, 128)   # threads per lane tried for megaroll and megajac


def phase_build(specs=None):
    """Kernel libraries (default: every one at its own team size), one
    nvcc each, all started together."""
    from drake_ddp_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    try:
        logs = _cuda.build(specs)
    except RuntimeError as e:
        fail("build", str(e)[-4000:])
    for name, log in logs.items():
        emit({"phase": "build", "kernel": name,
              "seconds": time.perf_counter() - t0,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if re.search(r"registers|spill|Compiling|smem", ln)]})
    return logs


def ptxas_summary(log, kernel):
    """Registers and spill bytes that ptxas reports for ``kernel``."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            block = " ".join(lines[i:i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None,
                    "spill_load_bytes": int(spill.group(2)) if spill else None}
    return {"registers": None, "spill_store_bytes": None,
            "spill_load_bytes": None}


def phase_team_config(logs, kd, L):
    """How megastep and megaroll launch L lanes: threads per lane, lanes
    per block, dynamic shared bytes per block, with ptxas' registers and
    spills."""
    from drake_ddp_tpu_torch.ops import megaroll, megastep
    for name, mod, kernel in (("megastep", megastep, "megastep_kernel"),
                              ("megaroll", megaroll, "megaroll_kernel")):
        emit({"phase": "team_config", "kernel": name, "lanes": L,
              **mod.launch_config(kd, L),
              **ptxas_summary(logs[name], kernel)})


def cheetah(device, contact_iters=8):
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    system, model = mc.build_system(mc.Config(contact_iters=contact_iters),
                                    device=device)
    return mc, system, model


def seeded_states(mc, L, gen, device, dtype):
    """Standing states with jittered velocities and base position, and
    inputs around the standing torques (the lane-step test pattern)."""
    import torch
    x0, _ = mc.initial_and_target(mc.Config())
    x = torch.as_tensor(x0, dtype=torch.float64, device=device)
    x = x[:, None].repeat(1, L)
    x[19:] += 0.2 * torch.randn((18, L), generator=gen, device=device,
                                dtype=torch.float64)
    x[4:7] += 0.01 * torch.randn((3, L), generator=gen, device=device,
                                 dtype=torch.float64)
    u = torch.as_tensor(mc.U_STAND, dtype=torch.float64, device=device)
    u = u[:, None] + 0.5 * torch.randn((12, L), generator=gen,
                                       device=device, dtype=torch.float64)
    return x.to(dtype), u.to(dtype)


def phase_megastep(results):
    import torch
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megastep import megastep
    dev = torch.device("cuda")
    mc, system, model = cheetah(dev)
    kd = kernel_data_for_system(system)
    L = 2 * BATCH                   # C.B lanes, as the flagship launches it
    gen = torch.Generator(device=dev).manual_seed(0)
    x64, u64 = seeded_states(mc, L, gen, dev, torch.float64)
    x32, u32 = x64.float(), u64.float()
    truth = kd.step(x64, u64)
    plain32 = kd.step(x32, u32)
    got = megastep(kd, x32, u32)
    torch.cuda.synchronize()
    e_plain = (plain32.double() - truth).abs().max().item()
    e_kern = (got.double() - truth).abs().max().item()
    err = (got - plain32).abs().max().item()
    ok = math.isfinite(e_kern) and e_kern <= 3.0 * e_plain + 1e-5
    ms = cuda_ms(lambda: megastep(kd, x32, u32), 5)
    plain_ms = cuda_ms(lambda: kd.step(x32, u32), 2)
    n, m = kd.n, kd.m
    b_ms, b_by = bound_ms((2 * n + m) * L * 4, step_ops(kd) * L)
    emit({"phase": "megastep", "ok": ok, "lanes": L,
          "err_kernel_vs_f64": e_kern, "err_plain_f32_vs_f64": e_plain,
          "criterion": "err_kernel <= 3 err_plain + 1e-5",
          "max_abs_err_vs_plain_f32": err, "ms": ms, "plain_ms": plain_ms})
    if not ok:
        fail("megastep", "kernel outside tolerance")
    results["megastep"] = dict(
        name="megastep", route="cuda",
        source="drake_ddp_tpu_torch/csrc/megastep.cu",
        replaces="drake_ddp_tpu/ops/megastep.py:90", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, lanes=L, check=ok)


def rollout_tapes(mc, L, T, gen, device):
    """Seeded closed-loop tapes around the standing torques, float64:
    small feedforward, gain and reference perturbations of the standing
    state."""
    import torch
    x0, u0 = seeded_states(mc, L, gen, device, torch.float64)
    x0[19:] *= 0.25
    n, m = x0.shape[0], u0.shape[0]
    rnd = lambda *s: torch.randn(s, generator=gen, device=device,
                                 dtype=torch.float64)
    U = torch.as_tensor(mc.U_STAND, dtype=torch.float64, device=device)
    u_bar = U[None, :, None] + 0.03 * rnd(T, m, L)
    kappa = 0.03 * rnd(T, m, L)
    K = 0.005 * rnd(T, m, n, L)
    x_bar = x0[None] + 0.01 * rnd(T, n, L)
    eps = torch.rand(L, generator=gen, device=device, dtype=torch.float64)
    return x0, eps, u_bar, kappa, K, x_bar


CROSSING = 1e-4   # a step error this far above the f32 rounding level


def rollout_step_check(kd, tapes64, xs, us):
    """Holds a float32 rollout (xs, us) of the tapes to the plain versions
    step by step, from its own states: at every step t and lane, us[t]
    against the policy u_bar - eps kappa - K (x - x_bar) at the rollout's
    state before step t, and xs[t] against the plain step from that state
    and us[t], each in float64 (the truth) and in float32 (the yardstick).

    A free-running comparison is no test: at a few lane-steps in 10^4 the
    damped-Newton half-step test of the contact solve flips under f32
    rounding, and from there every f32 rollout of that lane is O(1) off.
    From its own states the rollout is held at every lane-step to
    err <= 3 max err_plain_f32 + 1e-5 (per step, the max over lanes;
    inputs and policy likewise), except at lane-steps where its step error
    exceeds CROSSING, a flip of that test: at most 2 k + 4 of those where
    the plain f32 step has k, in all and on the lane with the most.  A
    lane-step where the plain step crossed and the kernel's error is over
    the bound but under CROSSING is a flip whose jump is smaller than the
    mark: it counts as a kernel crossing too, inside the same budget, and
    is reported (``crossings_kernel_below_mark``).

    A lane whose tapes are not finite (gains left NaN by a failed Cholesky
    solve, a candidate the linesearch rejects) has no float64 truth from
    there on: at every lane-step the kernel's state and input must be
    non-finite exactly where the float64 ones are, and the finite ones
    are held as above (``lane_steps_not_finite``)."""
    import torch
    x0, eps, u_bar, kappa, K, x_bar = tapes64
    T, n, L = xs.shape
    prev = torch.cat([x0[None].float(), xs[:-1]])                 # (T, n, L)

    def policy(dtype):
        c = lambda a: a.to(dtype)
        return (c(u_bar) - c(eps)[None, None] * c(kappa)
                - torch.sum(c(K) * (c(prev) - c(x_bar))[:, None], dim=2))

    fold = lambda a: a.permute(1, 0, 2).reshape(a.shape[1], T * L)
    unfold = lambda a: a.reshape(a.shape[0], T, L).permute(1, 0, 2)
    truth = unfold(kd.step(fold(prev).double(), fold(us).double()))
    plain = unfold(kd.step(fold(prev).contiguous(), fold(us).contiguous()))
    u64 = policy(torch.float64)
    finite = lambda a: torch.isfinite(a).all(dim=1)               # (T, L)
    fin_x, fin_u = finite(truth), finite(u64)
    same_finite = bool(torch.equal(finite(xs), fin_x)
                       and torch.equal(finite(us), fin_u))
    on = lambda fin, a: torch.where(fin, a, 0.0)
    e_k = on(fin_x, (xs.double() - truth).abs().amax(dim=1))      # (T, L)
    e_p = on(fin_x, (plain.double() - truth).abs().amax(dim=1))
    cross_p = e_p > CROSSING
    bound = 3.0 * torch.where(cross_p, 0.0, e_p).amax(dim=1) + 1e-5   # (T,)
    below = cross_p & (e_k <= CROSSING) & (e_k > bound[:, None])
    cross_k = (e_k > CROSSING) | below
    held = torch.where(cross_k, 0.0, e_k)
    eu_k = on(fin_u, (us.double() - u64).abs().amax(dim=1)).amax(dim=1)
    eu_p = on(fin_u, (policy(torch.float32).double() - u64).abs()
              .amax(dim=1)).amax(dim=1)                           # (T,)
    n_k, n_p = int(cross_k.sum()), int(cross_p.sum())
    lane_k = int(cross_k.sum(dim=0).max())
    lane_p = int(cross_p.sum(dim=0).max())
    ok = bool(same_finite
              and (held <= bound[:, None]).all()
              and (eu_k <= 3.0 * eu_p + 1e-5).all()
              and n_k <= 2 * n_p + 4 and lane_k <= 2 * lane_p + 4)
    d = on(fin_x, (xs - plain).abs().amax(dim=1))
    margin = held - bound[:, None]
    t_w, l_w = divmod(int(margin.argmax()), L)
    return ok, {
        "criterion": "from the kernel's own states, per step: max over "
                     "lanes err_kernel <= 3 max err_plain_f32 + 1e-5 (states"
                     " and inputs vs float64), except lane-steps crossing a "
                     "contact-solve flip (error > 1e-4, or over the bound "
                     "where the plain crossed): at most 2 k + 4, k the "
                     "plain's count, in all and on any one lane; "
                     "non-finite exactly where the float64 step and "
                     "policy are",
        "lane_steps": T * L,
        "lane_steps_not_finite": int((~fin_x).sum()),
        "not_finite_where_float64_is": same_finite,
        "crossings_kernel": n_k, "crossings_plain": n_p,
        "crossings_kernel_below_mark": int(below.sum()),
        "crossings_most_on_one_lane_kernel": lane_k,
        "crossings_most_on_one_lane_plain": lane_p,
        "worst_state_margin": margin.max().item(),
        "worst_input_margin": (eu_k - 3.0 * eu_p - 1e-5).max().item(),
        "worst_state_lane_step": {
            "step": t_w, "lane": l_w, "err_kernel": e_k[t_w, l_w].item(),
            "err_plain_f32": e_p[t_w, l_w].item(),
            "plain_crossed": bool(cross_p[t_w, l_w]),
            "bound": bound[t_w].item()},
        "err_kernel_vs_f64_max_held": held.max().item(),
        "err_plain_f32_vs_f64_max_held": torch.where(
            cross_p, 0.0, e_p).max().item(),
        "max_abs_err_vs_plain_f32_held": torch.where(
            cross_k | cross_p, 0.0, d).max().item(),
        "max_abs_err_vs_plain_f32_all": d.max().item(),
    }


def phase_megaroll(results, logs):
    import torch
    from drake_ddp_tpu_torch.ops import _cuda
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megaroll import (_launch, launch_config,
                                                  megaroll, phase_cycles,
                                                  rollout_plain)
    dev = torch.device("cuda")
    mc, system, model = cheetah(dev)
    kd = kernel_data_for_system(system)
    L, T = 2 * BATCH, 49
    phase_team_config(logs, kd, L)
    gen = torch.Generator(device=dev).manual_seed(1)
    tapes64 = rollout_tapes(mc, L, T, gen, dev)
    tapes32 = [a.float().contiguous() for a in tapes64]
    xs_k, us_k = megaroll(kd, *tapes32)
    torch.cuda.synchronize()
    ok, report = rollout_step_check(kd, tapes64, xs_k, us_k)
    err = report["max_abs_err_vs_plain_f32_held"]
    ms = cuda_ms(lambda: megaroll(kd, *tapes32), 3)
    plain_ms = cuda_ms(lambda: rollout_plain(kd.step, *tapes32), 1)
    n, m = kd.n, kd.m
    n_bytes = (n + 1 + T * (3 * m + m * n + 2 * n)) * L * 4
    n_ops = T * L * (step_ops(kd) + 2 * m * n + n + 3 * m)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    emit({"phase": "megaroll", "ok": ok, "lanes": L, "steps": T, **report,
          "ms": ms, "plain_ms": plain_ms})
    if not ok:
        fail("megaroll", "kernel outside tolerance")
    # the team-size sweep that chose the kernel's compile-time team size:
    # every team size computes the same arithmetic, so each variant must
    # give the built kernel's rollout bit for bit
    built = launch_config(kd, L)["threads_per_lane"]
    phase_build([("megaroll", t) for t in TEAM_SIZES if t != built])
    libs = {t: _cuda.load("megaroll", None if t == built else t)
            for t in TEAM_SIZES}
    sweep, diff = {}, {}
    for team, lib in libs.items():
        xs_t, us_t = _launch(lib, kd, *tapes32)
        diff[str(team)] = max((xs_t - xs_k).abs().max().item(),
                              (us_t - us_k).abs().max().item())
        sweep[str(team)] = cuda_ms(lambda: _launch(lib, kd, *tapes32), 3)
    emit({"phase": "megaroll_team_sweep", "lanes": L, "steps": T,
          "ms_per_launch_by_threads_per_lane": sweep,
          "max_abs_diff_vs_built_team": diff,
          "built_threads_per_lane": built,
          "lanes_per_block_by_threads_per_lane": {
              str(t): launch_config(kd, L, lib)["lanes_per_block"]
              for t, lib in libs.items()}})
    if any(d != 0.0 for d in diff.values()):
        fail("megaroll_team_sweep", "a team size differs from the built one")
    # where a launch's time goes, phase by phase
    cycles = phase_cycles(kd, *tapes32)
    total = sum(cycles.values())
    emit({"phase": "megaroll_phase_clocks", "lanes": L, "steps": T,
          "threads_per_lane": launch_config(kd, L)["threads_per_lane"],
          "cycles_per_lane_step": total,
          "share": {p: c / total for p, c in cycles.items()},
          "cycles_per_lane_step_by_phase": cycles})
    results["megaroll"] = dict(
        name="megaroll", route="cuda",
        source="drake_ddp_tpu_torch/csrc/megaroll.cu",
        replaces="drake_ddp_tpu/ops/megaroll.py:212", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, lanes=L, check=ok)


def jac_errors(kd, args64, got, root, plain32):
    """Per lane, the maxima over its n x (n + m) entries of |kernel -
    plain f64|, |plain f32 - plain f64| and |plain f64|, with the kernel's
    ``got`` and the plain float32 ``plain32`` each an (fx, fu) pair."""
    import torch
    J64 = torch.cat(kd.lane_jac(root)(*args64), dim=1)
    lane_max = lambda a: a.abs().amax(dim=(0, 1))
    K = torch.cat(got, dim=1).double()
    J32 = torch.cat(plain32, dim=1).double()
    return (lane_max(K - J64), lane_max(J32 - J64), lane_max(J64),
            lane_max(K - J32), bool(torch.isfinite(K).all()))


def jac_check(kd, x64, u64, got, root, max_flips=None, xn64=None):
    """Holds a kernel Jacobian ``got`` = (fx, fu) of the float32 inputs
    to the plain float64 Jacobian of the float64 inputs, lane by lane:
    max |kernel - plain f64| <= 3 max |plain f32 - plain f64| + 1e-5 max
    |J f64|, each the maximum over that lane's n x (n + m) entries.  The
    root-seeded Jacobian is linearized at x_next = the plain float64 step
    of each lane, rounded to float32 for the float32 versions.  The cold
    one runs the step's own Newton: a lane whose plain float32 root v'
    differs from the float64 one by more than CROSSING is a damped-Newton
    flip (rollout_step_check), its float32 Jacobian is of another root.
    So is a lane whose float64 root moves by more than CROSSING when its
    inputs are rounded to float32: the kernel computes in float64 from
    those inputs.  Such lanes are left out, counted, and at most 2% of
    the lanes (``max_flips``, if given, instead).  ``xn64``: the x_next
    that a root-seeded call was given (a trajectory's own next state)."""
    import torch
    nq = kd.model.nq
    if xn64 is None or not root:
        xn64 = kd.step(x64, u64)
    args64 = (x64, u64) + ((xn64,) if root else ())
    args32 = tuple(a.float().contiguous() for a in args64)
    e_k, e_p, scale, e_kp, finite = jac_errors(
        kd, args64, got, root, kd.lane_jac(root)(*args32))
    L = x64.shape[-1]
    flip_plain = flip_in = torch.zeros(L, dtype=torch.bool,
                                       device=x64.device)
    dev_plain = dev_in = torch.zeros_like(scale)
    if not root:
        off = lambda x, u: (kd.step(x, u)[nq:].double()
                            - xn64[nq:]).abs().amax(dim=0)
        dev_plain = off(*args32[:2])
        dev_in = off(args32[0].double(), args32[1].double())
        flip_plain, flip_in = dev_plain > CROSSING, dev_in > CROSSING
    flip = flip_plain | flip_in
    margin = torch.where(flip, -float("inf"), e_k - 3.0 * e_p - 1e-5 * scale)
    worst = int(margin.argmax())
    n_flip = int(flip.sum())
    ok = bool(finite and (margin <= 0).all() and n_flip <= (
        0.02 * L if max_flips is None else max_flips))
    held = lambda a: torch.where(flip, 0.0, a)
    return ok, {
        "criterion": "per lane: max |kernel - plain f64| <= 3 max |plain "
                     "f32 - plain f64| + 1e-5 max |J f64|" + (
                         "" if root else "; lanes whose plain f32 root, "
                         "or f64 root of the f32-rounded inputs, differs "
                         "from the f64 root by > 1e-4 (flips) left out, "
                         "at most " + ("2%" if max_flips is None
                                       else str(max_flips))),
        "lanes": L, "flips": n_flip, "flips_plain_f32": int(flip_plain.sum()),
        "flips_rounded_inputs": int(flip_in.sum()),
        "worst_lane_margin": margin.max().item(),
        "worst_lane_root_dev_plain_f32": dev_plain[worst].item(),
        "worst_lane_root_dev_rounded_inputs": dev_in[worst].item(),
        "worst_lane_ratio": held((e_k - 1e-5 * scale) / e_p).max().item(),
        "err_kernel_vs_f64_max": held(e_k).max().item(),
        "err_plain_f32_vs_f64_max": held(e_p).max().item(),
        "max_abs_err_vs_plain_f32": held(e_kp).max().item(),
        "err_kernel_vs_f64_rel_flip_lanes_max": torch.where(
            flip, e_k / scale, 0.0).max().item(),
        "err_kernel_vs_f64_rel_max": held(e_k / scale).max().item(),
        "err_kernel_vs_f64_rel_median": held(e_k / scale).median().item(),
    }


def phase_megajac(results, root):
    """megajac at the flagship's derivative call (L = 7 x 256 lanes),
    root-seeded (with a ragged L too) or cold-Newton, against the plain
    lane Jacobian."""
    import torch
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import megajac
    dev = torch.device("cuda")
    mc, system, model = cheetah(dev)
    kd = kernel_data_for_system(system)
    name = "megajac" if root else "megajac_cold"
    n, m = kd.n, kd.m
    for L in ((JAC_LANES, 1000) if root else (JAC_LANES,)):
        gen = torch.Generator(device=dev).manual_seed(3)
        x64, u64 = seeded_states(mc, L, gen, dev, torch.float64)
        x32, u32 = x64.float(), u64.float()
        xn32 = kd.step(x64, u64).float() if root else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = megajac(kd, x32, u32, xn32)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ok, report = jac_check(kd, x64, u64, got, root)
        args = (x32, u32) + ((xn32,) if root else ())
        ms = cuda_ms(lambda: megajac(kd, *args), 3)
        plain_ms = cuda_ms(lambda: kd.lane_jac(root)(*args), 1)
        # the function's inputs and outputs are float32, so its bound is
        # at the float32 rate; the kernel's float64 is its own choice
        n_bytes = ((n + m + (n if root else 0)) + n * (n + m)) * L * 4
        b_ms, b_by = bound_ms(n_bytes, jac_ops(kd, root) * L)
        emit({"phase": name, "ok": ok, **report, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "call_memory_bytes": peak,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
        if not ok:
            fail(name, f"kernel outside tolerance at L {L}")
        if L == JAC_LANES:
            results[name] = dict(
                name=name, route="cuda",
                source="drake_ddp_tpu_torch/csrc/megajac.cu",
                replaces=("drake_ddp_tpu/ops/megajac.py:214" if root else
                          "tools/probe_megajac_compile.py:91"),
                max_abs_err=report["max_abs_err_vs_plain_f32"], ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, lanes=L, check=ok, call_memory_bytes=peak)


MEGAJAC_KERNELS = ("megajac_primal_kernel", "megajac_tangent_kernel")


def phase_megajac_team(results, logs):
    """megajac's two kernels at the flagship's derivative call: how the
    team primal launches (threads per lane, lanes per block, shared bytes,
    ptxas' registers and spills of both kernels), each kernel's time by
    CUDA events, root-seeded and cold, and the primal's team-size sweep,
    which fails unless every team size gives G^-1, fx and fu bit for
    bit."""
    import torch
    from drake_ddp_tpu_torch.ops import _cuda
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import (_buffers, _launch, _primal,
                                                 _tangent, launch_config)
    dev = torch.device("cuda")
    mc, system, _ = cheetah(dev)
    kd = kernel_data_for_system(system)
    L = JAC_LANES
    cfg = launch_config(kd, L)
    emit({"phase": "team_config", "kernel": "megajac", "lanes": L, **cfg,
          **{k.replace("megajac_", ""): ptxas_summary(logs["megajac"], k)
             for k in MEGAJAC_KERNELS}})
    built = cfg["threads_per_lane"]
    libs = {t: _cuda.load("megajac", None if t == built else t)
            for t in TEAM_SIZES}
    gen = torch.Generator(device=dev).manual_seed(3)
    x64, u64 = seeded_states(mc, L, gen, dev, torch.float64)
    x32, u32 = x64.float(), u64.float()
    xn32 = kd.step(x64, u64).float()
    for root, name in ((True, "megajac"), (False, "megajac_cold")):
        xn = xn32 if root else None
        lib = libs[built]
        b = _buffers(kd, lib, L, dev)
        primal_ms = cuda_ms(lambda: _primal(lib, kd, b, x32, u32, xn), 3)
        tangent_ms = cuda_ms(lambda: _tangent(lib, kd, b), 3)
        want = _launch(lib, kd, x32, u32, xn)
        sweep, diff = {}, {}
        for team, lib_t in libs.items():
            got = _launch(lib_t, kd, x32, u32, xn)
            diff[str(team)] = max((g - w).abs().max().item()
                                  for g, w in zip(got, want))
            bt = _buffers(kd, lib_t, L, dev)
            sweep[str(team)] = cuda_ms(
                lambda: _primal(lib_t, kd, bt, x32, u32, xn), 3)
        torch.cuda.synchronize()
        emit({"phase": "megajac_team_sweep", "root_seeded": root,
              "lanes": L, "primal_ms": primal_ms, "tangent_ms": tangent_ms,
              "primal_ms_by_threads_per_lane": sweep,
              "max_abs_diff_vs_built_team": diff,
              "built_threads_per_lane": built,
              "lanes_per_block_by_threads_per_lane": {
                  str(t): launch_config(kd, L, lib_t)["lanes_per_block"]
                  for t, lib_t in libs.items()}})
        if any(d != 0.0 for d in diff.values()):
            fail("megajac_team_sweep", "a team size differs from the built "
                                       "one (G^-1, fx or fu)")
        results[name].update(primal_ms=primal_ms, tangent_ms=tangent_ms)


def mpc_setup(mc, system, N, B, contact_iters, max_iters, minN, device,
              dtype, gen, derivs=None):
    """bench.py's flagship problem, solver and chain-health settings
    (``derivs``: another interpolation than setInterval-``minN``)."""
    import torch
    from drake_ddp_tpu_torch.mpc.driver import MPCConfig
    from drake_ddp_tpu_torch.solver import keypoints as kp
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig, ILQRProblem
    cfg = mc.Config(contact_iters=contact_iters)
    Q, R, Qf = mc.costs(cfg)
    x0, x_nom = mc.initial_and_target(cfg)
    rs = cfg.replan_steps
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x0b = t(x0)[None].repeat(B, 1)
    x0b[:, 19:] += 0.05 * torch.randn((B, 18), generator=gen, device=device,
                                      dtype=dtype)
    tile = lambda a: t(a)[None].repeat((B,) + (1,) * a.ndim)
    prob = ILQRProblem(
        x0=x0b, x_nom=tile(x_nom), Q=tile(cfg.dt * Q), R=tile(cfg.dt * R),
        Qf=tile(Qf), u_init=t(mc.U_STAND)[None, None].repeat(B, N - 1, 1),
        K_init=torch.zeros((B, N - 1, 12, 37), dtype=dtype, device=device),
        x_ref_init=x0b[:, None].repeat(1, N, 1),
        frozen=torch.zeros(B, dtype=torch.bool, device=device))
    derivs = derivs or kp.DerivsInterpolation("setInterval", minN=minN)
    scfg = ILQRConfig(num_steps=N, delta=cfg.delta, beta=cfg.beta,
                      max_iters=max_iters, derivs=derivs, ls_parallel=2,
                      eps_min=1e-3, ls_expected_floor=cfg.delta,
                      cost_ceiling=1e4)
    mpcc = lambda R: MPCConfig(num_resolves=R, replan_steps=rs,
                               policy_warm_start=True, freeze_diverged=True,
                               freeze_after=3, resolve_cost_ceiling=1e3)
    shift = torch.zeros(37, dtype=dtype, device=device)
    shift[4] = cfg.target_vel * cfg.dt * rs
    rescue = t(mc.U_STAND)[None].repeat(N - 1, 1)
    return prob, scfg, mpcc, shift, rescue


def phase_small_chain():
    """A small MPC chain on the card (float32, kernels) against the plain
    float64 chain on the CPU, within the loose chain pin (iterations +-1,
    costs 15%, states rtol 5e-2).  contact_iters 8, the flagship's: at 2
    the chain is chaotic (a 1e-6 change of x0 moves joint velocities by
    O(1)), and no f32 run stays near any f64 one."""
    import torch
    from drake_ddp_tpu_torch.mpc.driver import mpc_solve_batched
    out = {}
    for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
        mc, system, _ = cheetah(dev, contact_iters=8)
        gen = torch.Generator(device="cpu").manual_seed(2)
        prob, scfg, mpcc, shift, rescue = mpc_setup(
            mc, system, 8, 2, 8, 2, 4, "cpu", torch.float64, gen)
        mv = lambda a: a.to(device=dev, dtype=dtype if a.is_floating_point()
                            else a.dtype)
        prob = type(prob)(*(mv(a) for a in prob))
        res = mpc_solve_batched(system, scfg, prob, mpcc(1), mv(shift),
                                consec0=torch.zeros(2, dtype=torch.int32,
                                                    device=dev),
                                rescue_u=mv(rescue))
        out[dev] = res
    ref, got = out["cpu"], out["cuda"]
    d_it = (got.iterations.cpu().long() - ref.iterations.long()).abs().max()
    c_rel = ((got.costs.cpu().double() - ref.costs).abs()
             / ref.costs.abs()).max().item()
    xg, xr = got.states.cpu().double(), ref.states
    x_ok = torch.allclose(xg, xr, rtol=5e-2, atol=5e-2)
    excess = ((xg - xr).abs() - 5e-2 * (1 + xr.abs())).max().item()
    ok = int(d_it) <= 1 and c_rel <= 0.15 and bool(x_ok)
    emit({"phase": "small_chain", "ok": ok, "iterations_max_diff": int(d_it),
          "cost_max_rel": c_rel, "states_within_rtol_5e-2": bool(x_ok),
          "states_max_abs_diff": (xg - xr).abs().max().item(),
          "states_worst_excess_over_tol": excess})
    if not ok:
        fail("small_chain", "card chain outside the loose chain pin")


def run_flagship(rollout_kernel, num_resolves, seed, timer=None,
                 deriv_kernel="megajac", root_jac=lambda jac: jac,
                 derivs=None):
    """The flagship chain, with the system's root-seeded lane Jacobian
    replaced by ``root_jac(it)``; a None there makes the solver take the
    cold-Newton one.  ``derivs``: another interpolation than the
    flagship's setInterval-8."""
    import dataclasses
    import torch
    from drake_ddp_tpu_torch.mpc.driver import mpc_solve_batched
    dev = torch.device("cuda")
    mc, system, _ = cheetah(dev)
    system = dataclasses.replace(
        system, lane_jac_root_fn=root_jac(system.lane_jac_root_fn))
    gen = torch.Generator(device=dev).manual_seed(seed)
    prob, scfg, mpcc, shift, rescue = mpc_setup(
        mc, system, 50, BATCH, 8, 8, 8, dev, torch.float32, gen, derivs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mpc_solve_batched(system, scfg, prob, mpcc(num_resolves), shift,
                            rollout_kernel=rollout_kernel,
                            deriv_kernel=deriv_kernel,
                            consec0=torch.zeros(BATCH, dtype=torch.int32,
                                                device=dev),
                            rescue_u=rescue, timer=timer)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_result(res, N, R, phase):
    """Shapes, and finite costs and states on every lane not latched
    dead."""
    import torch
    B = res.costs.shape[0]
    shapes = (tuple(res.states.shape) == (B, N + 4 * R, 37)
              and tuple(res.costs.shape) == (B, R + 1))
    alive = ~res.dead
    finite = bool(torch.isfinite(res.states[alive]).all()
                  and torch.isfinite(res.final_u[alive]).all())
    if not (shapes and finite):
        fail(phase, f"bad result: shapes ok {shapes}, finite {finite}")


NOISE_REL = 1e-6   # the control's relative noise on the plain Jacobian


def chain_agreement(a, b):
    """Result ``a`` against ``b`` (same problems): the lanes outside the
    loose chain pin (iterations +-1, costs 15%), the batch's mean
    iterations and total cost relative to b's, and the median and
    largest lane cost differences."""
    d_it = (a.iterations.long() - b.iterations.long()).abs().amax(dim=1)
    ca, cb = a.costs.double(), b.costs.double()
    c_rel = ((ca - cb).abs() / cb.abs()).amax(dim=1)
    return {"lanes_outside_pin": int(((d_it > 1) | (c_rel > 0.15)).sum()),
            "lanes_equal_iterations": int((d_it == 0).sum()),
            "mean_iterations_diff": (a.iterations.double().mean()
                                     - b.iterations.double().mean()).item(),
            "total_cost_rel": ((ca.sum() - cb.sum()) / cb.sum()).item(),
            "lane_cost_rel_median": c_rel.median().item(),
            "lane_cost_rel_max": c_rel.max().item()}


def phase_flagship_lane(entry, t_entry, entry_timer, zero_counts):
    """The plain lane Jacobian on the flagship's entry solve (same seed)
    against the megajac one.

    Per lane the chain cannot be pinned at batch 256: a 1e-6 relative
    change of the Jacobian moves about one lane in six out of
    iterations +-1 and costs 15%, because a noise-flipped linesearch
    acceptance settles a lane in a nearby basin.  A second lane solve
    with that much noise on its Jacobian measures this floor in the same
    run.  Pass: the batch within the loose chain pin (mean iterations
    +-1, total cost 15%); no more lanes outside the per-lane pin than
    2 x the noise control's + 8; and on every Jacobian call of the lane
    solve, megajac on the solver's own inputs within jac_check's pin
    against the plain float64 Jacobian, on every lane."""
    import torch
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer

    calls = []

    def recording(jac):
        def f(*lanes):
            out = jac(*lanes)
            calls.append(tuple(tuple(t.clone() for t in ts)
                               for ts in (lanes, out)))
            return out
        return f

    def noisy(jac):
        gen = torch.Generator(device="cuda").manual_seed(13)
        shake = lambda J: J * (1 + NOISE_REL * torch.randn(
            J.shape, generator=gen, device=J.device, dtype=J.dtype))
        return lambda *lanes: tuple(shake(J) for J in jac(*lanes))

    lane_timer = PhaseTimer()
    zero_counts()
    lane, t_lane = run_flagship("fused", 0, seed=10, timer=lane_timer,
                                deriv_kernel="lane", root_jac=recording)
    lane_launches = megajac.launches
    check_result(lane, 50, 0, "flagship_lane")
    control, _ = run_flagship("fused", 0, seed=10, deriv_kernel="lane",
                              root_jac=noisy)
    got, floor = chain_agreement(entry, lane), chain_agreement(control, lane)

    # megajac on the lane solve's own Jacobian inputs
    kd = kernel_data_for_system(cheetah(torch.device("cuda"))[1])
    worst, n_bad, finite = -float("inf"), 0, True
    for lanes, plain32 in calls:
        e_k, e_p, scale, _, fin = jac_errors(
            kd, tuple(a.double() for a in lanes), megajac(kd, *lanes), True,
            plain32)
        margin = e_k - 3.0 * e_p - 1e-5 * scale
        worst = max(worst, margin.max().item())
        n_bad += int((margin > 0).sum())
        finite = finite and fin
    jac_calls = lane_timer.counts["jac"]
    ok = (abs(got["mean_iterations_diff"]) <= 1
          and abs(got["total_cost_rel"]) <= 0.15
          and got["lanes_outside_pin"] <= 2 * floor["lanes_outside_pin"] + 8
          and n_bad == 0 and finite and lane_launches == 0)
    emit({"phase": "flagship_lane", "ok": ok, "deriv_kernel": "lane",
          "batch": BATCH, "resolves": 0, "seconds": t_lane,
          "megajac_entry_seconds": t_entry,
          "criterion": "vs the megajac entry solve of the same seed: mean "
                       "iterations +-1 and total cost 15%; lanes outside "
                       "the per-lane pin (iterations +-1, costs 15%) <= 2 x "
                       "those of a lane solve with 1e-6 relative Jacobian "
                       "noise + 8; megajac on the lane solve's Jacobian "
                       "inputs within jac_check's pin on every lane",
          "megajac_vs_lane": got, "noisy_lane_vs_lane": floor,
          "jac_inputs_checked": [len(calls), sum(a[0].shape[-1]
                                                 for a, _ in calls)],
          "jac_lanes_outside_pin": n_bad, "jac_worst_lane_margin": worst,
          "megajac_launches": lane_launches, "jac_calls": jac_calls,
          "plain_jac_ms_per_call": lane_timer.totals_ms()["jac"] / jac_calls,
          "megajac_jac_ms_per_call": entry_timer.totals_ms()["jac"]
          / entry_timer.counts["jac"]})
    if not ok:
        fail("flagship_lane", "lane entry solve outside the chain pin")


def zero_counts():
    """Every kernel's launch count and the solver's host syncs to 0."""
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.solver.batched import any_lane
    megaroll.launches = megastep.launches = megajac.launches = 0
    any_lane.syncs = 0


def phase_flagship(results):
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.solver.batched import any_lane
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer

    # size the chain: one entry solve alone, then as many resolves as fit
    entry_timer = PhaseTimer()
    zero_counts()
    entry, t_entry = run_flagship("fused", 0, seed=10, timer=entry_timer)
    R = max(1, min(12, int(FLAGSHIP_BUDGET_S / max(t_entry, 1e-3)) - 1))
    timer = PhaseTimer()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res, secs = run_flagship("fused", R, seed=11, timer=timer)
    launches, syncs = megaroll.launches, any_lane.syncs
    jac_launches = megajac.launches
    phases = timer.totals_ms()
    rounds = timer.counts["riccati"]
    check_result(res, 50, R, "flagship")
    solves = BATCH * (R + 1)
    emit({"phase": "flagship", "rollout_kernel": "fused",
          "deriv_kernel": "megajac", "batch": BATCH, "horizon": 50,
          "n": 37, "m": 12, "contacts": 16, "contact_iters": 8,
          "keypoint_interval": 8, "ls_parallel": 2, "max_iters": 8,
          "jac_lanes": JAC_LANES, "budget_s": FLAGSHIP_BUDGET_S,
          "resolves": R, "entry_solve_seconds": t_entry, "seconds": secs,
          "resolves_per_s": solves / secs,
          "megaroll_launches": launches, "megajac_launches": jac_launches,
          "megastep_launches": megastep.launches, "host_syncs": syncs,
          "ilqr_rounds": rounds,
          "megaroll_launches_per_round": launches / rounds,
          "phase_ms": {"rollout_kernel": phases.get("rollout", 0.0),
                       "jac": phases.get("jac", 0.0),
                       "lerp": phases.get("derivs", 0.0)
                       - phases.get("jac", 0.0),
                       "riccati": phases.get("riccati", 0.0)},
          "jac_ms_per_call": phases.get("jac", 0.0) / max(jac_launches, 1),
          "iterations_mean": res.iterations.float().mean().item(),
          "diverged_fraction": res.diverged.float().mean().item(),
          "dead_fraction": res.dead.float().mean().item(),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    if launches == 0:
        fail("flagship", "megaroll was never launched on the main path")
    if jac_launches == 0 or jac_launches != rounds:
        fail("flagship", f"megajac launched {jac_launches} times in "
                         f"{rounds} iLQR rounds (one per round expected)")
    results["megaroll"]["launches"] = launches
    results["megajac"]["launches"] = jac_launches

    phase_flagship_lane(entry, t_entry, entry_timer, zero_counts)

    # the cold-Newton Jacobian: a system without the root-seeded one
    zero_counts()
    cold_timer = PhaseTimer()
    cold, t_cold = run_flagship("fused", 0, seed=10, timer=cold_timer,
                                root_jac=lambda jac: None)
    check_result(cold, 50, 0, "flagship_cold")
    emit({"phase": "flagship_cold", "deriv_kernel": "megajac",
          "root_seeded": False, "batch": BATCH, "resolves": 0,
          "seconds": t_cold, "megajac_cold_launches": megajac.launches,
          "ilqr_rounds": cold_timer.counts["riccati"],
          "jac_ms_per_call": cold_timer.totals_ms()["jac"]
          / max(megajac.launches, 1),
          "iterations_mean": cold.iterations.float().mean().item(),
          "diverged_fraction": cold.diverged.float().mean().item()})
    if megajac.launches == 0:
        fail("flagship_cold", "the cold megajac was never launched")
    results["megajac_cold"]["launches"] = megajac.launches

    # the per-step path: one entry solve, megastep once per horizon step
    zero_counts()
    timer = PhaseTimer()
    res, secs = run_flagship("megastep", 0, seed=12, timer=timer)
    check_result(res, 50, 0, "flagship_megastep")
    emit({"phase": "flagship_megastep", "rollout_kernel": "megastep",
          "batch": BATCH, "resolves": 0, "seconds": secs,
          "megastep_launches": megastep.launches,
          "megaroll_launches": megaroll.launches,
          "host_syncs": any_lane.syncs,
          "ilqr_rounds": timer.counts["riccati"],
          "rollout_kernel_ms": timer.totals_ms()["rollout"],
          "diverged_fraction": res.diverged.float().mean().item()})
    if megastep.launches == 0:
        fail("flagship_megastep", "megastep was never launched")
    results["megastep"]["launches"] = megastep.launches


PARALLEL_SEED = 20          # the parallel phases' flagship problems
PARALLEL_RESOLVES = 2       # an entry solve and two resolves
WORKER_TIMEOUT_S = 300      # each worker process of parallel_two_process


def parallel_problems(dev):
    """The flagship's system and BATCH problems at PARALLEL_SEED on
    ``dev``: (system, scfg, prob, mpc, shift, consec0, rescue)."""
    import torch
    mc, system, _ = cheetah(dev)
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
    prob, scfg, mpcc, shift, rescue = mpc_setup(
        mc, system, 50, BATCH, 8, 8, 8, dev, torch.float32, gen)
    consec0 = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    return system, scfg, prob, mpcc(PARALLEL_RESOLVES), shift, consec0, \
        rescue


def lanes_record(res):
    """Per-lane final costs and per-solve iterations (host lists)."""
    return {"costs": res.costs[:, -1].tolist(),
            "iterations": res.iterations.tolist()}


def same_lanes(a, b):
    """Whether two MPCResults give every lane the same bits (costs,
    iterations, states)."""
    import torch
    return (torch.equal(a.costs, b.costs)
            and torch.equal(a.iterations, b.iterations)
            and torch.equal(a.states, b.states))


def halves_of(prob):
    """The two halves of the parallel problems (the two-process split)."""
    halves = [slice(r * BATCH // 2, (r + 1) * BATCH // 2) for r in (0, 1)]
    sub = lambda h: type(prob)(*(None if a is None else a[h] for a in prob))
    return halves, sub


def run_halves(problems, threaded):
    """``mpc_solve_batched`` of each half of the parallel problems on the
    card, through ``sharding._run_shards``: one after another, or each in
    a host thread of its own (the multi-card path's threads, here both on
    cuda:0).  Returns (the halves' results, megaroll and megajac
    launches)."""
    import torch
    from drake_ddp_tpu_torch.mpc.driver import mpc_solve_batched
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.parallel import sharding
    system, scfg, prob, mpc, shift, consec0, rescue = problems
    halves, sub = halves_of(prob)
    fns = [lambda h=h: mpc_solve_batched(system, scfg, sub(h), mpc, shift,
                                         consec0=consec0[h],
                                         rescue_u=rescue)
           for h in halves]
    zero_counts()
    res = sharding._run_shards(fns, [prob.x0.device] * 2, threaded)
    torch.cuda.synchronize()
    return res, megaroll.launches, megajac.launches


def phase_parallel_flagship(results):
    """``batched_mpc`` over ``scenario_mesh()`` (one card: one shard) at
    the flagship configuration against a direct ``mpc_solve_batched`` of
    the same problems: per-lane costs and iterations bit for bit, the
    BatchStats equal to that run's sums, the same launch counts.

    Then the threaded multi-card path on the one card: the two halves of
    the batch, each in a host thread of its own through
    ``sharding._run_shards(threaded=True)`` on cuda:0 twice, against the
    same halves run one after another: each half's lanes bit for bit and
    the megaroll and megajac launches equal to the serial sums.  Returns
    (the 256-lane run, the serial halves)."""
    import torch
    from drake_ddp_tpu_torch.mpc.driver import mpc_solve_batched
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.parallel import batched_mpc, scenario_mesh
    dev = torch.device("cuda")
    problems = parallel_problems(dev)
    system, scfg, prob, mpc, shift, consec0, rescue = problems
    out = {}
    for route in ("direct", "parallel"):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "direct":
            res = mpc_solve_batched(system, scfg, prob, mpc, shift,
                                    consec0=consec0, rescue_u=rescue)
            stats = None
        else:
            mesh = scenario_mesh()
            res, stats = batched_mpc(system, scfg, prob, mpc, shift,
                                     mesh=mesh, consec0=consec0,
                                     rescue_u=rescue)
        torch.cuda.synchronize()
        out[route] = dict(res=res, stats=stats,
                          seconds=time.perf_counter() - t0,
                          megaroll=megaroll.launches,
                          megajac=megajac.launches)
    d, p = out["direct"], out["parallel"]
    rd, rp, stats = d["res"], p["res"], p["stats"]
    check_result(rp, 50, PARALLEL_RESOLVES, "parallel_flagship")
    same = same_lanes(rd, rp)
    sums = (torch.equal(stats.mean_cost, torch.sum(rd.costs[:, -1]) / BATCH)
            and int(stats.num_diverged) == int(rd.diverged.sum())
            and int(stats.total_iterations) == int(rd.iterations.sum()))
    counts = (p["megaroll"] == d["megaroll"] > 0
              and p["megajac"] == d["megajac"] > 0)
    timed = {}
    for threaded in (False, True):
        t0 = time.perf_counter()
        timed[threaded] = run_halves(problems, threaded) + (
            time.perf_counter() - t0,)
    serial, threads = timed[False], timed[True]
    threads_same = all(same_lanes(a, b) for a, b in zip(serial[0],
                                                         threads[0]))
    threads_counts = (threads[1] == serial[1] > 0
                      and threads[2] == serial[2] > 0)
    ok = same and sums and counts and threads_same and threads_counts
    emit({"phase": "parallel_flagship", "ok": ok, "shards": len(mesh),
          "mesh": [str(m) for m in mesh], "batch": BATCH,
          "resolves": PARALLEL_RESOLVES,
          "per_shard_seconds": p["seconds"], "direct_seconds": d["seconds"],
          "lanes_bit_identical": same, "stats_equal_direct_sums": sums,
          "stats": {k: float(v) for k, v in stats._asdict().items()},
          "megaroll_launches": [d["megaroll"], p["megaroll"]],
          "megajac_launches": [d["megajac"], p["megajac"]],
          "threaded_halves": {
              "criterion": "two halves of 128, each in a host thread of "
                           "its own on cuda:0 (sharding._run_shards, "
                           "threaded=True), against the same halves run "
                           "one after another: lanes bit for bit, "
                           "megaroll and megajac launches equal",
              "lanes_bit_identical": threads_same,
              "megaroll_launches": [serial[1], threads[1]],
              "megajac_launches": [serial[2], threads[2]],
              "seconds": [serial[3], threads[3]]}})
    if not ok:
        fail("parallel_flagship", "batched_mpc over one card is not the "
             "direct mpc_solve_batched run, or the threaded halves are not "
             "the serial ones")
    results["megaroll"]["parallel_launches"] = p["megaroll"]
    results["megajac"]["parallel_launches"] = p["megajac"]
    return rp, serial[0]


def spawn_workers(mode, ranks, world, extra=()):
    """``chip_smoke.py --worker <mode> <rank> <world> <port>`` processes,
    one per rank, sharing a free localhost port."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--worker", mode,
         str(r), str(world), str(port), *extra], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(REPO)) for r in ranks]


def collect(procs, phase):
    """Each worker's last stdout line as JSON; every process ended."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            if p.returncode != 0:
                fail(phase, f"worker exited {p.returncode}: {err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return outs


def phase_parallel_two_process(single, direct):
    """Two processes on the one card under ``backend="gloo"``, each with
    its half of the parallel_flagship problems through
    ``process_local_problem``.  Gates: both ranks' BatchStats identical
    and equal to the sums of the direct ``mpc_solve_batched`` runs of the
    halves (``direct``, parallel_flagship's serial halves), whose lanes
    the ranks repeat bit for bit; and every lane bit for bit the lane of
    the single-process run of all 256 (``single``): each kernel and the
    solver's per-lane arithmetic (the Riccati sweep's batched products,
    the per-step costs) give a lane the same bits at any batch size, so a
    scenario's answer does not move with how the batch is split.  Then
    NCCL: ``initialize(backend="nccl")`` at world size 1 with an
    all-reduce on the card, and two ranks on one card, which must raise
    naming gloo."""
    import torch
    from drake_ddp_tpu_torch.solver.ilqr import _cost_steps
    nccl = (spawn_workers("nccl", [0], 1)
            + spawn_workers("nccl", [0, 1], 2))
    nccl_out = collect(nccl, "parallel_two_process")
    gloo = collect(spawn_workers("gloo", [0, 1], 2), "parallel_two_process")

    dev = torch.device("cuda")
    _, _, prob, _, _, _, _ = parallel_problems(dev)
    halves, sub = halves_of(prob)
    repeat = all(g["lanes"] == lanes_record(d) for g, d in zip(gloo, direct))
    costs = torch.cat([d.costs[:, -1] for d in direct]).double()
    div = sum(int(d.diverged.sum()) for d in direct)
    its = sum(int(d.iterations.sum()) for d in direct)
    st = gloo[0]["stats"]
    sums = (st["num_diverged"] == div and st["total_iterations"] == its
            and abs(st["mean_cost"] - costs.mean().item())
            <= 1e-6 * abs(costs.mean().item()))
    stats_same = gloo[0]["stats"] == gloo[1]["stats"]

    got_it = torch.cat([d.iterations for d in direct]).long()
    got_c = torch.cat([d.costs for d in direct]).double()
    got_x = torch.cat([d.states for d in direct])
    ref_it, ref_c = single.iterations.long(), single.costs.double()
    d_it = (got_it - ref_it).abs().amax(dim=1)
    c_rel = ((got_c - ref_c).abs() / ref_c.abs()).amax(dim=1)
    bits = ((d_it == 0) & (c_rel == 0)
            & (got_x == single.states).flatten(1).all(dim=1))
    lanes_256 = bool(bits.all())
    x_bar = prob.x0[:, None].repeat(1, 50, 1)
    c256 = _cost_steps(prob, x_bar, prob.u_init)
    c128 = torch.cat([_cost_steps(sub(h), x_bar[h], prob.u_init[h])
                      for h in halves])
    nccl_ok = (nccl_out[0].get("all_reduce_ok") is True
               and all(o.get("raised_naming_gloo") for o in nccl_out[1:]))
    ok = stats_same and repeat and sums and lanes_256 and nccl_ok
    emit({"phase": "parallel_two_process", "ok": ok, "backend": "gloo",
          "processes": 2, "local_batch": BATCH // 2,
          "criterion": "ranks' stats identical and equal to the halves' "
                       "direct sums; each rank's lanes bit-identical to "
                       "the direct run of its half, and every lane "
                       "bit-identical (costs, iterations, states) to the "
                       "256-lane single-process run; NCCL at world 1 "
                       "all-reduces, two NCCL ranks on one card raise "
                       "naming gloo",
          "stats_rank0": gloo[0]["stats"], "stats_rank1": gloo[1]["stats"],
          "ranks_stats_identical": stats_same,
          "stats_equal_halves_sums": sums,
          "lanes_repeat_direct_halves": repeat,
          "vs_single_256": {
              "lanes_bit_identical": int(bits.sum()),
              "lanes_outside_iterations_1_cost_15pct": int(
                  ((d_it > 1) | (c_rel > 0.15)).sum()),
              "lane_cost_rel_max": c_rel.max().item(),
              "iterations_max_diff": int(d_it.max())},
          "cost_steps_lanes_bit_identical_128_vs_256":
              int((c128 == c256).all(dim=1).sum()),
          "per_shard_seconds": [g["seconds"] for g in gloo],
          "stats_all_reduce_ms": [g["all_reduce_ms"] for g in gloo],
          "megaroll_launches": [g["megaroll"] for g in gloo],
          "megajac_launches": [g["megajac"] for g in gloo],
          "nccl": nccl_out})
    if not ok:
        fail("parallel_two_process", "ranks disagree, a rank is off the "
             "direct run of its half, a lane is off the 256-lane run, or "
             "the NCCL checks failed")


def worker(mode, rank, world, port):
    """One process of parallel_two_process; prints one JSON line."""
    import torch
    import torch.distributed as dist
    from drake_ddp_tpu_torch.parallel import batched_mpc, multihost
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    addr = f"127.0.0.1:{port}"
    if mode == "nccl":
        try:
            multihost.initialize(addr, world, rank, backend="nccl")
        except ValueError as e:
            emit({"rank": rank, "world": world,
                  "raised_naming_gloo": "backend='gloo'" in str(e),
                  "error": str(e)})
            return
        x = torch.full((3,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        emit({"rank": rank, "world": world, "backend": dist.get_backend(),
              "all_reduce_ok": world == 1 and x.tolist() == [1.0] * 3})
        dist.destroy_process_group()
        return
    multihost.initialize(addr, world, rank, backend="gloo")
    mesh = multihost.host_device_mesh()
    dev = mesh.local[0]
    system, scfg, prob, mpc, shift, consec0, rescue = parallel_problems(dev)
    half = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
    local = multihost.process_local_problem(
        mesh, type(prob)(*(None if a is None else a[half] for a in prob)))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, stats = batched_mpc(system, scfg, local, mpc, shift, mesh=mesh,
                             consec0=consec0[half], rescue_u=rescue)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(megaroll=megaroll.launches, megajac=megajac.launches)
    # the stats' all-reduce alone (three host scalars under gloo)
    t1 = time.perf_counter()
    multihost.all_reduce_sums(*(torch.zeros((), device=dev)
                                for _ in range(3)), 1)
    reduce_ms = (time.perf_counter() - t1) * 1e3
    emit({"rank": rank, "mesh_shape": list(mesh.shape), "seconds": secs,
          "all_reduce_ms": reduce_ms, **launches,
          "stats": {k: float(v) for k, v in stats._asdict().items()},
          "lanes": lanes_record(res)})
    dist.destroy_process_group()


VIZ_HTML = REPO / "build" / "chip_smoke_viz.html"
VIZ_FIELDS = ("centers", "radii", "dt", "rate", "fpoints", "forces",
              "fscale", "fmin")   # the player's DATA with force arrows


def phase_viz():
    """The mini-cheetah example's run() at Config() with an MPCStream:
    every solve recorded; scene_frames and contact_force_frames of the
    executed trajectory on the card against the same calls on the CPU
    (centers and points within 1e-5, forces within 1e-3 relative on the
    active contacts); the HTML player with force arrows written under
    build/ and its DATA parsed back with the JAX player's fields."""
    import numpy as np
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    from drake_ddp_tpu_torch.viz import (MPCStream, contact_force_frames,
                                         export_html, scene_frames)
    cfg = mc.Config(verbose=False)
    system, model = mc.build_system(cfg, device="cuda")
    contact = system.params[1]
    stream, sols = MPCStream(replan_steps=cfg.replan_steps), []
    t0 = time.perf_counter()
    mc.run(cfg, device="cuda", on_solve=sols.append, stream=stream)
    run_s = time.perf_counter() - t0
    states = stream.executed(37)
    t1 = time.perf_counter()
    card = (scene_frames(model, contact, states),
            contact_force_frames(model, contact, states, cfg.dt))
    card_s = time.perf_counter() - t1
    host = (scene_frames(model, contact, states, device="cpu"),
            contact_force_frames(model, contact, states, cfg.dt,
                                 device="cpu"))
    e_c = np.abs(card[0]["centers"] - host[0]["centers"]).max()
    e_p = np.abs(card[1]["points"] - host[1]["points"]).max()
    mag = np.linalg.norm(host[1]["forces"], axis=2)
    active = mag > 1e-3 * mag.max()
    e_f = (np.linalg.norm(card[1]["forces"] - host[1]["forces"], axis=2)
           [active] / mag[active]).max()
    VIZ_HTML.parent.mkdir(exist_ok=True)
    export_html(str(VIZ_HTML), model, contact, states, cfg.dt,
                show_forces=True)
    html = VIZ_HTML.read_text()
    start = html.index("const DATA = ") + len("const DATA = ")
    data = json.loads(html[start:html.index(";\n", start)])
    stream_html = stream.export_html(str(VIZ_HTML.with_name(
        "chip_smoke_stream.html")), model, contact, cfg.dt)
    recorded = len(stream.resolves) == len(sols) == 1 + cfg.num_resolves
    fields = sorted(data) == sorted(VIZ_FIELDS) and len(
        data["centers"]) == states.shape[0]
    ok = (recorded and fields and e_c <= 1e-5 and e_p <= 1e-5
          and e_f <= 1e-3 and int(active.sum()) > 0)
    emit({"phase": "viz", "ok": ok, "solves": len(sols),
          "resolves_recorded": len(stream.resolves),
          "frames": states.shape[0], "run_seconds": run_s,
          "card_frames_seconds": card_s,
          "centers_max_diff": float(e_c), "points_max_diff": float(e_p),
          "forces_max_rel_active": float(e_f),
          "active_contacts": int(active.sum()), "html": str(VIZ_HTML),
          "html_bytes": len(html), "data_fields": sorted(data),
          "stream_html_bytes": Path(stream_html).stat().st_size})
    if not ok:
        fail("viz", "a resolve went unrecorded, the card's frames are off "
             "the CPU's, or the player's data is malformed")


SCENARIO_ROLL_LANES = 8     # ls_parallel 8 candidates of one scenario
SCENARIO_JAC_LANES = 49     # N - 1 steps, dense derivatives
FLIP_LANE_REL = 1e-4        # megajac vs plain f64 where plain f32 flips


def scenario_kernel_data(dev):
    """The kernel data of the mini-cheetah example's own system
    (Config(): contact_iters 4, smooth_width 1e-3)."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    system, _ = mc.build_system(mc.Config(), device=dev)
    return mc, kernel_data_for_system(system)


def phase_scenario_kernels(results):
    """megaroll and the cold megajac at the shapes the per-scenario
    cheetah solve gives them (8 rollout lanes, 49 Jacobian lanes, the
    example's contact_iters 4), held against their plain versions as
    the flagship's shapes are, and timed."""
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll, rollout_plain
    dev = torch.device("cuda")
    mc, kd = scenario_kernel_data(dev)
    n, m, T = kd.n, kd.m, 49
    L = SCENARIO_ROLL_LANES
    gen = torch.Generator(device=dev).manual_seed(21)
    tapes64 = rollout_tapes(mc, L, T, gen, dev)
    tapes32 = [a.float().contiguous() for a in tapes64]
    xs, us = megaroll(kd, *tapes32)
    torch.cuda.synchronize()
    ok_roll, report = rollout_step_check(kd, tapes64, xs, us)
    roll_ms = cuda_ms(lambda: megaroll(kd, *tapes32), 5)
    roll_plain_ms = cuda_ms(lambda: rollout_plain(kd.step, *tapes32), 1)
    roll_bound = bound_ms((n + 1 + T * (3 * m + m * n + 2 * n)) * L * 4,
                          T * L * (step_ops(kd) + 2 * m * n + n + 3 * m))
    emit({"phase": "scenario_megaroll", "ok": ok_roll, "lanes": L,
          "steps": T, "contact_iters": kd.contact_iters, **report,
          "ms": roll_ms, "plain_ms": roll_plain_ms,
          "bound_ms": roll_bound[0], "bound_by": roll_bound[1]})
    L = SCENARIO_JAC_LANES
    x64, u64 = seeded_states(mc, L, gen, dev, torch.float64)
    x32, u32 = x64.float(), u64.float()
    got = megajac(kd, x32, u32)
    torch.cuda.synchronize()
    # at the example's contact_iters 4 the plain float32 root is another
    # one on about 1 lane in 5 (9 of 49 here; 5 of 1792 at the flagship's
    # 8), and its Jacobian is then no yardstick: jac_check leaves those
    # lanes out (up to half the call), and they are held to the plain
    # float64 Jacobian alone, within FLIP_LANE_REL of the lane's scale
    ok_jac, jreport = jac_check(kd, x64, u64, got, root=False,
                                max_flips=L // 2)
    ok_jac = ok_jac and (jreport["err_kernel_vs_f64_rel_flip_lanes_max"]
                         <= FLIP_LANE_REL)
    jac_ms = cuda_ms(lambda: megajac(kd, x32, u32), 5)
    jac_plain_ms = cuda_ms(lambda: kd.lane_jac(False)(x32, u32), 1)
    jac_bound = bound_ms(((n + m) + n * (n + m)) * L * 4,
                         jac_ops(kd, False) * L)
    emit({"phase": "scenario_megajac_cold", "ok": ok_jac, **jreport,
          "contact_iters": kd.contact_iters, "ms": jac_ms,
          "plain_ms": jac_plain_ms, "bound_ms": jac_bound[0],
          "bound_by": jac_bound[1]})
    if not (ok_roll and ok_jac):
        fail("scenario_kernels", "a kernel outside tolerance at the "
                                 "per-scenario shapes")
    results["megaroll"].update(
        scenario_lanes=SCENARIO_ROLL_LANES, scenario_ms=roll_ms,
        scenario_plain_ms=roll_plain_ms, scenario_bound_ms=roll_bound[0])
    results["megajac_cold"].update(
        scenario_lanes=SCENARIO_JAC_LANES, scenario_ms=jac_ms,
        scenario_plain_ms=jac_plain_ms, scenario_bound_ms=jac_bound[0],
        scenario_max_abs_err=jreport["max_abs_err_vs_plain_f32"])


GOLDEN = {"pendulum": 0.2400494, "cart_pole": 54.18781}   # the JAX goldens


def phase_scenario_analytic():
    """The pendulum and cart-pole examples through the class API on the
    card (their plain lane step and autodiff lane Jacobian on CUDA
    tensors; SolveProfiled, so with each phase's CUDA-event seconds over
    the solve): cost within 1% of the JAX package's goldens and the
    swing-up reached (pendulum angle within 0.01 of pi, cart-pole
    0.05)."""
    import torch
    from drake_ddp_tpu_torch.examples import cart_pole, pendulum
    from drake_ddp_tpu_torch.solver.batched import any_lane
    for name, ex, row, tol in (("pendulum", pendulum, 0, 0.01),
                               ("cart_pole", cart_pole, 1, 0.05)):
        ilqr = ex.build_solver(ex.Config(verbose=False), device="cuda")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _, _, cost, times = ilqr.SolveProfiled()
        secs = time.perf_counter() - t0
        sol = ilqr._solution
        rel = abs(cost - GOLDEN[name]) / GOLDEN[name]
        ok = bool(rel <= 0.01 and abs(x[row, -1] - math.pi) < tol)
        emit({"phase": "scenario_analytic", "task": name, "ok": ok,
              "cost": cost, "golden": GOLDEN[name], "cost_rel": rel,
              "final_angle": float(x[row, -1]),
              "iterations": int(sol.iterations), "seconds": secs,
              "phase_s": times.totals(), "host_syncs": any_lane.syncs})
        if not ok:
            fail("scenario_analytic", f"{name} misses its golden")


SCENARIO_NOISE_REL = 1e-6   # the noise control's relative Jacobian noise
PROFILE_PIN = 0.02          # per-round phase sums against the rounds' bracket
TRACE_DIR = REPO / "build" / "chip_smoke_trace"
TRACE_ITERS = 2             # iterations of the traced solve
TRACE_SLOWDOWN = 1.15       # a host-bound solve after the trace / before
TRACE_SOLVES = 3            # its timed solves on each side (the fastest)


def phase_profile():
    """The per-iteration phase-timed solve: the mini-cheetah example's
    run() at Config() (a solve and a resolve) with every solve through
    IterativeLinearQuadraticRegulator.SolveProfiled, on megaroll and the
    cold megajac.  Each solve's PhaseTimes (forward = the round's
    linesearch, derivs, backward = the Riccati sweep; CUDA events read
    after the solve) summed over its rounds must lie within PROFILE_PIN
    of one CUDA-event bracket around its rounds (an event where the first
    round's linesearch starts, one where the last round's Riccati sweep
    ends, recorded by this phase's own timer), with one record per round;
    the tables are printed.  Megaroll must launch once a linesearch chunk
    and megajac once a fresh derivative round.  Then utils.profiling.trace
    around one more solve (the entry solve cut to TRACE_ITERS iterations)
    writes a Chrome trace whose CUDA kernel events must name megaroll and
    megajac.  A host-bound solve (the Panda side task's, TRACE_SOLVES
    times on each side, the fastest) is timed before the trace and after
    it: the trace must not leave the process slower (after / before
    within TRACE_SLOWDOWN)."""
    import collections
    import contextlib
    import torch
    from drake_ddp_tpu_torch.examples import mini_cheetah
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.solver.api import \
        IterativeLinearQuadraticRegulator as API
    from drake_ddp_tpu_torch.solver.profile import format_phase_table
    from drake_ddp_tpu_torch.utils.profiling import trace

    class Bracket:
        """The solver's phases counted, and a CUDA event where a solve's
        first round starts and one where each round ends (the last one
        closes the bracket); nothing else, so that it adds little host
        time between the phases."""

        def __init__(self):
            self.counts, self.ends = collections.Counter(), None

        @contextlib.contextmanager
        def phase(self, name):
            self.counts[name] += 1
            if name == "linesearch" and self.ends is None:
                self.ends = [self._event()]
            yield
            if name == "riccati":
                self.ends[1:] = [self._event()]

        @staticmethod
        def _event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

    bracket, solves, solve = Bracket(), [], API.Solve

    def solve_profiled(self):
        bracket.ends = None
        *out, times = self.SolveProfiled()
        solves.append((self._solution, times, bracket.ends))
        return tuple(out)

    API.Solve = solve_profiled
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mini_cheetah.run(mini_cheetah.Config(verbose=False), device="cuda",
                         timer=bracket)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(megaroll=megaroll.launches, megajac=megajac.launches)
    finally:
        API.Solve = solve
    rows, summed, bracketed = [], 0.0, 0.0
    for sol, times, (first, last) in solves:
        print(format_phase_table(sol, times))
        total = sum(times.totals().values())
        span = first.elapsed_time(last) / 1e3
        summed, bracketed = summed + total, bracketed + span
        rows.append(dict(iterations=int(sol.iterations),
                         records=len(times.forward), phase_s=times.totals(),
                         rounds_sum_s=total, bracket_s=span,
                         rel=(total - span) / span,
                         forward_s=times.forward, derivs_s=times.derivs,
                         backward_s=times.backward))
    rel = (summed - bracketed) / bracketed
    counts = bracket.counts
    ok = bool(abs(rel) <= PROFILE_PIN
              and all(r["records"] == r["iterations"] > 0 for r in rows)
              and launches["megaroll"] == counts["rollout"] > 0
              and launches["megajac"] == counts["jac"] > 0)

    # the trace: the same solve cut to TRACE_ITERS iterations (a trace
    # records every operator, and the file grows with them)
    ilqr, _, _ = mini_cheetah.build_solver(
        mini_cheetah.Config(verbose=False), device="cuda")
    ilqr.config = ilqr.config._replace(max_iters=TRACE_ITERS)
    ilqr.Solve()                                   # warm, outside the trace
    panda = arm_example("panda")
    host_bound = panda.build_solver(panda.Config(verbose=False),
                                    device="cuda")

    def solve_s():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_bound.Solve()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    solve_s()                                      # warm
    before = [solve_s() for _ in range(TRACE_SOLVES)]
    with trace(str(TRACE_DIR)) as log_dir:
        ilqr.Solve()
        torch.cuda.synchronize()
    after = [solve_s() for _ in range(TRACE_SOLVES)]
    # the fastest of each side: the host's other load only adds time
    slowdown = min(after) / min(before)
    ok = ok and slowdown <= TRACE_SLOWDOWN
    path = Path(log_dir) / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in name for name in kernels)
             for k in ("megaroll", "megajac")}
    ok = ok and all(named.values())
    emit({"phase": "profile", "ok": ok, "solves": rows,
          "rounds_sum_s": summed, "bracket_s": bracketed, "rel": rel,
          "seconds": secs, "launches": launches,
          "linesearch_chunks": counts["rollout"],
          "fresh_derivative_rounds": counts["jac"],
          "trace": {"file": str(path.relative_to(REPO)),
                    "bytes": path.stat().st_size,
                    "kernel_events": len(kernels),
                    "kernel_events_named": named},
          "host_bound_solve_s": {"before_trace": before,
                                 "after_trace": after,
                                 "after_over_before": slowdown},
          "criterion": "per solve one PhaseTimes record per iteration; "
                       "forward + derivs + backward summed over the rounds "
                       f"within {PROFILE_PIN:.0%} of the CUDA-event bracket "
                       "around the rounds (both solves together); megaroll "
                       "launches == linesearch chunks, megajac launches == "
                       "fresh-derivative rounds; the trace's CUDA kernel "
                       "events name megaroll and megajac; the Panda's "
                       "solve after the trace within "
                       f"{TRACE_SLOWDOWN} x its time before (the fastest "
                       f"of {TRACE_SOLVES} on each side)"})
    if not ok:
        fail("profile", "the per-round phase times miss the rounds' bracket, "
                        "a round has no record, the run left its kernels, "
                        "the trace does not show them, or it left the "
                        "process slower")


def run_example(ex, deriv_kernel=None, wrap=None, record=False, cfg=None):
    """The example module ``ex``'s run() on the card at ``cfg`` (default
    its Config(verbose=False)), with the counts set to 0 just before: a
    dict of its states, cost, solutions, phase timer, wall seconds, launch
    counts and host syncs.  ``wrap`` (system -> system) replaces the
    system that the example builds, for this run only; with ``record``
    every megajac call's inputs and outputs are kept (``calls``, a copy on
    the card, after the call), and each derivative call's first megajac
    call and keypoint count (``rounds``: (index into calls, keypoints))."""
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.solver import batched
    from drake_ddp_tpu_torch.solver import keypoints as kp
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer
    timer, sols, calls, rounds = PhaseTimer(), [], [], []
    build, make = ex.build_system, batched.megajac_for_system
    derivs = kp.compute_derivatives_batched

    def counting(jac_T, dcfg, x, u, root=False):
        first = len(calls)
        fx, fu, pct = derivs(jac_T, dcfg, x, u, root=root)
        rounds.append((first, int(round(float(pct[0]) * (x.shape[1] - 1)
                                        / 100.0))))
        return fx, fu, pct

    def recording(system, root_seed):
        jac = make(system, root_seed)

        def f(*lanes):
            out = jac(*lanes)
            calls.append(tuple(t.clone() for t in lanes + tuple(out)))
            return out
        return f

    if wrap is not None:
        ex.build_system = lambda cfg, device: (
            lambda sm: (wrap(sm[0]), sm[1]))(build(cfg, device=device))
    if record:
        batched.megajac_for_system = recording
        kp.compute_derivatives_batched = counting
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, _, _, cost = ex.run(cfg or ex.Config(verbose=False),
                                    device="cuda",
                                    deriv_kernel=deriv_kernel, timer=timer,
                                    on_solve=sols.append)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(megaroll=megaroll.launches, megajac=megajac.launches,
                      megastep=megastep.launches,
                      syncs=batched.any_lane.syncs)
    finally:
        ex.build_system, batched.megajac_for_system = build, make
        kp.compute_derivatives_batched = derivs
    return dict(states=states, cost=cost, sols=sols, timer=timer,
                seconds=secs, calls=calls, rounds=rounds, **counts)


def run_scenario(deriv_kernel=None, wrap=None):
    """The mini-cheetah example's run() (run_example) at Config(): N 50,
    contact_iters 4, ls_parallel 8, max_iters 100, one entry solve and
    one resolve."""
    from drake_ddp_tpu_torch.examples import mini_cheetah
    return run_example(mini_cheetah, deriv_kernel, wrap)


def scenario_agreement(a, b):
    """Run ``a`` against ``b`` solve by solve: iterations and costs."""
    d_it = [int(x.iterations) - int(y.iterations)
            for x, y in zip(a["sols"], b["sols"])]
    c_rel = [abs(float(x.cost) - float(y.cost)) / abs(float(y.cost))
             for x, y in zip(a["sols"], b["sols"])]
    return {"iterations": [int(x.iterations) for x in a["sols"]],
            "costs": [float(x.cost) for x in a["sols"]],
            "iterations_diff": d_it, "cost_rel": c_rel,
            "within_pin": all(abs(d) <= 1 for d in d_it)
            and all(c <= 0.15 for c in c_rel)}


def plain_f64_jac(system, calls=None):
    """``system`` whose cold lane Jacobian is the plain one at megajac's
    own precision: float64 inside, float32 in and out.  ``calls``, if
    given, collects each call's float32 inputs."""
    import dataclasses
    jac = system.lane_jac_fn

    def f(x, u):
        if calls is not None:
            calls.append((x.clone(), u.clone()))
        return tuple(J.float() for J in jac(x.double(), u.double()))

    return dataclasses.replace(system, lane_jac_fn=f)


def noisy_jac(system, rel, seed, plain=False):
    """``system`` whose cold lane Jacobian is megajac's (``plain``: the
    plain one at float64 inside, as plain_f64_jac) with seeded relative
    noise of ``rel`` on every entry."""
    import dataclasses
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac_for_system
    jac = (plain_f64_jac(system).lane_jac_fn if plain
           else megajac_for_system(system, root_seed=False))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shake = lambda J: J * (1 + rel * torch.randn(
        J.shape, generator=gen, device=J.device, dtype=J.dtype))
    return dataclasses.replace(system, lane_jac_fn=lambda x, u: tuple(
        shake(J) for J in jac(x, u)))


def phase_scenario_cheetah(results):
    """The per-scenario entry point at full width: the mini-cheetah
    example's run() through IterativeLinearQuadraticRegulator on the card.

    Fails unless every linesearch chunk launched megaroll and every fresh
    derivative round launched the cold megajac (so neither plain route
    ran), both solves end finite and not diverged, and megajac on every
    Jacobian call of the same run with the plain cold lane Jacobian
    (deriv_kernel="lane", at megajac's float64 precision) is within
    jac_check's pin against the plain float64 Jacobian of those inputs;
    on the lanes jac_check leaves out (the plain float32 root is another
    one), within FLIP_LANE_REL of the lane's largest entry of it.

    The two runs are also compared solve by solve with the chain pin
    (iterations +-1, cost 15%), beside a noise control (the megajac run
    with 1e-6 relative noise on its Jacobian), and both are printed.  At
    Config() the chain cannot be pinned: the solve ends at the first
    iteration whose improvement is below delta, and Jacobian noise of
    1e-6 (1e-7 on the CPU) moves that iteration by 3 to 22 and the cost
    by 20-45%, so the two Jacobian routes meet the pin only by chance."""
    import numpy as np
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac

    main_run = run_scenario()
    timer = main_run["timer"]
    phases = timer.totals_ms()
    chunks, jac_rounds = timer.counts["rollout"], timer.counts["jac"]
    rounds = timer.counts["riccati"]
    calls = []
    lane_run = run_scenario(deriv_kernel="lane",
                            wrap=lambda s: plain_f64_jac(s, calls))
    noise_run = run_scenario(deriv_kernel="lane", wrap=lambda s: noisy_jac(
        s, SCENARIO_NOISE_REL, 13))

    # megajac on the plain run's own Jacobian inputs
    _, kd = scenario_kernel_data(torch.device("cuda"))
    worst, n_bad, n_flips, flip_rel = -float("inf"), 0, 0, 0.0
    rel, rel_med = 0.0, []
    for x, u in calls:
        ok_c, rep = jac_check(kd, x.double(), u.double(), megajac(kd, x, u),
                              False, max_flips=x.shape[-1] // 2)
        rel = max(rel, rep["err_kernel_vs_f64_rel_max"])
        rel_med.append(rep["err_kernel_vs_f64_rel_median"])
        worst = max(worst, rep["worst_lane_margin"])
        n_bad += 0 if ok_c else 1
        n_flips += rep["flips"]
        flip_rel = max(flip_rel, rep["err_kernel_vs_f64_rel_flip_lanes_max"])
    sols = main_run["sols"]
    healthy = bool(np.isfinite(main_run["states"]).all()
                   and np.isfinite(main_run["cost"])
                   and not any(bool(s.diverged) for s in sols))
    ok = (main_run["megaroll"] == chunks > 0
          and main_run["megajac"] == jac_rounds > 0
          and main_run["megastep"] == 0 and healthy and bool(calls)
          and n_bad == 0 and flip_rel <= FLIP_LANE_REL)
    emit({"phase": "scenario_cheetah", "ok": ok, "n": 37, "m": 12,
          "horizon": 50, "contacts": 16, "contact_iters": 4,
          "ls_parallel": 8, "max_iters": 100, "solves": len(sols),
          "iterations": [int(s.iterations) for s in sols],
          "costs": [float(s.cost) for s in sols],
          "diverged": [bool(s.diverged) for s in sols],
          "seconds": main_run["seconds"], "ilqr_rounds": rounds,
          "phase_s": {"rollout": phases.get("rollout", 0.0) / 1e3,
                      "jac": phases.get("jac", 0.0) / 1e3,
                      "lerp": (phases.get("derivs", 0.0)
                               - phases.get("jac", 0.0)) / 1e3,
                      "riccati": phases.get("riccati", 0.0) / 1e3},
          "host_syncs": main_run["syncs"],
          "linesearch_chunks": chunks,
          "megaroll_launches": main_run["megaroll"],
          "fresh_derivative_rounds": jac_rounds,
          "megajac_cold_launches": main_run["megajac"],
          "megastep_launches": main_run["megastep"],
          "megaroll_ms_at_8_lanes": results["megaroll"]["scenario_ms"],
          "megajac_cold_ms_at_49_lanes":
              results["megajac_cold"]["scenario_ms"],
          "criterion": "megaroll launches == linesearch chunks, cold "
                       "megajac launches == fresh-derivative rounds (so no "
                       "plain route), finite and not diverged, and megajac "
                       "within jac_check's pin on every Jacobian call of "
                       "the run with deriv_kernel='lane' (float64 inside), "
                       "its flip lanes within 1e-4 of the lane's scale of "
                       "the plain f64; the chain pin against that run and "
                       "the noise control are printed, not gated",
          "jac_calls_checked": len(calls), "jac_calls_outside_pin": n_bad,
          "jac_worst_lane_margin": worst, "jac_flip_lanes_left_out": n_flips,
          "jac_flip_lanes_err_rel_max": flip_rel,
          "jac_err_rel_to_plain_f64": {"max": rel,
                                       "median_of_calls": float(
                                           np.median(rel_med))},
          "lane_vs_megajac": scenario_agreement(lane_run, main_run),
          "lane_seconds": lane_run["seconds"],
          "lane_megajac_launches": lane_run["megajac"],
          "noise_control_vs_megajac": scenario_agreement(noise_run,
                                                         main_run),
          "noise_rel": SCENARIO_NOISE_REL})
    if not ok:
        fail("scenario_cheetah", "the per-scenario run left its kernels, "
                                 "ended unhealthy, or a Jacobian call is "
                                 "outside its pin")
    results["megaroll"]["scenario_launches"] = main_run["megaroll"]
    results["megajac_cold"]["scenario_launches"] = main_run["megajac"]


CHAIN_DRAWS = 20         # noise draws per Jacobian route (scenario_chain)
CHAIN_NOISE_REL = 1e-7   # their relative Jacobian noise
CHAIN_PIN = 0.15         # the routes' median final costs agree within this
CHAIN_CONTROL_RELS = (1e-3, 1e-2, 1e-1)   # the printed controls' noise


def chain_draws(rel, plain=False):
    """run_scenario's solves under CHAIN_DRAWS seeded draws of ``rel``
    relative noise on the cold Jacobian (megajac, or with ``plain`` the
    plain one at float64 inside): per draw the iterations, final costs,
    wall seconds and health."""
    import numpy as np
    out = []
    for k in range(CHAIN_DRAWS):
        run = run_scenario(deriv_kernel="lane", wrap=lambda s: noisy_jac(
            s, rel, 100 + k, plain=plain))
        out.append(dict(
            iterations=[int(x.iterations) for x in run["sols"]],
            costs=[float(x.cost) for x in run["sols"]],
            seconds=run["seconds"],
            healthy=bool(np.isfinite(run["states"]).all()
                         and not any(bool(x.diverged) for x in run["sols"]))))
    return out


def chain_compare(draws, ref):
    """The chain check's comparison of one route's draws with the
    reference route's: the medians of their solves' final costs (each
    run's solve and resolve) within CHAIN_PIN, and every draw of the
    route healthy."""
    import numpy as np
    median = lambda v, i=slice(None): float(np.median(
        [c for d in v for c in d["costs"][i]]))
    rel = abs(median(draws) - median(ref)) / median(ref)
    healthy = all(d["healthy"] for d in draws)
    return dict(ok=bool(rel <= CHAIN_PIN and healthy), median_rel=rel,
                median_final_cost=median(draws), healthy=healthy,
                median_by_solve={"entry": median(draws, slice(0, 1)),
                                 "resolve": median(draws, slice(1, 2))})


def phase_scenario_chain():
    """A chain check of the per-scenario cheetah that its chaos does not
    swamp: run() at Config() (a solve and a resolve) under CHAIN_DRAWS
    seeded draws of 1e-7 relative noise on the cold megajac Jacobian, and
    under the same draws on the plain cold Jacobian at float64 inside.  A
    draw moves a solve by up to 22 iterations and its final cost by a
    third (PERF.md), so the run-by-run pin cannot hold; the two routes'
    distributions must agree (chain_compare): the medians of their
    solves' final costs within CHAIN_PIN, every draw finite and not
    diverged.  The comparison has little power: megajac under 1e-3 and
    1e-2 relative noise, Jacobians far outside jac_check's pin, passes
    it too (PERF.md), so such routes (CHAIN_CONTROL_RELS) are run beside
    as printed controls, not gates, and the Jacobian is held by the
    per-call pins of scenario_cheetah and the arms."""
    plain = chain_draws(CHAIN_NOISE_REL, plain=True)
    routes = {"megajac": chain_draws(CHAIN_NOISE_REL)}
    routes.update({f"control_megajac_noise_{r:g}": chain_draws(r)
                   for r in CHAIN_CONTROL_RELS})
    cmp = {k: chain_compare(v, plain) for k, v in routes.items()}
    ok = bool(cmp["megajac"]["ok"] and all(d["healthy"] for d in plain))
    emit({"phase": "scenario_chain", "ok": ok, "draws": CHAIN_DRAWS,
          "noise_rel": CHAIN_NOISE_REL,
          "control_noise_rels": CHAIN_CONTROL_RELS,
          "criterion": "median final cost of the megajac route's solves "
                       "within 15% of the plain float64 route's, over the "
                       "same seeded noise draws, every draw finite and not "
                       "diverged (the controls are printed, not gated)",
          "plain_f64": {"median_final_cost": chain_compare(plain, plain)[
              "median_final_cost"], "healthy": all(
                  d["healthy"] for d in plain)},
          "compared_with_plain_f64": cmp,
          "draws_by_route": {"plain_f64": plain, **routes}})
    if not ok:
        fail("scenario_chain", "the two Jacobian routes' median final costs "
                               "disagree, or a draw ended unhealthy")


ARM_GOLDEN = {"panda": 3.1914, "kinova": 1.2865}   # the JAX goldens (side)
ARM_DY = {"panda": 0.09, "kinova": 0.10}           # and their ball checks
# Whether an arm's megajac run itself must meet the task.  The Panda's
# is held: under 1e-5 Jacobian noise (draws that decorrelate the chain)
# its default route meets the ball check as often as the JAX example does
# (153 and 150 of 200 draws, Fisher p 0.82; PERF.md), and its noise-free
# run meets it since the float64 step sums sphere-pair radii as JAX does.
# panda_draws holds the default route's count under that noise; the plain
# float32 route's run is held to the task on both arms.
ARM_TASK_ON_RUN = {"panda": True, "kinova": True}


def arm_example(name):
    from drake_ddp_tpu_torch.examples import kinova_gen3, panda_fr3
    return {"panda": panda_fr3, "kinova": kinova_gen3}[name]


def arm_kernel_data(name, pad=False):
    """The kernel data of an arm example's system at Config() (kinova:
    with the finger pads as box-face quadrature when ``pad``)."""
    import torch
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    ex = arm_example(name)
    cfg = ex.Config(pad_face_quadrature=True) if pad else ex.Config()
    return kernel_data_for_system(ex.build_system(
        cfg, device=torch.device("cuda"))[0])


def arm_task(name, x, cost, sol):
    """The JAX goldens' task checks of one arm run (x (27, N)): the ball
    moved sideways by more than ARM_DY, ends within 3 cm of its resting
    height and never sinks below 8 cm."""
    import numpy as np
    x0, _ = arm_example(name).scenario_states(arm_example(name).Config())
    dy, z_end, z_min = x[12, -1] - x0[12], x[13, -1], float(x[13].min())
    height = bool(abs(z_end - 0.1) < 0.03 and z_min > 0.08)
    return dict(cost=float(cost), iterations=int(sol.iterations),
                ball_dy=float(dy), ball_z_end=float(z_end), ball_z_min=z_min,
                healthy=bool(np.isfinite(x).all() and np.isfinite(cost)
                             and not bool(sol.diverged)),
                height=height, met=bool(dy > ARM_DY[name] and height))


def phase_scenario_arm(name, results):
    """An arm example's run() at Config() on the card (side task, N 50,
    contact_iters 8, dense derivatives; Panda 69 contacts, Kinova 127).

    Fails unless every linesearch chunk launched megaroll and every fresh
    derivative round the cold megajac, the solve ends finite and not
    diverged, and megajac on every Jacobian call of the run (all calls'
    lanes at once) is within jac_check's pin against the plain float64
    cold Jacobian of its inputs (its flip lanes within FLIP_LANE_REL of
    the lane's scale).

    The task: the JAX goldens' checks (arm_task), printed for the run
    beside the JAX golden cost and held where ARM_TASK_ON_RUN says.  A
    second run on the plain float32 lane Jacobian (the precision of the
    JAX example's Jacobian), its rollouts on megaroll, must meet the task
    on both arms, launch megaroll once a linesearch chunk and end healthy.
    Both runs end with the ball on the ground."""
    import torch
    run = run_example(arm_example(name), record=True)
    timer, sol, calls = run["timer"], run["sols"][0], run["calls"]
    phases = timer.totals_ms()
    chunks, jac_rounds = timer.counts["rollout"], timer.counts["jac"]
    kd = arm_kernel_data(name)
    cat = lambda i: torch.cat([c[i] for c in calls], dim=-1)
    ok_j, jrep = (jac_check(kd, cat(0).double(), cat(1).double(),
                            (cat(2), cat(3)), False,
                            max_flips=cat(0).shape[-1] // 2)
                  if calls else (False, {}))
    ok_j = ok_j and jrep["err_kernel_vs_f64_rel_flip_lanes_max"] <= \
        FLIP_LANE_REL
    main = arm_task(name, run["states"], run["cost"], sol)
    f32 = run_example(arm_example(name), "lane")
    f32_task = arm_task(name, f32["states"], f32["cost"], f32["sols"][0])
    f32_ok = bool(f32["megaroll"] == f32["timer"].counts["rollout"] > 0
                  and f32_task["healthy"] and f32_task["met"])
    task = bool(main["height"] and (main["met"] or not ARM_TASK_ON_RUN[name]))
    ok = (run["megaroll"] == chunks > 0 and run["megajac"] == jac_rounds > 0
          and run["megastep"] == 0 and main["healthy"] and ok_j and task
          and f32_ok)
    emit({"phase": f"scenario_{name}", "ok": ok, "n": kd.n, "m": kd.m,
          "horizon": run["states"].shape[1], "contacts": kd.sizes[4],
          "contact_iters": kd.contact_iters, **main,
          "golden_jax": ARM_GOLDEN[name],
          "cost_rel_to_golden": (main["cost"] - ARM_GOLDEN[name])
          / ARM_GOLDEN[name],
          "seconds": run["seconds"], "ilqr_rounds": timer.counts["riccati"],
          "phase_ms": {"rollout": phases.get("rollout", 0.0),
                       "jac": phases.get("jac", 0.0),
                       "lerp": phases.get("derivs", 0.0)
                       - phases.get("jac", 0.0),
                       "riccati": phases.get("riccati", 0.0)},
          "host_syncs": run["syncs"], "linesearch_chunks": chunks,
          "megaroll_launches": run["megaroll"],
          "fresh_derivative_rounds": jac_rounds,
          "megajac_cold_launches": run["megajac"],
          "megastep_launches": run["megastep"],
          "criterion": "megaroll launches == linesearch chunks, cold megajac "
                       "launches == fresh-derivative rounds, finite and not "
                       "diverged, megajac within jac_check's pin on every "
                       "call of the run (flip lanes within 1e-4 of scale); "
                       "the run ends with the ball on the ground"
                       + (" and meets the task" if ARM_TASK_ON_RUN[name]
                          else " (its task checks printed)")
                       + f" (ball dy > {ARM_DY[name]}, |z_end - 0.1| < "
                       "0.03, z_min > 0.08); the run on the plain float32 "
                       "lane Jacobian meets the task, megaroll launches == "
                       "its linesearch chunks, healthy",
          "jac_calls_checked": len(calls), "jac_check": jrep,
          "task_held_on_run": ARM_TASK_ON_RUN[name],
          "lane_f32_run": {**f32_task, "seconds": f32["seconds"],
                           "megaroll_launches": f32["megaroll"],
                           "linesearch_chunks": f32["timer"].counts[
                               "rollout"]}})
    if not ok:
        fail(f"scenario_{name}", "the run left its kernels, ended unhealthy, "
                                 "a Jacobian call is outside its pin, or a "
                                 "run that must meet the task did not")
    for k, launches in (("megaroll", run["megaroll"]),
                        ("megajac_cold", run["megajac"])):
        results[k].setdefault("manipulation", {}).setdefault(
            name, {})["launches"] = launches
    return run


PANDA_DRAWS = 40        # the default route's noise draws (panda_draws)
PANDA_DRAW_SEED = 100   # their seeds: 100 to 139
PANDA_DRAW_REL = 1e-5   # their relative Jacobian noise
# the draws that must meet the ball check: the binomial 1% quantile of 40
# draws at the JAX example's rate under the same noise, 150 of 200
# (tools/arm_chaos_jax.py --rel 1e-5 --draws 200, PERF.md)
PANDA_DRAWS_MET = 23


def phase_panda_draws():
    """The Panda's run() at Config() on its default route (megaroll and
    the cold megajac) under PANDA_DRAWS seeded draws of PANDA_DRAW_REL
    relative Jacobian noise (noisy_jac; scenario_chaos.py's
    default_noise_1e-5 draws at the same seeds), draws that decorrelate
    the chain.  At least PANDA_DRAWS_MET of them must meet the JAX
    goldens' ball checks (arm_task): the port meets the task as often as
    the JAX example does under the same noise.  Fails unless that holds,
    every draw ends healthy and launched megaroll once a linesearch chunk
    and megajac once a fresh derivative round."""
    met, draws = 0, []
    for k in range(PANDA_DRAWS):
        seed = PANDA_DRAW_SEED + k
        run = run_example(arm_example("panda"), deriv_kernel="lane",
                          wrap=lambda s: noisy_jac(s, PANDA_DRAW_REL, seed))
        task = arm_task("panda", run["states"], run["cost"], run["sols"][0])
        counts = run["timer"].counts
        launched = bool(run["megaroll"] == counts["rollout"] > 0
                        and run["megajac"] == counts["jac"] > 0)
        met += task["met"]
        draws.append(dict(seed=seed, met=task["met"], ball_dy=task["ball_dy"],
                          cost=task["cost"], iterations=task["iterations"],
                          healthy=task["healthy"], launched=launched,
                          seconds=run["seconds"]))
    ok = (all(d["healthy"] and d["launched"] for d in draws)
          and met >= PANDA_DRAWS_MET)
    emit({"phase": "panda_draws", "ok": ok, "draws": PANDA_DRAWS,
          "seeds": [PANDA_DRAW_SEED, PANDA_DRAW_SEED + PANDA_DRAWS - 1],
          "noise_rel": PANDA_DRAW_REL, "met": met,
          "met_at_least": PANDA_DRAWS_MET,
          "criterion": "every draw healthy, megaroll launches == linesearch "
                       "chunks, megajac launches == fresh-derivative rounds; "
                       f"at least {PANDA_DRAWS_MET} draws meet the ball "
                       "check (ball dy > 0.09, |z_end - 0.1| < 0.03, "
                       "z_min > 0.08): the binomial 1% quantile of 40 draws "
                       "at the JAX example's 150 of 200",
          "seconds": sum(d["seconds"] for d in draws), "by_draw": draws})
    if not ok:
        fail("panda_draws", "a draw left its kernels or ended unhealthy, or "
                            "too few draws met the ball check")


def manipulation_cases(runs):
    """(label, kernel data, step inputs (x, u) f64 on L = 49 lanes, rollout
    tapes f64 on 8 lanes) of the three manipulation models: the Panda and
    the Kinova with pad quadrature at their own runs' last Jacobian call
    (the lanes of a trajectory pushing the ball) and final solution (the
    linesearch's 8 candidates eps = 0.5^k); the small model of the CPU
    tests with sphere-world pairs at its seeded states."""
    import numpy as np
    import torch
    import drake_ddp_tpu_torch.contact.geometry as geom
    import drake_ddp_tpu_torch.multibody.model as model_mod
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams
    from drake_ddp_tpu_torch.models.small import (manipulation_states,
                                                  small_manipulation)
    from drake_ddp_tpu_torch.ops._table import StepKernelData
    dev = torch.device("cuda")
    L, R = SCENARIO_JAC_LANES, SCENARIO_ROLL_LANES
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                    device=dev)
    cases = []
    for label, name, pad in (("panda", "panda", False),
                             ("kinova_pad", "kinova", True)):
        run = runs[name]
        x, u = run["calls"][-1][:2]
        sol = run["sols"][0]
        eps = 0.5 ** np.arange(R)
        rep = lambda a: f64(a)[..., None].repeat(*(1,) * a.ndim, R)
        tapes = (rep(sol.x[0]), f64(eps), rep(sol.u), rep(sol.kappa),
                 rep(sol.K), rep(sol.x[:-1]))
        cases.append((label, arm_kernel_data(name, pad), x.double()[:, :L],
                      u.double()[:, :L], tapes))
    model, contact = small_manipulation(model_mod, geom, ("ss", "sw"),
                                        device=dev)
    kd = StepKernelData(model, contact, 2e-3, contact_iters=6,
                        force_params=ContactForceParams(smooth_width=1e-3))
    x, u = manipulation_states(model, L, 9)
    rng = np.random.default_rng(10)
    T = 49
    x0 = f64(manipulation_states(model, R, 11)[0])
    x0[model.nq:] *= 0.25
    n, m = kd.n, kd.m
    tapes = (x0, f64(rng.uniform(0.0, 1.0, R)),
             f64(0.3 * rng.standard_normal((T, m, R))),
             f64(0.3 * rng.standard_normal((T, m, R))),
             f64(0.005 * rng.standard_normal((T, m, n, R))),
             x0[None] + f64(0.01 * rng.standard_normal((T, n, R))))
    cases.append(("sphere_world", kd, f64(x), f64(u), tapes))
    return cases


def phase_manip_kernels(results, runs):
    """megastep, megaroll, and megajac root-seeded and cold on the
    manipulation models (manipulation_cases): each held against its plain
    version with the flagship's pins (megastep's 3x rule, rollout_step_check,
    jac_check; the cold Jacobian's flip lanes within FLIP_LANE_REL of
    scale), at the per-scenario lane counts, and timed."""
    import torch
    from drake_ddp_tpu_torch.ops import _cuda
    from drake_ddp_tpu_torch.ops.megajac import launch_config as jac_config
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import launch_config as roll_config
    from drake_ddp_tpu_torch.ops.megaroll import megaroll, rollout_plain
    from drake_ddp_tpu_torch.ops.megastep import launch_config as step_config
    from drake_ddp_tpu_torch.ops.megastep import megastep
    bad = []
    for label, kd, x64, u64, tapes64 in manipulation_cases(runs):
        n, m = kd.n, kd.m
        L = x64.shape[-1]
        # lanes per block follow the working set (ddp_team_launch)
        for name, config, lanes in (
                ("megastep", step_config, L),
                ("megaroll", roll_config, tapes64[0].shape[-1]),
                ("megajac", jac_config, L)):
            emit({"phase": "team_config", "kernel": name, "model": label,
                  "lanes": lanes, "scalars_per_lane":
                      _cuda.load(name).ddp_scratch_per_lane(*kd.sizes),
                  **config(kd, lanes)})
        x32, u32 = x64.float().contiguous(), u64.float().contiguous()
        meta = dict(model=label, contacts=kd.sizes[4],
                    contact_iters=kd.contact_iters)
        # megastep
        truth = kd.step(x64, u64)
        plain32 = kd.step(x32, u32)
        got = megastep(kd, x32, u32)
        torch.cuda.synchronize()
        e_plain = (plain32.double() - truth).abs().max().item()
        e_kern = (got.double() - truth).abs().max().item()
        ok = math.isfinite(e_kern) and e_kern <= 3.0 * e_plain + 1e-5
        ms = cuda_ms(lambda: megastep(kd, x32, u32), 5)
        plain_ms = cuda_ms(lambda: kd.step(x32, u32), 2)
        b = bound_ms((2 * n + m) * L * 4, step_ops(kd) * L)
        emit({"phase": "manip_megastep", "ok": ok, **meta, "lanes": L,
              "err_kernel_vs_f64": e_kern, "err_plain_f32_vs_f64": e_plain,
              "criterion": "err_kernel <= 3 err_plain + 1e-5",
              "max_abs_err_vs_plain_f32":
                  (got - plain32).abs().max().item(),
              "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
              "bound_by": b[1]})
        _manip_result(results, "megastep", label, L, ms, plain_ms, b,
                      (got - plain32).abs().max().item())
        bad += [] if ok else [f"megastep {label}"]
        # megaroll over the linesearch's candidates
        T, R = tapes64[2].shape[0], tapes64[0].shape[-1]
        tapes32 = [a.float().contiguous() for a in tapes64]
        xs, us = megaroll(kd, *tapes32)
        torch.cuda.synchronize()
        ok, report = rollout_step_check(kd, tapes64, xs, us)
        ms = cuda_ms(lambda: megaroll(kd, *tapes32), 3)
        plain_ms = cuda_ms(lambda: rollout_plain(kd.step, *tapes32), 1)
        b = bound_ms((n + 1 + T * (3 * m + m * n + 2 * n)) * R * 4,
                     T * R * (step_ops(kd) + 2 * m * n + n + 3 * m))
        emit({"phase": "manip_megaroll", "ok": ok, **meta, "lanes": R,
              "steps": T, **report, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b[0], "bound_by": b[1]})
        _manip_result(results, "megaroll", label, R, ms, plain_ms, b,
                      report["max_abs_err_vs_plain_f32_held"])
        bad += [] if ok else [f"megaroll {label}"]
        # megajac, root-seeded at the plain float64 step's next state, and
        # cold
        for root, name in ((True, "megajac"), (False, "megajac_cold")):
            xn32 = kd.step(x64, u64).float() if root else None
            args = (x32, u32) + ((xn32,) if root else ())
            got = megajac(kd, *args)
            torch.cuda.synchronize()
            ok, jrep = jac_check(kd, x64, u64, got, root, max_flips=L // 2)
            ok = ok and jrep["err_kernel_vs_f64_rel_flip_lanes_max"] <= \
                FLIP_LANE_REL
            ms = cuda_ms(lambda: megajac(kd, *args), 5)
            plain_ms = cuda_ms(lambda: kd.lane_jac(root)(*args), 1)
            b = bound_ms(((n + m + (n if root else 0)) + n * (n + m)) * L * 4,
                         jac_ops(kd, root) * L)
            emit({"phase": f"manip_{name}", "ok": ok, **meta, **jrep,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                  "bound_by": b[1]})
            _manip_result(results, name, label, L, ms, plain_ms, b,
                          jrep["max_abs_err_vs_plain_f32"])
            bad += [] if ok else [f"{name} {label}"]
    if bad:
        fail("manip_kernels", "outside tolerance: " + ", ".join(bad))


def _manip_result(results, kernel, label, lanes, ms, plain_ms, bound,
                  err):
    results[kernel].setdefault("manipulation", {}).setdefault(
        label, {}).update(lanes=lanes, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound[0], bound_by=bound[1],
                          max_abs_err=err)


# --- the classic tasks: the cart-pole wall, the acrobot, direct
# transcription and the two Riccati routes ----------------------------------

WALL_GOLDEN = 5.7024        # the JAX golden (tests/test_examples.py)
WALL_ROLL_LANES = 64        # 8 starts x ls_parallel 8 candidates
WALL_JAC_LANES = 792        # 8 starts x 99 steps
ACROBOT_GOLDEN = 1.7154926  # the JAX golden (tests/test_golden.py)
# JAX mpc_solve of the acrobot example at Config(MPC=True) (N 750, 50
# resolves of 2 steps, max_iters 100, parallel_backward), float32 on a CPU:
# each solve's cost and iterations
ACROBOT_MPC_JAX_COSTS = (
    1.7137356, 1.6979198, 1.6872889, 1.6787853, 1.6710418, 1.6634380,
    1.6556842, 1.6476313, 1.6391939, 1.6303339, 1.6210126, 1.6112061,
    1.6009077, 1.5901133, 1.5788556, 1.5671560, 1.5550646, 1.5426550,
    1.5299997, 1.5172025, 1.5043318, 1.4914972, 1.4787630, 1.4662220,
    1.4539446, 1.4419549, 1.4303071, 1.4190361, 1.4081594, 1.3976756,
    1.3875879, 1.3779217, 1.3686434, 1.3597457, 1.3512344, 1.3430836,
    1.3352871, 1.3278240, 1.3206972, 1.3138760, 1.3073546, 1.3011204,
    1.2951688, 1.2894775, 1.2840351, 1.2788297, 1.2738513, 1.2690934,
    1.2645397, 1.2601784, 1.2560183)
ACROBOT_MPC_JAX_ITERATIONS = (25,) + (3,) * 50
ACROBOT_MPC_RESOLVES = 50   # the chain the smoke runs (Config(): 50)
# JAX's method="sqp" runs of the three examples at Config(), float32 on a
# CPU: their costs, and how far a cost may sit from them.  The spread is
# what rounding alone gives: the two packages' float32 and float64 CPU
# runs of the same program (1800 Adam steps, 24 Gauss-Newton solves)
# spread -5.7% (pendulum), 1e-6 (cart-pole) and -6% .. +19% (acrobot)
# around these values
SQP_JAX = {"pendulum": 0.24023889, "cart_pole": 52.745644,
           "acrobot": 18.352528}
SQP_REL = {"pendulum": 0.10, "cart_pole": 0.01, "acrobot": 0.25}
RICCATI_SHAPES = ((37, 12), (4, 1))   # the cheetah's (n, m), the acrobot's
RICCATI_HORIZONS = (50, 750)
RICCATI_BATCHES = (1, 8, 64, 256)


def run_wall():
    """cart_pole_with_wall.run(Config()) on the card, the counts set to 0
    just before: a dict of the best start's states and cost, the
    MultistartResult, the phase timer, wall seconds, launch counts, host
    syncs and the inputs of the run's last megaroll and megajac calls (a
    copy on the card, taken before the call)."""
    import torch
    from drake_ddp_tpu_torch.examples import cart_pole_with_wall as wall
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.solver import batched
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer
    timer, last, res = PhaseTimer(), {}, []
    make_roll, make_jac = batched.megaroll_for_system, \
        batched.megajac_for_system

    def keep(name, fn):
        def f(*args):
            last[name] = tuple(a.clone() for a in args)
            return fn(*args)
        return f

    batched.megaroll_for_system = lambda s: keep("megaroll", make_roll(s))
    batched.megajac_for_system = lambda s, root_seed: keep(
        "megajac", make_jac(s, root_seed))
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, _, _, cost = wall.run(wall.Config(verbose=False),
                                      device="cuda", timer=timer,
                                      on_result=res.append)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(megaroll=megaroll.launches, megajac=megajac.launches,
                      megastep=megastep.launches,
                      syncs=batched.any_lane.syncs)
    finally:
        batched.megaroll_for_system = make_roll
        batched.megajac_for_system = make_jac
    return dict(states=states, cost=cost, res=res[0], timer=timer,
                seconds=secs, last=last, **counts)


def phase_ms(timer):
    """A solve's device phases (ms): rollout, jac, lerp (derivatives
    less the Jacobian) and riccati, with the Riccati ms per round."""
    t = timer.totals_ms()
    rounds = timer.counts["riccati"]
    return {"rollout": t.get("rollout", 0.0), "jac": t.get("jac", 0.0),
            "lerp": t.get("derivs", 0.0) - t.get("jac", 0.0),
            "riccati": t.get("riccati", 0.0), "rounds": rounds,
            "riccati_per_round": t.get("riccati", 0.0) / max(rounds, 1)}


def phase_scenario_wall():
    """The cart-pole wall's run() at Config() (T 1, N 100, contact_iters 2,
    8 starts of one batched solve, max_iters 60): a prismatic cart, a
    revolute pole, the tip ball against a rigid world box.  Fails unless
    the best start meets the JAX golden's task checks (pole within 0.25
    of upright at the end, the tip at the wall: x < -0.39, every state
    and the cost finite), megaroll launched once a linesearch chunk and
    the cold megajac once a fresh-derivative round, and megastep never.
    The best cost is printed beside the JAX golden, not held to it: the
    chain is chaotic at contact_iters 2 and the port's draws are not
    JAX's (PERF.md)."""
    import numpy as np
    run = run_wall()
    x, res, timer = run["states"], run["res"], run["timer"]
    chunks, jac_rounds = timer.counts["rollout"], timer.counts["jac"]
    tip = x[0] + 0.5 * np.sin(x[1])
    task = dict(final_angle_err=float(abs(x[1, -1] - math.pi)),
                tip_x_min=float(tip.min()),
                finite=bool(np.isfinite(x).all()
                            and math.isfinite(run["cost"])))
    met = bool(task["finite"] and task["final_angle_err"] < 0.25
               and task["tip_x_min"] < -0.39)
    ok = (met and run["megaroll"] == chunks > 0
          and run["megajac"] == jac_rounds > 0 and run["megastep"] == 0)
    emit({"phase": "scenario_wall", "ok": ok, **task, "task_met": met,
          "best_cost": run["cost"], "golden_jax": WALL_GOLDEN,
          "best_index": int(res.best_index),
          "start_costs": res.costs.cpu().tolist(),
          "best_iterations": int(res.best.iterations),
          "seconds": run["seconds"], "phase_ms": phase_ms(timer),
          "host_syncs": run["syncs"], "linesearch_chunks": chunks,
          "megaroll_launches": run["megaroll"],
          "fresh_derivative_rounds": jac_rounds,
          "megajac_cold_launches": run["megajac"],
          "megastep_launches": run["megastep"],
          "roll_lanes": run["last"]["megaroll"][0].shape[-1],
          "jac_lanes": run["last"]["megajac"][0].shape[-1],
          "criterion": "best start: |theta_end - pi| < 0.25, tip x < -0.39, "
                       "finite; megaroll launches == linesearch chunks, "
                       "cold megajac launches == fresh-derivative rounds, "
                       "no megastep launch"})
    if not ok:
        fail("scenario_wall", "the task checks failed or the run left its "
                              "kernels")
    return run


def phase_wall_kernels(results, run):
    """megastep, megaroll and the cold megajac on the cart-pole-wall
    model (a prismatic joint, a world box, a rigid wall) at the main
    path's shapes: megaroll on the inputs of the wall run's last
    linesearch chunk (64 lanes), the cold megajac on its last Jacobian
    call's (792 lanes), megastep on the first 64 of those; each held with
    the flagship's pins and timed."""
    import torch
    from drake_ddp_tpu_torch.examples import cart_pole_with_wall as wall
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll, rollout_plain
    from drake_ddp_tpu_torch.ops.megastep import megastep
    kd = kernel_data_for_system(wall.build_system(wall.Config(),
                                                  device="cuda"))
    n, m = kd.n, kd.m
    x32, u32 = run["last"]["megajac"]
    tapes32 = run["last"]["megaroll"]
    L, R, T = x32.shape[-1], tapes32[0].shape[-1], tapes32[2].shape[0]
    meta = dict(model="cart_pole_wall", contacts=kd.sizes[4],
                contact_iters=kd.contact_iters)
    bad = [] if (L, R) == (WALL_JAC_LANES, WALL_ROLL_LANES) else [
        f"lanes {R} / {L}, not {WALL_ROLL_LANES} / {WALL_JAC_LANES}"]
    # megastep
    xs, us = x32[:, :R].contiguous(), u32[:, :R].contiguous()
    truth = kd.step(xs.double(), us.double())
    plain32 = kd.step(xs, us)
    got = megastep(kd, xs, us)
    torch.cuda.synchronize()
    e_plain = (plain32.double() - truth).abs().max().item()
    e_kern = (got.double() - truth).abs().max().item()
    ok = math.isfinite(e_kern) and e_kern <= 3.0 * e_plain + 1e-5
    err = (got - plain32).abs().max().item()
    ms = cuda_ms(lambda: megastep(kd, xs, us), 5)
    plain_ms = cuda_ms(lambda: kd.step(xs, us), 2)
    b = bound_ms((2 * n + m) * R * 4, step_ops(kd) * R)
    emit({"phase": "wall_megastep", "ok": ok, **meta, "lanes": R,
          "err_kernel_vs_f64": e_kern, "err_plain_f32_vs_f64": e_plain,
          "criterion": "err_kernel <= 3 err_plain + 1e-5",
          "max_abs_err_vs_plain_f32": err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": b[0], "bound_by": b[1]})
    _wall_result(results, "megastep", R, ms, plain_ms, b, err, 0)
    bad += [] if ok else ["megastep"]
    # megaroll
    tapes64 = [a.double() for a in tapes32]
    xr, ur = megaroll(kd, *tapes32)
    torch.cuda.synchronize()
    ok, report = rollout_step_check(kd, tapes64, xr, ur)
    ms = cuda_ms(lambda: megaroll(kd, *tapes32), 5)
    plain_ms = cuda_ms(lambda: rollout_plain(kd.step, *tapes32), 1)
    b = bound_ms((n + 1 + T * (3 * m + m * n + 2 * n)) * R * 4,
                 T * R * (step_ops(kd) + 2 * m * n + n + 3 * m))
    emit({"phase": "wall_megaroll", "ok": ok, **meta, "lanes": R,
          "steps": T, **report, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": b[0], "bound_by": b[1]})
    _wall_result(results, "megaroll", R, ms, plain_ms, b,
                 report["max_abs_err_vs_plain_f32_held"], run["megaroll"])
    bad += [] if ok else ["megaroll"]
    # the cold megajac
    got = megajac(kd, x32, u32)
    torch.cuda.synchronize()
    ok, jrep = jac_check(kd, x32.double(), u32.double(), got, False,
                         max_flips=L // 2)
    ok = ok and jrep["err_kernel_vs_f64_rel_flip_lanes_max"] <= FLIP_LANE_REL
    ms = cuda_ms(lambda: megajac(kd, x32, u32), 5)
    plain_ms = cuda_ms(lambda: kd.lane_jac(False)(x32, u32), 1)
    b = bound_ms(((n + m) + n * (n + m)) * L * 4, jac_ops(kd, False) * L)
    emit({"phase": "wall_megajac_cold", "ok": ok, **meta, **jrep, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1]})
    _wall_result(results, "megajac_cold", L, ms, plain_ms, b,
                 jrep["max_abs_err_vs_plain_f32"], run["megajac"])
    bad += [] if ok else ["megajac_cold"]
    if bad:
        fail("wall_kernels", "outside tolerance: " + ", ".join(bad))


def _wall_result(results, kernel, lanes, ms, plain_ms, bound, err,
                 launches):
    results[kernel]["cart_pole_wall"] = dict(
        lanes=lanes, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
        bound_by=bound[1], max_abs_err=err, launches=launches)


def run_acrobot(**cfg):
    """acrobot.run(Config(verbose=False, **cfg)) on the card with a phase
    timer: (states, cost or costs, solution or MPCResult, timer, wall
    seconds)."""
    import torch
    from drake_ddp_tpu_torch.examples import acrobot
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer
    timer, sols = PhaseTimer(), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, _, _, cost = acrobot.run(acrobot.Config(verbose=False, **cfg),
                                     device="cuda", timer=timer,
                                     on_solve=sols.append)
    torch.cuda.synchronize()
    return states, cost, sols[0], timer, time.perf_counter() - t0


def phase_scenario_acrobot():
    """The acrobot example (N 750, the longest horizon) at
    Config(max_iters=60) with the associative-scan Riccati and with the
    sequential sweep: each cost within 1% of the JAX golden and the final
    angle within 0.05 of pi; the Riccati ms per round of each printed."""
    rows, ok = {}, True
    for route, pb in (("parscan", True), ("sequential", False)):
        x, cost, sol, timer, secs = run_acrobot(max_iters=60,
                                                parallel_backward=pb)
        rel = abs(cost - ACROBOT_GOLDEN) / ACROBOT_GOLDEN
        angle = abs(float(x[0, -1]) - math.pi)
        good = bool(rel <= 0.01 and angle < 0.05)
        ok = ok and good
        rows[route] = dict(ok=good, cost=cost, cost_rel_to_golden=rel,
                           final_angle_err=angle,
                           iterations=int(sol.iterations), seconds=secs,
                           phase_ms=phase_ms(timer))
    emit({"phase": "scenario_acrobot", "ok": ok, "golden_jax": ACROBOT_GOLDEN,
          "horizon": 750, **rows,
          "criterion": "each route: cost within 1% of the JAX golden, "
                       "|theta1_end - pi| < 0.05"})
    if not ok:
        fail("scenario_acrobot", "a Riccati route misses the golden")


def phase_scenario_acrobot_mpc():
    """The acrobot example's MPC mode (mpc_solve, N 750, replans of 2
    steps, parscan) with ACROBOT_MPC_RESOLVES resolves: every cost finite,
    the stitched states of shape (4, 750 + 2 resolves), and each solve
    held to JAX's float32 CPU run of the same chain with the chain-level
    pins (iterations +-1, cost within 15%)."""
    import numpy as np
    R = ACROBOT_MPC_RESOLVES
    x, costs, res, timer, secs = run_acrobot(MPC=True, num_resolves=R)
    iters = res.iterations.cpu().numpy()
    ref_c = np.asarray(ACROBOT_MPC_JAX_COSTS[:R + 1])
    ref_i = np.asarray(ACROBOT_MPC_JAX_ITERATIONS[:R + 1])
    d_it = iters - ref_i
    c_rel = np.abs(costs - ref_c) / ref_c
    ok = bool(np.isfinite(costs).all() and x.shape == (4, 750 + 2 * R)
              and np.isfinite(x).all() and (np.abs(d_it) <= 1).all()
              and (c_rel <= 0.15).all()
              and not res.diverged.cpu().numpy().any())
    emit({"phase": "scenario_acrobot_mpc", "ok": ok, "resolves": R,
          "resolves_config": 50, "states_shape": list(x.shape),
          "costs": costs.tolist(), "iterations": iters.tolist(),
          "iterations_diff_max": int(np.abs(d_it).max()),
          "cost_rel_max": float(c_rel.max()), "final_cost": float(costs[-1]),
          "final_cost_jax": float(ref_c[-1]), "seconds": secs,
          "phase_ms": phase_ms(timer),
          "criterion": "costs finite, states (4, 750 + 2 R), none diverged, "
                       "each solve: iterations within 1 and cost within 15% "
                       "of JAX's float32 CPU chain"})
    if not ok:
        fail("scenario_acrobot_mpc", "the chain left JAX's pins")


def phase_scenario_sqp():
    """The pendulum, cart-pole and acrobot examples with method="sqp"
    (the direct-transcription baseline: penalty homotopy, Adam, damped
    Gauss-Newton) on the card: each cost finite and within SQP_REL of
    JAX's float32 CPU run."""
    import importlib
    import numpy as np
    import torch
    rows, ok = {}, True
    for name in ("pendulum", "cart_pole", "acrobot"):
        ex = importlib.import_module(f"drake_ddp_tpu_torch.examples.{name}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, _, _, cost = ex.run(ex.Config(method="sqp", verbose=False),
                               device="cuda")
        secs = time.perf_counter() - t0
        rel = (cost - SQP_JAX[name]) / SQP_JAX[name]
        good = bool(np.isfinite(x).all() and math.isfinite(cost)
                    and abs(rel) <= SQP_REL[name])
        ok = ok and good
        rows[name] = dict(ok=good, cost=cost, cost_jax=SQP_JAX[name],
                          cost_rel=rel, tol=SQP_REL[name],
                          final_state=x[:, -1].tolist(), seconds=secs)
    emit({"phase": "scenario_sqp", "ok": ok, **rows})
    if not ok:
        fail("scenario_sqp", "a transcription cost outside its tolerance")


def riccati_problem(B, N, n, m, gen):
    """A seeded float32 Riccati sweep's inputs on the card: SPD weights,
    linearizations near the identity ((prob, x_bar, u_bar, fx, fu))."""
    import torch
    from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem
    dev = torch.device("cuda")
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    eye = lambda d: torch.eye(d, device=dev)
    spd = lambda d, s: (lambda a: a @ a.transpose(-1, -2) / d
                        + s * eye(d))(r(B, d, d))
    prob = ILQRProblem(x0=r(B, n), x_nom=r(B, n), Q=spd(n, 0.1),
                       R=spd(m, 0.1), Qf=spd(n, 1.0), u_init=r(B, N - 1, m))
    fx = eye(n) + 0.1 / n ** 0.5 * r(B, N - 1, n, n)
    fu = 0.3 / n ** 0.5 * r(B, N - 1, n, m)
    return prob, r(B, N, n), r(B, N - 1, m), fx, fu


def riccati_route_rows(gen, timed_sweeps=3):
    """For every (n, m) x N x B of RICCATI_SHAPES x RICCATI_HORIZONS x
    RICCATI_BATCHES, a seeded float32 sweep through the sequential pass
    and the associative scan: ms per sweep (CUDA events around
    ``timed_sweeps`` back-to-back sweeps, one at the largest sizes, after
    one untimed sweep; host enqueue gaps count) and parscan's largest
    deviation from the sequential kappa and K, relative to its scale."""
    import torch
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig, _backward_pass
    from drake_ddp_tpu_torch.solver.parscan import parallel_backward_pass

    def timed(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    rows = []
    for n, m in RICCATI_SHAPES:
        for N in RICCATI_HORIZONS:
            for B in RICCATI_BATCHES:
                args = riccati_problem(B, N, n, m, gen)
                reg = torch.full((B,), 1e-6, device="cuda")
                cfg = ILQRConfig(num_steps=N)
                seq = lambda: _backward_pass(cfg, *args, reg)
                par = lambda: parallel_backward_pass(cfg, *args, reg)
                (ks, Ks, _), (kp_, Kp, _) = seq(), par()
                err = max(((kp_ - ks).abs().max() / ks.abs().max()).item(),
                          ((Kp - Ks).abs().max() / Ks.abs().max()).item())
                reps = 1 if N * B * n >= 750 * 64 * 37 else timed_sweeps
                seq_ms, par_ms = timed(seq, reps), timed(par, reps)
                rows.append(dict(n=n, m=m, N=N, B=B, sequential_ms=seq_ms,
                                 parscan_ms=par_ms,
                                 speedup=seq_ms / par_ms, rel_err=err))
                del args, ks, Ks, kp_, Kp
    torch.cuda.empty_cache()
    return rows


def phase_riccati_routes():
    """The sequential sweep against the associative scan alone
    (riccati_route_rows): ms per sweep printed, agreement gated (kappa
    and K within 1e-4 of the sequential sweep's scale); and the float32
    scan against the float64 sequential pass at the JAX package's pin
    (tests/test_parscan.py: N 100, n 4, m 1, K within 1e-3 of scale)."""
    import torch
    from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig, ILQRProblem,
                                                 _backward_pass)
    from drake_ddp_tpu_torch.solver.parscan import parallel_backward_pass
    gen = torch.Generator(device="cuda").manual_seed(30)
    args = riccati_problem(1, 100, 4, 1, gen)
    reg = torch.full((1,), 1e-6, device="cuda")
    cfg = ILQRConfig(num_steps=100)
    f64 = (ILQRProblem(*(a.double() for a in args[0][:6])),
           *(a.double() for a in args[1:]))
    _, K64, _ = _backward_pass(cfg, *f64, reg.double())
    _, K32, _ = parallel_backward_pass(cfg, *args, reg)
    f32_err = ((K32.double() - K64).abs().max() / K64.abs().max()).item()
    rows = riccati_route_rows(gen)
    ok = f32_err < 1e-3 and all(math.isfinite(r["rel_err"])
                                and r["rel_err"] <= 1e-4 for r in rows)
    emit({"phase": "riccati_routes", "ok": ok,
          "parscan_f32_vs_sequential_f64": f32_err, "rows": rows,
          "criterion": "parscan's kappa and K within 1e-4 of the sequential "
                       "sweep's scale in every row; float32 parscan's K "
                       "within 1e-3 of scale of the float64 sequential pass "
                       "(N 100, n 4, m 1); times printed, not gated"})
    if not ok:
        fail("riccati_routes", "the two routes disagree")


# ---------------------------------------------------------------------------
# Dynamic keypoints (adaptiveJerk, iterativeError) and model files
# ---------------------------------------------------------------------------

# the JAX mini-cheetah example's interpolation thresholds
KP_CHEETAH = dict(minN=2, maxN=20, jerk_threshold=0.3,
                  iterative_error_threshold=10.0)
KP_BUDGET = 12         # max_keypoints that binds iterativeError's level caps
KP_BATCH_LANES = 256   # the root-seeded case's scenarios (the flagship's B)
CHECK_CHUNK = 2048     # lanes per jac_check call of a recorded stack


def kp_configs():
    """(label, DerivsInterpolation) of the keypoint phases."""
    from drake_ddp_tpu_torch.solver import keypoints as kp
    aj = kp.DerivsInterpolation("adaptiveJerk", **KP_CHEETAH)
    ie = kp.DerivsInterpolation("iterativeError", **KP_CHEETAH)
    return (("adaptiveJerk", aj), ("iterativeError", ie),
            ("iterativeError_budget", ie._replace(max_keypoints=KP_BUDGET)))


def kp_trajectories(mc, kd, B, N, gen, dev):
    """B seeded cheetah trajectories (B, N, n) and tapes (B, N-1, m),
    float32: seeded_states' standing states and torques, new torque noise
    each step, rolled out by megastep."""
    import torch
    from drake_ddp_tpu_torch.ops.megastep import megastep
    x64, _ = seeded_states(mc, B, gen, dev, torch.float64)
    U = torch.as_tensor(mc.U_STAND, dtype=torch.float32, device=dev)
    u = U[None, :, None] + 0.5 * torch.randn((N - 1, kd.m, B), generator=gen,
                                             device=dev)
    xs = [x64.float()]
    for t in range(N - 1):
        xs.append(megastep(kd, xs[-1], u[t].contiguous()))
    return (torch.stack(xs).permute(2, 0, 1).contiguous(),
            u.permute(2, 0, 1).contiguous())


def recorded_megajac(kd, root, calls):
    """megajac as a lane Jacobian that keeps each call's inputs and
    outputs (a copy, after the call)."""
    from drake_ddp_tpu_torch.ops.megajac import megajac

    def f(*lanes):
        out = megajac(kd, lanes[0], lanes[1], lanes[2] if root else None)
        calls.append(tuple(t.clone() for t in lanes + tuple(out)))
        return out
    return f


def jac_check_calls(kd, calls, root, per_scenario=False):
    """jac_check over the lanes of every recorded megajac call, CHECK_CHUNK
    lanes at a time; the flips at most 2% of all lanes, or with
    ``per_scenario`` (cold calls of a single scenario, where the plain
    float32 root is another one on up to 1 lane in 5) at most half, each
    within FLIP_LANE_REL of its lane's scale."""
    import torch
    cat = lambda i: torch.cat([c[i] for c in calls], dim=-1)
    x, u, fx, fu = cat(0), cat(1), cat(-2), cat(-1)
    xn = cat(2) if root else None
    L, ok, reps = x.shape[-1], True, []
    for a in range(0, L, CHECK_CHUNK):
        sl = slice(a, a + CHECK_CHUNK)
        ok_c, rep = jac_check(
            kd, x[:, sl].double(), u[:, sl].double(),
            (fx[..., sl], fu[..., sl]), root, max_flips=CHECK_CHUNK,
            xn64=xn[:, sl].double() if root else None)
        ok, reps = ok and ok_c, reps + [rep]
    flips = sum(r["flips"] for r in reps)
    worst = lambda k: max(r[k] for r in reps)
    flip_rel = worst("err_kernel_vs_f64_rel_flip_lanes_max")
    ok = (ok and flips <= (0.5 if per_scenario else 0.02) * L
          and (not per_scenario or flip_rel <= FLIP_LANE_REL))
    return bool(ok), {
        "lanes": L, "calls": len(calls), "flips": flips,
        "worst_lane_margin": worst("worst_lane_margin"),
        "err_kernel_vs_f64_rel_max": worst("err_kernel_vs_f64_rel_max"),
        "err_kernel_vs_f64_rel_flip_lanes_max": flip_rel,
        "max_abs_err_vs_plain_f32": worst("max_abs_err_vs_plain_f32")}


def host_adaptive_jerk(cfg, x):
    """adaptiveJerk masks (B, N-1) recomputed on the host from the
    trajectories x (B, N, n): the velocity trace's second difference in
    float32 numpy, the counter scan in plain Python, one scenario at a
    time (the JAX package's rules: keypoint 0, a hit at minN on jerk or at
    maxN regardless, the last keypoint moved to N-2)."""
    import numpy as np
    xh = x.cpu().numpy()
    B, N, n = xh.shape
    v = xh[:, :, n - n // 2:]
    jerk = v[:, 2:N - 1] - 2.0 * v[:, 1:N - 2] + v[:, 0:N - 3]
    exceeds = (jerk > np.float32(cfg.jerk_threshold)).any(axis=-1)
    masks = np.zeros((B, N - 1), bool)
    for b in range(B):
        counter, keys = 0, {0}
        for t in range(N - 3):
            counter += 1
            if counter >= cfg.minN and exceeds[b, t]:
                keys.add(t)
                counter = 0
            if counter >= cfg.maxN:
                keys.add(t)
                counter = 0
        if max(keys) != N - 2:
            keys.discard(max(keys))
            keys.add(N - 2)
        masks[b, sorted(keys)] = True
    return masks


def host_bisection(cfg, fx_dense, N):
    """iterativeError visited sets (B, N-1) replayed scenario by scenario
    and level by level on the dense Jacobian stacks fx_dense (B, N-1, n,
    n): a wanted segment (s, e) marks s, its mid and e, and its halves
    are wanted when the midpoint estimate's error exceeds the threshold;
    with ``max_keypoints`` a level checks only the first ``cap`` wanted
    segments in the tree's order (the JAX package's level caps)."""
    import numpy as np
    import torch
    from drake_ddp_tpu_torch.solver import keypoints as kp
    B, n = fx_dense.shape[0], fx_dense.shape[-1]
    levels = kp._dyadic_tree(N, cfg.minN)
    caps = (kp._level_caps(levels, max(3, cfg.max_keypoints))
            if cfg.max_keypoints is not None else None)
    visited = np.zeros((B, N - 1), bool)
    for b in range(B):
        active = np.ones(1, bool)
        for li, (st, en, mi, wide) in enumerate(levels):
            want = active & wide
            if caps is not None:
                if li > 0 and caps[li] == 0:
                    break
                want &= np.cumsum(want) <= caps[li]
            j = np.nonzero(want)[0]
            if len(j) == 0:
                break
            for ix in (st, mi, en):
                visited[b, ix[j]] = True
            g = lambda ix: fx_dense[b, torch.as_tensor(
                ix[j].astype(np.int64), device=fx_dense.device)]
            err = torch.sum((0.5 * (g(st) + g(en)) - g(mi)) ** 2,
                            dim=(-2, -1)) / (2 * n)
            bad = np.zeros(len(st), bool)
            bad[j] = (err > cfg.iterative_error_threshold).cpu().numpy()
            active = np.concatenate([bad, bad])
    return visited


def lanes_of(calls, x, root):
    """The (scenario, step) pairs of every recorded call's lanes, matched
    by their exact states in the trajectories x (B, N, n), per call; a
    root-seeded lane's x_next must be its trajectory's next state."""
    import numpy as np
    xh = x.cpu().numpy()
    B, N, _ = xh.shape
    where = {xh[b, t].tobytes(): (b, t) for b in range(B)
             for t in range(N - 1)}
    out = []
    for c in calls:
        lanes = c[0].T.cpu().numpy()
        bt = np.array([where.get(l.tobytes(), (-1, -1)) for l in lanes])
        if root and (bt >= 0).all():
            nxt = c[2].T.cpu().numpy()
            if not np.array_equal(nxt, xh[bt[:, 0], bt[:, 1] + 1]):
                bt[:] = -1
        out.append(bt)
    return out


def phase_keypoints_kernels(results):
    """The dynamic keypoint methods on seeded cheetah trajectories (N 50,
    contact_iters 8), root-seeded at B 256 and cold at B 1, through the
    port's ``compute_derivatives_batched`` on megajac: adaptiveJerk (the
    JAX example's thresholds) and iterativeError with and without a
    binding ``max_keypoints``.

    Fails unless: each adaptiveJerk mask equals a host recomputation from
    the same trajectories, and its one megajac call took exactly those
    (scenario, step) lanes; the iterativeError visited sets equal the
    bisection replayed on a dense megajac stack of the same trajectories
    (with the level caps where the budget is set; without it also the
    port's own replay ``iterative_error_mask``), and its Jacobians equal
    that stack's interpolation bit for bit; the percentages equal the
    masks' counts; every megajac call is within jac_check's pin against
    the plain float64 Jacobian.  Prints each call's lanes, ms, bound and
    the blocks of its primal and tangent kernels (of 132 SMs)."""
    import numpy as np
    import torch
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import launch_config, megajac
    from drake_ddp_tpu_torch.solver import keypoints as kp
    dev = torch.device("cuda")
    mc, system, _ = cheetah(dev)
    kd = kernel_data_for_system(system)
    n, m, N = kd.n, kd.m, 50
    T = N - 1
    gen = torch.Generator(device=dev).manual_seed(21)
    for B, root in ((KP_BATCH_LANES, True), (1, False)):
        name = "megajac" if root else "megajac_cold"
        x, u = kp_trajectories(mc, kd, B, N, gen, dev)
        lane = lambda a: a.reshape(B * T, a.shape[-1]).T.contiguous()
        dense = megajac(kd, lane(x[:, :-1]), lane(u),
                        lane(x[:, 1:]) if root else None)
        fx_d = dense[0].reshape(n, n, B, T).permute(2, 3, 0, 1)
        fu_d = dense[1].reshape(n, m, B, T).permute(2, 3, 0, 1)
        for label, cfg in kp_configs():
            calls = []
            fx, fu, pct = kp.compute_derivatives_batched(
                recorded_megajac(kd, root, calls), cfg, x, u, root=root)
            torch.cuda.synchronize()
            pairs = lanes_of(calls, x, root)
            got = np.zeros((B, T), bool)
            for bt in pairs:
                if (bt >= 0).all():
                    got[bt[:, 0], bt[:, 1]] = True
            matched = all((bt >= 0).all() for bt in pairs)
            if label == "adaptiveJerk":
                want = host_adaptive_jerk(cfg, x)
                order = np.stack(np.nonzero(want), axis=1)
                exact = (len(calls) == 1 and matched
                         and np.array_equal(pairs[0], order))
                replay = {}
            else:
                want = host_bisection(cfg, fx_d, N)
                replay = {"port_replay_equal": True}
                if cfg.max_keypoints is None:
                    own = torch.stack([kp.iterative_error_mask(cfg, fx_d[b], N)
                                       for b in range(B)]).cpu().numpy()
                    replay["port_replay_equal"] = bool(np.array_equal(own,
                                                                      want))
                mask_t = torch.as_tensor(want, device=dev)
                replay["fx_fu_bit_equal"] = bool(
                    torch.equal(fx, kp.interpolate_stack(mask_t, fx_d))
                    and torch.equal(fu, kp.interpolate_stack(mask_t, fu_d)))
                exact = matched and sum(len(bt) for bt in pairs) == want.sum()
            counts_ok = bool(torch.equal(
                pct, 100.0 * torch.as_tensor(want.sum(1), device=dev,
                                             dtype=pct.dtype) / T))
            ok_j, jrep = jac_check_calls(kd, calls, root,
                                         per_scenario=B == 1)
            timing = []
            for c in calls:
                L = c[0].shape[-1]
                args = c[:3] if root else c[:2]
                n_bytes = ((n + m + (n if root else 0)) + n * (n + m)) * L * 4
                b_ms, b_by = bound_ms(n_bytes, jac_ops(kd, root) * L)
                timing.append({
                    "lanes": L, "ms": cuda_ms(lambda: megajac(
                        kd, args[0], args[1], args[2] if root else None), 3),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "primal_blocks": launch_config(kd, L)["blocks"],
                    "tangent_blocks": -(-L * (n + m) // 128)})
            ok = bool(np.array_equal(got, want) and exact and counts_ok
                      and all(replay.values()) and ok_j
                      and torch.isfinite(fx).all()
                      and torch.isfinite(fu).all())
            emit({"phase": "keypoints_kernels", "ok": ok, "method": label,
                  "root_seeded": root, "batch": B, "horizon": N,
                  "config": cfg._asdict(), "masks_equal_host": bool(
                      np.array_equal(got, want)), "lanes_exact": bool(exact),
                  "percent_equal_counts": counts_ok, **replay,
                  "percent_mean": pct.mean().item(),
                  "keypoints_total": int(want.sum()), "jac_check": jrep,
                  "launches": len(calls), "calls": timing})
            if not ok:
                fail("keypoints_kernels", f"{label} at B {B}: a mask, a "
                     "lane set, a Jacobian or a megajac call is off")
            results[name].setdefault("keypoints", {})[label] = {
                "batch": B, "lanes_per_launch": [t["lanes"] for t in timing],
                "ms_per_launch": [t["ms"] for t in timing],
                "bound_ms": [t["bound_ms"] for t in timing]}


def keypoint_rounds(run):
    """Per derivative call of a recorded per-scenario run: its megajac
    calls' lane counts and the keypoint count of its percentage."""
    calls, rounds = run["calls"], run["rounds"]
    ends = [r[0] for r in rounds[1:]] + [len(calls)]
    return [([c[0].shape[-1] for c in calls[a:e]], k)
            for (a, k), e in zip(rounds, ends)]


def phase_scenario_keypoints():
    """The per-scenario examples with dynamic keypoints on the card: the
    mini cheetah's run() with adaptiveJerk and with iterativeError at the
    JAX example's thresholds, the Kinova's with adaptiveJerk at its
    Config() (the JAX defaults), each beside the same run with
    setInterval-8.

    Fails unless every run ends finite and not diverged; megaroll
    launches == linesearch chunks; a dynamic run launches the cold megajac
    once per derivative call (adaptiveJerk) or once per bisection level
    (iterativeError: each call's first launch the root's 3 lanes, at most
    the tree's depth a call), each call's lanes summing to its keypoint
    count; every megajac call within jac_check's pin as the per-scenario
    phases hold them; the Kinova's adaptiveJerk run meets the goldens'
    ball check, as its dense run does (scenario_kinova; the
    setInterval-8 run's task checks are printed)."""
    import numpy as np
    from drake_ddp_tpu_torch.examples import kinova_gen3, mini_cheetah
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.solver import keypoints as kp
    depth = kp._dyadic_depth(50, KP_CHEETAH["minN"])
    cases = [("cheetah", mini_cheetah, m) for m in
             ("adaptiveJerk", "iterativeError", "setInterval")] + [
        ("kinova", kinova_gen3, m) for m in ("adaptiveJerk", "setInterval")]
    for who, ex, method in cases:
        cfg = ex.Config(verbose=False, use_derivative_interpolation=True,
                        keypoint_method=method,
                        **({"minN": 8} if method == "setInterval" else {}))
        run = run_example(ex, record=True, cfg=cfg)
        timer, phases = run["timer"], run["timer"].totals_ms()
        per = keypoint_rounds(run)
        healthy = all(np.isfinite(s.x).all() and not bool(s.diverged)
                      for s in run["sols"])
        lanes_ok = all(sum(lanes) == k for lanes, k in per)
        if method == "iterativeError":
            launch_ok = (run["megajac"] == len(run["calls"])
                         and all(1 <= len(lanes) <= depth and lanes[0] == 3
                                 for lanes, _ in per))
        else:
            launch_ok = (run["megajac"] == len(per)
                         and all(len(lanes) == 1 for lanes, _ in per))
        kd = kernel_data_for_system(
            ex.build_system(cfg, device="cuda")[0])
        ok_j, jrep = jac_check_calls(kd, run["calls"], False,
                                     per_scenario=True)
        task = arm_task("kinova", run["states"], run["cost"],
                        run["sols"][0]) if who == "kinova" else {}
        held = who == "kinova" and method != "setInterval"
        ok = bool(healthy and lanes_ok and launch_ok and ok_j
                  and run["megaroll"] == timer.counts["rollout"] > 0
                  and (not held or (task["met"] and task["height"])))
        pcts = [float(p) for s in run["sols"]
                for p in s.stats.percent_derivs[:int(s.iterations)] if p > 0]
        emit({"phase": "scenario_keypoints", "ok": ok, "example": who,
              "method": method, "config": kp.from_config(cfg)._asdict(),
              "seconds": run["seconds"],
              "iterations": [int(s.iterations) for s in run["sols"]],
              "costs": [float(s.cost) for s in run["sols"]],
              "percent_derivs_mean": float(np.mean(pcts)) if pcts else 0.0,
              "phase_ms": {"rollout": phases.get("rollout", 0.0),
                           "jac": phases.get("jac", 0.0),
                           "lerp": phases.get("derivs", 0.0)
                           - phases.get("jac", 0.0),
                           "riccati": phases.get("riccati", 0.0)},
              "derivative_calls": len(per),
              "megajac_cold_launches": run["megajac"],
              "lanes_per_launch": [c[0].shape[-1] for c in run["calls"]],
              "megaroll_launches": run["megaroll"],
              "linesearch_chunks": timer.counts["rollout"],
              "host_syncs": run["syncs"], "jac_check": jrep, "task": task,
              "task_held": held})
        if not ok:
            fail("scenario_keypoints", f"{who} {method}: unhealthy, off its "
                 "kernels, a call's lanes off its mask, or the task missed")


def phase_flagship_keypoints():
    """A cut of the batched flagship (its entry solve and 2 resolves, B
    256) with adaptiveJerk at the cheetah's thresholds, beside the same
    cut with the flagship's setInterval-8: resolves/s, the jac phase, peak
    memory, chain health.  Each interpolation runs once untimed to warm
    up, then twice in the order ABBA, all on the same seed; the summary
    gives each one's median and spread.  Fails unless every run ends
    finite, launches megaroll and launches megajac once per iLQR
    round."""
    import statistics
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.solver import keypoints as kp
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer
    R = 2
    methods = {"setInterval-8": None,
               "adaptiveJerk": kp.DerivsInterpolation("adaptiveJerk",
                                                      **KP_CHEETAH)}
    order = ["setInterval-8", "adaptiveJerk"]
    timed = {label: [] for label in order}
    for i, label in enumerate(order + order + order[::-1]):
        timer = PhaseTimer()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res, secs = run_flagship("fused", R, seed=11, timer=timer,
                                 derivs=methods[label])
        check_result(res, 50, R, "flagship_keypoints")
        phases, rounds = timer.totals_ms(), timer.counts["riccati"]
        ok = megajac.launches == rounds > 0 and megaroll.launches > 0
        line = {"phase": "flagship_keypoints", "ok": ok, "interpolation": label,
                "pass": "warm-up" if i < 2 else i - 1,
                "batch": BATCH, "resolves": R, "seconds": secs,
                "resolves_per_s": BATCH * (R + 1) / secs,
                "ilqr_rounds": rounds, "megajac_launches": megajac.launches,
                "megaroll_launches": megaroll.launches,
                "phase_ms": {"rollout_kernel": phases.get("rollout", 0.0),
                             "jac": phases.get("jac", 0.0),
                             "lerp": phases.get("derivs", 0.0)
                             - phases.get("jac", 0.0),
                             "riccati": phases.get("riccati", 0.0)},
                "jac_ms_per_call": phases.get("jac", 0.0)
                / max(megajac.launches, 1),
                "iterations_mean": res.iterations.float().mean().item(),
                "diverged_fraction": res.diverged.float().mean().item(),
                "dead_fraction": res.dead.float().mean().item(),
                "max_memory_allocated_bytes":
                    torch.cuda.max_memory_allocated()}
        emit(line)
        if not ok:
            fail("flagship_keypoints", f"{label}: megajac launched "
                 f"{megajac.launches} times in {rounds} rounds, megaroll "
                 f"{megaroll.launches} times")
        if i >= 2:
            timed[label].append(line)

    def summary(lines, key):
        vals = [key(x) for x in lines]
        return {"median": statistics.median(vals), "min": min(vals),
                "max": max(vals)}
    emit({"phase": "flagship_keypoints_summary", "passes": 2, "order": "ABBA",
          **{label: {"resolves_per_s": summary(
              lines, lambda x: x["resolves_per_s"]),
              "jac_ms": summary(lines, lambda x: x["phase_ms"]["jac"]),
              "lerp_ms": summary(lines, lambda x: x["phase_ms"]["lerp"]),
              "riccati_ms": summary(lines,
                                    lambda x: x["phase_ms"]["riccati"]),
              "rollout_ms": summary(
                  lines, lambda x: x["phase_ms"]["rollout_kernel"])}
             for label, lines in timed.items()}})


MODEL_DIR = REPO / "build" / "model_files"   # the phase's written files
MESH_LANES = 49
# a revolute arm on a vertical slide whose forearm is an OBJ mesh (written
# by model_files) over a ground halfspace
MESH_URDF = """<robot name="mesh_arm">
  <link name="base"/>
  <link name="carriage">
    <inertial><mass value="2.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="forearm">
    <inertial><mass value="0.6"/><origin xyz="0.15 0 0"/>
      <inertia ixx="0.001" iyy="0.006" izz="0.006" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0.15 0 0"/>
      <geometry><mesh filename="forearm.obj" scale="1 1 1"/></geometry>
      <drake:proximity_properties><drake:compliant_hydroelastic/>
        <drake:hydroelastic_modulus value="5e5"/>
        <drake:hunt_crossley_dissipation value="1.0"/>
        <drake:mu_static value="0.6"/><drake:mu_dynamic value="0.5"/>
      </drake:proximity_properties></collision>
  </link>
  <joint name="lift" type="prismatic">
    <parent link="base"/><child link="carriage"/>
    <origin xyz="0 0 0.12"/><axis xyz="0 0 1"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="carriage"/><child link="forearm"/>
    <axis xyz="0 1 0"/>
  </joint>
  <transmission name="t1"><joint name="lift"/><actuator name="a1"/>
  </transmission>
  <transmission name="t2"><joint name="elbow"/><actuator name="a2"/>
  </transmission>
</robot>
"""


def sdf_cart_pole(dev, dt=1e-2):
    """The cart-pole from the port's cart_pole.sdf, no contact model."""
    from drake_ddp_tpu_torch.contact.geometry import GeometrySet
    from drake_ddp_tpu_torch.io.sdf import add_sdf
    from drake_ddp_tpu_torch.models import CART_POLE_SDF
    from drake_ddp_tpu_torch.multibody.model import ModelBuilder
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
    mb = ModelBuilder()
    add_sdf(mb, GeometrySet(), CART_POLE_SDF)
    return make_multibody_system(mb.finalize(device=dev), None, dt)


def mesh_arm(dev):
    """MESH_URDF's arm over a ground halfspace, its forearm OBJ (an
    elongated vertex cloud) written under build/: (system, the mesh's
    cover)."""
    import numpy as np
    from drake_ddp_tpu_torch.contact.geometry import (
        HALFSPACE, CollisionGeometry, ContactProps, GeometrySet,
        build_contact_model)
    from drake_ddp_tpu_torch.io.mesh import cover_mesh
    from drake_ddp_tpu_torch.io.urdf import add_urdf, parse_urdf
    from drake_ddp_tpu_torch.multibody.model import ModelBuilder
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
    MODEL_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(8)
    v = rng.normal(size=(400, 3)) * np.array([0.08, 0.015, 0.02])
    (MODEL_DIR / "forearm.obj").write_text(
        "".join(f"v {a:.17g} {b:.17g} {c:.17g}\n" for a, b, c in v))
    mb, gs = ModelBuilder(), GeometrySet()
    add_urdf(mb, gs, parse_urdf(MESH_URDF, base_dir=str(MODEL_DIR)),
             floating=False)
    gs.add(CollisionGeometry(-1, HALFSPACE, np.zeros(3), np.eye(3),
                             np.zeros(1), ContactProps(modulus=5e6),
                             "ground"))
    system = make_multibody_system(
        mb.finalize(device=dev), build_contact_model(gs, device=dev), 1e-2,
        contact_iters=4)
    return system, cover_mesh(str(MODEL_DIR / "forearm.obj"))


def generic_tapes(x0, u0, T, gen, scale=0.3):
    """Seeded closed-loop tapes (float64) around states x0 (n, L) and
    inputs u0 (m, L): x0, eps, u_bar, kappa, K, x_bar."""
    import torch
    n, L = x0.shape
    m = u0.shape[0]
    rnd = lambda *s: torch.randn(s, generator=gen, device=x0.device,
                                 dtype=torch.float64)
    return (x0, torch.rand(L, generator=gen, device=x0.device,
                           dtype=torch.float64),
            u0[None] + scale * rnd(T, m, L), scale * rnd(T, m, L),
            0.05 * rnd(T, m, n, L), x0[None] + 0.05 * rnd(T, n, L))


def phase_model_files(results):
    """Model files on the card.  The cart-pole from the port's
    cart_pole.sdf with no contact model: megastep against the analytic
    cart-pole step at tests/test_sdf.py's 1e-4 / 1e-5 and against its
    plain step (3 err_plain_f32 + 1e-5), megaroll held step by step to its
    plain version (rollout_step_check), the cold megajac by jac_check; the
    class-API swing-up (N 200, beta 0.9) on megaroll and the cold megajac
    ending within 0.2 of upright (tests/test_sdf.py:78-95), its cost
    printed beside the analytic cart-pole's golden, one megaroll launch a
    linesearch chunk and one megajac launch a fresh-derivative round.  A
    URDF text whose forearm is an OBJ mesh, covered by spheres above a
    ground halfspace: megastep held to its plain step at 49 lanes."""
    import numpy as np
    import torch
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll, rollout_plain
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.solver.api import (
        IterativeLinearQuadraticRegulator)
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    system = sdf_cart_pole(dev)
    kd = kernel_data_for_system(system)
    L, T = 64, 49
    x64 = 0.7 * torch.randn((4, L), generator=gen, device=dev,
                            dtype=torch.float64)
    u64 = 2.0 * torch.randn((1, L), generator=gen, device=dev,
                            dtype=torch.float64)
    x32, u32 = x64.float(), u64.float()
    got = megastep(kd, x32, u32)
    ref = cart_pole_system(dt=1e-2).lane_step_fn(x32, u32)
    truth, plain = kd.step(x64, u64), kd.step(x32, u32)
    e_k = (got.double() - truth).abs().max().item()
    e_p = (plain.double() - truth).abs().max().item()
    ok_step = bool(torch.allclose(got, ref, rtol=1e-4, atol=1e-5)
                   and e_k <= 3.0 * e_p + 1e-5)
    tapes64 = generic_tapes(x64, u64, T, gen)
    tapes32 = [a.float().contiguous() for a in tapes64]
    xs, us = megaroll(kd, *tapes32)
    torch.cuda.synchronize()
    ok_roll, roll = rollout_step_check(kd, tapes64, xs, us)
    jac = megajac(kd, x32, u32)
    ok_jac, jrep = jac_check(kd, x64, u64, jac, False)
    ms = {"megastep": cuda_ms(lambda: megastep(kd, x32, u32), 5),
          "megaroll": cuda_ms(lambda: megaroll(kd, *tapes32), 3),
          "megajac_cold": cuda_ms(lambda: megajac(kd, x32, u32), 3)}
    plain_ms = {"megastep": cuda_ms(lambda: kd.step(x32, u32), 2),
                "megaroll": cuda_ms(lambda: rollout_plain(kd.step, *tapes32),
                                    1),
                "megajac_cold": cuda_ms(lambda: kd.lane_jac(False)(x32, u32),
                                        1)}
    n, m = kd.n, kd.m
    bounds = {   # the same counts as the flagship phases', at these shapes
        "megastep": bound_ms((2 * n + m) * L * 4, step_ops(kd) * L),
        "megaroll": bound_ms((n + 1 + T * (3 * m + m * n + 2 * n)) * L * 4,
                             T * L * (step_ops(kd) + 2 * m * n + n + 3 * m)),
        "megajac_cold": bound_ms(((n + m) + n * (n + m)) * L * 4,
                                 jac_ops(kd, False) * L)}
    # the swing-up through the class API
    N, dt = 200, 1e-2
    timer = PhaseTimer()
    ilqr = IterativeLinearQuadraticRegulator(system, N, beta=0.9,
                                             verbose=False, device="cuda",
                                             timer=timer)
    ilqr.SetInitialState(np.zeros(4))
    ilqr.SetTargetState(np.array([0.0, np.pi, 0.0, 0.0]))
    ilqr.SetRunningCost(dt * np.diag([10.0, 10.0, 0.1, 0.1]),
                        dt * 0.001 * np.eye(1))
    ilqr.SetTerminalCost(np.diag([100.0, 100.0, 10.0, 10.0]))
    zero_counts()
    xsol, _, solve_s, cost = ilqr.Solve()
    launches = {"megaroll": megaroll.launches,
                "megajac_cold": megajac.launches,
                "megastep": megastep.launches}
    upright = abs(abs(float(xsol[1, -1])) - np.pi)
    ok_swing = bool(upright < 0.2 and np.isfinite(xsol).all()
                    and launches["megaroll"] == timer.counts["rollout"] > 0
                    and launches["megajac_cold"] == timer.counts["jac"] > 0)
    # the mesh-covered arm over the ground
    arm, cover = mesh_arm(dev)
    kda = kernel_data_for_system(arm)
    q = torch.stack([0.03 * torch.randn(MESH_LANES, generator=gen, device=dev,
                                        dtype=torch.float64),
                     1.2 * (torch.rand(MESH_LANES, generator=gen, device=dev,
                                       dtype=torch.float64) - 0.5)])
    xa = torch.cat([q, 0.5 * torch.randn((2, MESH_LANES), generator=gen,
                                         device=dev, dtype=torch.float64)])
    ua = 2.0 * torch.randn((2, MESH_LANES), generator=gen, device=dev,
                           dtype=torch.float64)
    got_a = megastep(kda, xa.float(), ua.float())
    truth_a = kda.step(xa, ua)
    e_ka = (got_a.double() - truth_a).abs().max().item()
    e_pa = (kda.step(xa.float(), ua.float()).double()
            - truth_a).abs().max().item()
    # lanes whose covered forearm reaches into the ground (the spheres'
    # lowest points, the elbow at z 0.12 + lift, rotation about y)
    c = np.array([sc for sc, _ in cover.spheres]) + [0.15, 0.0, 0.0]
    r = np.array([rr for _, rr in cover.spheres])
    lift, elbow = (a[:, None] for a in q.cpu().numpy())
    z = 0.12 + lift - np.sin(elbow) * c[:, 0] + np.cos(elbow) * c[:, 2]
    in_contact = int(((z - r) < 0).any(axis=1).sum())
    ok_mesh = bool(np.isfinite(e_ka) and e_ka <= 3.0 * e_pa + 1e-5
                   and in_contact >= MESH_LANES // 4)
    mesh_ms = cuda_ms(lambda: megastep(kda, xa.float(), ua.float()), 5)
    mesh_plain_ms = cuda_ms(lambda: kda.step(xa.float(), ua.float()), 2)
    mesh_bound = bound_ms((2 * kda.n + kda.m) * MESH_LANES * 4,
                          step_ops(kda) * MESH_LANES)
    ok = ok_step and ok_roll and ok_jac and ok_swing and ok_mesh
    emit({"phase": "model_files", "ok": ok,
          "sdf_cart_pole": {
              "contacts": kd.sizes[4], "lanes": L,
              "megastep_vs_analytic_max": (got - ref).abs().max().item(),
              "megastep_err_vs_f64": e_k, "plain_err_vs_f64": e_p,
              "megastep_ok": ok_step, "megaroll_ok": ok_roll,
              "megaroll": roll, "megajac_cold_ok": ok_jac,
              "megajac_cold": jrep, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bounds},
          "swing_up": {"ok": ok_swing, "theta_end_off_pi": upright,
                       "cost": float(cost),
                       "golden_analytic_cart_pole": GOLDEN["cart_pole"],
                       "seconds": solve_s,
                       "iterations": int(ilqr._solution.iterations),
                       "linesearch_chunks": timer.counts["rollout"],
                       "fresh_derivative_rounds": timer.counts["jac"],
                       "launches": launches,
                       "phase_ms": timer.totals_ms()},
          "mesh_arm": {"ok": ok_mesh, "cover_route": cover.route,
                       "spheres": len(cover.spheres),
                       "contacts": kda.sizes[4], "lanes": MESH_LANES,
                       "lanes_in_contact": in_contact,
                       "err_kernel_vs_f64": e_ka, "err_plain_f32_vs_f64": e_pa,
                       "criterion": "err_kernel <= 3 err_plain + 1e-5, a "
                                    "quarter of the lanes in contact",
                       "ms": mesh_ms, "plain_ms": mesh_plain_ms,
                       "bound_ms": mesh_bound}})
    if not ok:
        fail("model_files", "a kernel is off its plain version on a model "
             "file's system, or the SDF swing-up missed upright")
    for k in ("megastep", "megaroll", "megajac_cold"):
        results[k]["contact_free_sdf_cart_pole"] = {
            "lanes": L, "ms": ms[k], "plain_ms": plain_ms[k],
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "swing_up_launches": launches[k]}
    results["megastep"]["mesh_arm"] = {
        "lanes": MESH_LANES, "ms": mesh_ms, "plain_ms": mesh_plain_ms,
        "bound_ms": mesh_bound[0], "bound_by": mesh_bound[1]}


def main():
    if sys.argv[1:2] == ["--worker"]:
        # one process of parallel_two_process: chip_smoke.py --worker
        # <gloo|nccl> <rank> <world> <port>
        sys.path.insert(0, str(REPO))
        import drake_ddp_tpu_torch  # noqa: F401
        mode, rank, world, port = sys.argv[2:6]
        worker(mode, int(rank), int(world), port)
        return
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        sys.exit(2)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        sys.exit(2)
    if not (REPO / "drake_ddp_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "drake_ddp_tpu_torch/ beside this script)", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(REPO))
    import drake_ddp_tpu_torch  # noqa: F401  (sets full-f32 matmuls)

    card = card_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    results = {}
    # every library, and the team-size variants the sweeps compare (the
    # built team size is DDP_TEAM = 128), in one parallel build
    from drake_ddp_tpu_torch.ops._cuda import SOURCES
    logs = phase_build(list(SOURCES) + [
        (name, t) for name in ("megaroll", "megajac") for t in TEAM_SIZES
        if t != 128])
    phase_megastep(results)
    phase_megaroll(results, logs)
    phase_megajac(results, root=True)
    phase_megajac(results, root=False)
    phase_megajac_team(results, logs)
    phase_small_chain()
    phase_flagship(results)
    single, halves = phase_parallel_flagship(results)
    phase_parallel_two_process(single, halves)
    phase_viz()
    phase_scenario_kernels(results)
    phase_scenario_analytic()
    phase_scenario_cheetah(results)
    phase_scenario_chain()
    runs = {name: phase_scenario_arm(name, results)
            for name in ("panda", "kinova")}
    phase_panda_draws()
    phase_manip_kernels(results, runs)
    wall = phase_scenario_wall()
    phase_wall_kernels(results, wall)
    phase_keypoints_kernels(results)
    phase_scenario_keypoints()
    phase_flagship_keypoints()
    phase_model_files(results)
    phase_scenario_acrobot()
    phase_scenario_acrobot_mpc()
    phase_scenario_sqp()
    phase_riccati_routes()
    # last, so that a trace that slows the process again (utils.profiling
    # releases Kineto's CUPTI hooks; the phase holds it) fails here
    # without moving the other phases' times
    phase_profile()
    print(card)
    emit({"kernels": [results[k] for k in ("megastep", "megaroll",
                                           "megajac", "megajac_cold")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
