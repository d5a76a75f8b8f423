#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``drake_ddp_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card (megastep, megaroll,
and megajac root-seeded and cold-Newton), checks a small MPC chain
against the plain float64 chain on the CPU, and drives the flagship
batched mini-cheetah MPC (n 37, m 12, N 50, 16 contacts, contact_iters
8, setInterval-8, ls_parallel 2, max_iters 8, batch 256) through
``mpc_solve_batched`` with the fused megaroll rollout and the megajac
derivatives; then one entry solve each with the plain lane Jacobian
(held to the megajac one by the loose chain pin over the batch, beside
a noise control, with megajac checked on that solve's own Jacobian
inputs), with the cold-Newton megajac, and with one megastep launch per
horizon step.  Every phase prints one JSON line; the line before the
last lists the kernels, and the last line is ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero without that line.  Needs a CUDA
card; exits 2 without one.
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
            c["geom"] += (90 + int(ma.sum() + mb.sum()) * pjc
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


TEAM_SIZES = (32, 64, 128)   # threads per lane tried for megaroll


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
    the plain f32 step has k, in all and on the lane with the most."""
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
    e_k = (xs.double() - truth).abs().amax(dim=1)                 # (T, L)
    e_p = (plain.double() - truth).abs().amax(dim=1)
    cross_k, cross_p = e_k > CROSSING, e_p > CROSSING
    bound = 3.0 * torch.where(cross_p, 0.0, e_p).amax(dim=1) + 1e-5   # (T,)
    held = torch.where(cross_k, 0.0, e_k)
    u64 = policy(torch.float64)
    eu_k = (us.double() - u64).abs().amax(dim=1).amax(dim=1)      # (T,)
    eu_p = (policy(torch.float32).double() - u64).abs().amax(dim=1).amax(1)
    n_k, n_p = int(cross_k.sum()), int(cross_p.sum())
    lane_k = int(cross_k.sum(dim=0).max())
    lane_p = int(cross_p.sum(dim=0).max())
    ok = bool(torch.isfinite(xs).all() and torch.isfinite(us).all()
              and (held <= bound[:, None]).all()
              and (eu_k <= 3.0 * eu_p + 1e-5).all()
              and n_k <= 2 * n_p + 4 and lane_k <= 2 * lane_p + 4)
    d = (xs - plain).abs().amax(dim=1)
    return ok, {
        "criterion": "from the kernel's own states, per step: max over "
                     "lanes err_kernel <= 3 max err_plain_f32 + 1e-5 (states"
                     " and inputs vs float64), except lane-steps crossing a "
                     "contact-solve flip (error > 1e-4): at most 2 k + 4, k "
                     "the plain's count, in all and on any one lane",
        "lane_steps": T * L, "crossings_kernel": n_k, "crossings_plain": n_p,
        "crossings_most_on_one_lane_kernel": lane_k,
        "crossings_most_on_one_lane_plain": lane_p,
        "worst_state_margin": (held - bound[:, None]).max().item(),
        "worst_input_margin": (eu_k - 3.0 * eu_p - 1e-5).max().item(),
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


def jac_check(kd, x64, u64, got, root):
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
    the lanes."""
    import torch
    nq = kd.model.nq
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
    ok = bool(finite and (margin <= 0).all() and n_flip <= 0.02 * L)
    held = lambda a: torch.where(flip, 0.0, a)
    return ok, {
        "criterion": "per lane: max |kernel - plain f64| <= 3 max |plain "
                     "f32 - plain f64| + 1e-5 max |J f64|" + (
                         "" if root else "; lanes whose plain f32 root, "
                         "or f64 root of the f32-rounded inputs, differs "
                         "from the f64 root by > 1e-4 (flips) left out, "
                         "at most 2%"),
        "lanes": L, "flips": n_flip, "flips_plain_f32": int(flip_plain.sum()),
        "flips_rounded_inputs": int(flip_in.sum()),
        "worst_lane_margin": margin.max().item(),
        "worst_lane_root_dev_plain_f32": dev_plain[worst].item(),
        "worst_lane_root_dev_rounded_inputs": dev_in[worst].item(),
        "worst_lane_ratio": held((e_k - 1e-5 * scale) / e_p).max().item(),
        "err_kernel_vs_f64_max": held(e_k).max().item(),
        "err_plain_f32_vs_f64_max": held(e_p).max().item(),
        "max_abs_err_vs_plain_f32": held(e_kp).max().item(),
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
                library_ms=None, lanes=L, check=ok)


def mpc_setup(mc, system, N, B, contact_iters, max_iters, minN, device,
              dtype, gen):
    """bench.py's flagship problem, solver and chain-health settings."""
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
    derivs = kp.DerivsInterpolation("setInterval", minN=minN)
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
                 deriv_kernel="megajac", root_jac=lambda jac: jac):
    """The flagship chain, with the system's root-seeded lane Jacobian
    replaced by ``root_jac(it)``; a None there makes the solver take the
    cold-Newton one."""
    import dataclasses
    import torch
    from drake_ddp_tpu_torch.mpc.driver import mpc_solve_batched
    dev = torch.device("cuda")
    mc, system, _ = cheetah(dev)
    system = dataclasses.replace(
        system, lane_jac_root_fn=root_jac(system.lane_jac_root_fn))
    gen = torch.Generator(device=dev).manual_seed(seed)
    prob, scfg, mpcc, shift, rescue = mpc_setup(
        mc, system, 50, BATCH, 8, 8, 8, dev, torch.float32, gen)
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


def phase_flagship(results):
    import torch
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.solver.batched import any_lane
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer

    def zero_counts():
        megaroll.launches = megastep.launches = megajac.launches = 0
        any_lane.syncs = 0

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


def main():
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
    logs = phase_build()
    results = {}
    phase_megastep(results)
    phase_megaroll(results, logs)
    phase_megajac(results, root=True)
    phase_megajac(results, root=False)
    phase_small_chain()
    phase_flagship(results)
    print(card)
    emit({"kernels": [results[k] for k in ("megastep", "megaroll",
                                           "megajac", "megajac_cold")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
