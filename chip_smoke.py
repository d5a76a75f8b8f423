#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``drake_ddp_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, checks a small MPC
chain against the plain float64 chain on the CPU, and drives the
flagship batched mini-cheetah MPC (n 37, m 12, N 50, 16 contacts,
contact_iters 8, setInterval-8, ls_parallel 2, max_iters 8, batch 256)
through ``mpc_solve_batched`` on both rollout paths: the fused megaroll
kernel, then one megastep launch per horizon step.  Every phase prints
one JSON line; the line before the last lists the kernels, and the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
without that line.  Needs a CUDA card; exits 2 without one.
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
FLAGSHIP_BUDGET_S = 240.0    # wall time the flagship resolves may take

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


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def step_ops(kd):
    """Floating-point operations that one lane's step needs at this
    model's sizes, not what csrc/lanestep.cuh happens to execute: each
    body's ancestor dofs only, each Jacobian column once, the symmetric
    half of the mass matrix, a triangular Cholesky, each contact's
    Jacobian products over its nonzero columns (the dofs of its bodies'
    ancestors), and the unpivoted Gauss-Jordan Newton solve that the
    reference runs, on the columns not yet eliminated."""
    import numpy as np
    from drake_ddp_tpu_torch.multibody.model import ancestor_dof_mask
    model = kd.model
    nb, nv, nu = model.nb, model.nv, model.nu
    T = kd._struct
    ci, nc = T.contact_iters, T.nc
    anc = ancestor_dof_mask(model) > 0
    na = anc.sum(axis=1)                                  # ancestors/body
    pjc = 15                      # point-Jacobian column: lever, cross, blend
    ops = nb * (63 + 45)                                  # fk
    # mass matrix: com and world inertia per body, each ancestor column
    # once (angular 3, linear pjc, I a 15), the symmetric half of the
    # column products (13 each)
    ops += int(np.sum(108 + na * (3 + pjc + 15) + na * (na + 1) // 2 * 13))
    ops += int(np.sum(na * 6 + na * 3 + 90 + na * (pjc + 12)))  # bias
    ops += nv * 13 + nb * 40 + nu
    # Crout Cholesky (the dot products of the lower triangle), its
    # square roots and divisions, then two triangular solves
    chol = sum(2 * j * (nv - j) for j in range(nv)) + nv * (nv + 3) // 2
    ops += chol + 2 * nv * nv + 2 * nv
    if not T.has_contact:
        return ops + 40
    ops += T.ns * 18 + T.nbox * 63
    tau = with_g = 0
    for c in range(nc):
        a, b = T.c_body_a[c], T.c_body_b[c]
        ma = anc[a] if a >= 0 else np.zeros(nv, bool)
        mb = anc[b] if b >= 0 else np.zeros(nv, bool)
        cols = int((ma | mb).sum())                       # nonzero Jc columns
        ops += 90 + int(ma.sum() + mb.sum()) * pjc + int((ma & mb).sum()) * 3
        tau += 6 * cols + 60 + 6 * cols                   # Jc v, f, Jc' f
        with_g += 40 + 15 * cols + 6 * cols * cols        # D, E = D Jc, Jc' E
    res = nv + 2 * nv * nv + 4 * nv                       # M (vp - v) - dt ..
    gj = (nv - 1) * sum(1 + 2 * (nv - k) for k in range(nv)) + nv
    ops += ci * (tau + with_g + res + 2 * nv * nv + gj + tau + res + 3 * nv)
    return ops + 40


def phase_build():
    from drake_ddp_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    try:
        logs = _cuda.build()
    except RuntimeError as e:
        fail("build", str(e)[-4000:])
    for name, log in logs.items():
        emit({"phase": "build", "kernel": name,
              "seconds": time.perf_counter() - t0,
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if re.search(r"registers|spill|Compiling|smem", ln)]})


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
        library_ms=None)


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


def phase_megaroll(results):
    import torch
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megaroll import megaroll, rollout_plain
    dev = torch.device("cuda")
    mc, system, model = cheetah(dev)
    kd = kernel_data_for_system(system)
    L, T = 2 * BATCH, 49
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
    results["megaroll"] = dict(
        name="megaroll", route="cuda",
        source="drake_ddp_tpu_torch/csrc/megaroll.cu",
        replaces="drake_ddp_tpu/ops/megaroll.py:212", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)


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


def run_flagship(rollout_kernel, num_resolves, seed, timer=None):
    import torch
    from drake_ddp_tpu_torch.mpc.driver import mpc_solve_batched
    dev = torch.device("cuda")
    mc, system, _ = cheetah(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prob, scfg, mpcc, shift, rescue = mpc_setup(
        mc, system, 50, BATCH, 8, 8, 8, dev, torch.float32, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mpc_solve_batched(system, scfg, prob, mpcc(num_resolves), shift,
                            rollout_kernel=rollout_kernel,
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


def phase_flagship(results):
    import torch
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.solver.batched import any_lane
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer
    # size the chain: one entry solve alone, then as many resolves as fit
    _, t_entry = run_flagship("fused", 0, seed=10)
    R = max(1, min(12, int(FLAGSHIP_BUDGET_S / max(t_entry, 1e-3)) - 1))
    timer = PhaseTimer()
    torch.cuda.reset_peak_memory_stats()
    megaroll.launches = megastep.launches = any_lane.syncs = 0
    res, secs = run_flagship("fused", R, seed=11, timer=timer)
    launches, syncs = megaroll.launches, any_lane.syncs
    phases = timer.totals_ms()
    check_result(res, 50, R, "flagship")
    solves = BATCH * (R + 1)
    emit({"phase": "flagship", "rollout_kernel": "fused",
          "deriv_kernel": "lane", "batch": BATCH, "horizon": 50,
          "n": 37, "m": 12, "contacts": 16, "contact_iters": 8,
          "keypoint_interval": 8, "ls_parallel": 2, "max_iters": 8,
          "resolves": R, "entry_solve_seconds": t_entry, "seconds": secs,
          "resolves_per_s": solves / secs,
          "megaroll_launches": launches, "megastep_launches":
          megastep.launches, "host_syncs": syncs,
          "ilqr_rounds": timer.counts["riccati"],
          "megaroll_launches_per_round": launches / timer.counts["riccati"],
          "phase_ms": {"rollout_kernel": phases.get("rollout", 0.0),
                       "lane_jac": phases.get("lane_jac", 0.0),
                       "lerp": phases.get("derivs", 0.0)
                       - phases.get("lane_jac", 0.0),
                       "riccati": phases.get("riccati", 0.0)},
          "iterations_mean": res.iterations.float().mean().item(),
          "diverged_fraction": res.diverged.float().mean().item(),
          "dead_fraction": res.dead.float().mean().item(),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    if launches == 0:
        fail("flagship", "megaroll was never launched on the main path")
    results["megaroll"]["launches"] = launches

    # the per-step path: one entry solve, megastep once per horizon step
    megaroll.launches = megastep.launches = any_lane.syncs = 0
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
    phase_build()
    results = {}
    phase_megastep(results)
    phase_megaroll(results)
    phase_small_chain()
    phase_flagship(results)
    print(card)
    emit({"kernels": [results["megastep"], results["megaroll"]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
