"""The comparison that decides ``correct``: what the timed path produced,
held to the plain reference once the window has closed.

The reference (``portbench/reference``) builds the configuration's model
again from its own files and recomputes, in float64, from the program's
own trajectories:

- the rollout: every step x_{t+1} of a checked trajectory against the
  reference step from (x_t, u_t), the lane step through contact;
- the step Jacobian, the keypoint interpolation and the Riccati sweep:
  the program's feedback gains against the reference's gains of the same
  trajectory, through the reference's Jacobians (root-seeded at the
  trajectory's own next states on the MPC path, cold elsewhere);
- the cost of each trajectory;
- the MPC handoff, exactly: a healthy resolve starts at the state handed
  to it, a failed one coasts on exactly the policy handed to it, and the
  failure count and the dead latch follow the chain's rule.

Independent solves of one lane diverge chaotically, and a float32 tape
replayed open loop through stiff contact drifts over the horizon, so
nothing is re-solved or replayed: each step and each gain is judged from
the program's own states.  The Levenberg term in Quu is not part of the
solution; the gains are held to the reference's at the regularization of
the Levenberg ladder (reg x reg_mult^k up to reg_max x reg_mult) that
matches them best.

``control=True`` puts the reference in the program's place at the next
precision below the configuration's float32: the step and the cost in
bfloat16 and the Riccati sweep's products in TF32 (each operand rounded
to TF32's mantissa, so that it does not hang on which kernel cuBLAS
picks for a shape), each from the same trajectories, judged by the same
numbers.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import robot
from portbench.reference.solver import (interpolate, riccati_gains,
                                        set_interval_steps, tf32_matmul,
                                        trajectory_cost)

CROSSING = 1e-4        # a step gap this large is a flip of the contact solve
STEP_BLOCK = 8192      # lane-steps per reference step call
JAC_BLOCK = 512        # lanes per reference Jacobian call


class Reference:
    """The configuration's reference model on ``device``."""

    def __init__(self, cfg: Dict, device):
        self.cfg = cfg
        _, _, self.step, self.jac, self.jac_root = robot.build(
            cfg["model"], device)
        s = cfg["solver"]
        self.reg_ladder = [s["reg"] * s["reg_mult"] ** k
                           for k in range(40)
                           if s["reg"] * s["reg_mult"] ** k
                           <= s["reg_max"] * s["reg_mult"]]


def _blocks(L: int, size: int):
    return [slice(a, min(a + size, L)) for a in range(0, L, size)]


def step_gaps(ref: Reference, x, u, control=False):
    """(H, N-1) largest state gap of each step of trajectories x (H, N,
    n), u (H, N-1, m): the program's x_{t+1} (or, for the control, the
    reference step in bfloat16) against the float64 reference step."""
    H, N, n = x.shape
    xs = x[:, :-1].reshape(-1, n).T
    us = u.reshape(-1, u.shape[-1]).T
    nxt = x[:, 1:].reshape(-1, n).T
    out = []
    for sl in _blocks(xs.shape[1], STEP_BLOCK):
        truth = ref.step(xs[:, sl].double().contiguous(),
                         us[:, sl].double().contiguous())
        got = (ref.step(xs[:, sl].bfloat16().contiguous(),
                        us[:, sl].bfloat16().contiguous()).double()
               if control else nxt[:, sl].double())
        gap = (got - truth).abs().amax(dim=0)
        out.append(torch.where(torch.isnan(gap), float("inf"), gap))
    return torch.cat(out).reshape(H, N - 1)


def reference_jacobians(ref: Reference, x, u, root: bool, keypoints):
    """float64 (fx, fu) at the keypoint steps of trajectories x (H, N,
    n), u (H, N-1, m): (H, K, n, n), (H, K, n, m)."""
    H, N, n = x.shape
    m = u.shape[-1]
    k = torch.as_tensor(keypoints, device=x.device)
    lane = lambda a, d: a.reshape(-1, d).T.double().contiguous()
    xk, uk, xn = lane(x[:, k], n), lane(u[:, k], m), lane(x[:, k + 1], n)
    fxs, fus = [], []
    for sl in _blocks(xk.shape[1], JAC_BLOCK):
        fx, fu = (ref.jac_root(xk[:, sl], uk[:, sl], xn[:, sl]) if root
                  else ref.jac(xk[:, sl], uk[:, sl]))
        fxs.append(fx)
        fus.append(fu)
    K = len(keypoints)
    fx = torch.cat(fxs, -1).reshape(n, n, H, K).permute(2, 3, 0, 1)
    fu = torch.cat(fus, -1).reshape(n, m, H, K).permute(2, 3, 0, 1)
    return fx, fu


def gain_gaps(ref: Reference, x, u, K_prog, prob, root: bool,
              control=False):
    """(H,) relative gain gap of each trajectory: the largest entry of
    |K_program - K_reference| over the horizon, over the reference's
    largest gain, at the ladder's regularization that fits best."""
    cfg = ref.cfg
    N = x.shape[1]
    kp = cfg["solver"]["keypoints"]
    keys = set_interval_steps(N, kp["minN"])
    fx_k, fu_k = reference_jacobians(ref, x, u, root, keys)
    fx, fu = interpolate(N, keys, fx_k), interpolate(N, keys, fu_k)
    H = x.shape[0]
    best = torch.full((H,), float("inf"), dtype=torch.float64,
                      device=x.device)
    d = lambda a: a.double()
    for reg in ref.reg_ladder:
        r = torch.full((H,), reg, dtype=torch.float64, device=x.device)
        K_ref = riccati_gains(d(x), d(u), fx, fu, d(prob[0]), d(prob[1]),
                              d(prob[2]), d(prob[3]), r)
        if control:
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                f = lambda a: a.float()
                got = riccati_gains(f(x), f(u), f(fx), f(fu), f(prob[0]),
                                    f(prob[1]), f(prob[2]), f(prob[3]),
                                    r.float(), mm=tf32_matmul).double()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
        else:
            got = d(K_prog)
        scale = K_ref.abs().flatten(1).amax(1)
        gap = (got - K_ref).abs().flatten(1).amax(1) / scale
        gap = torch.where(torch.isnan(gap), float("inf"), gap)
        best = torch.minimum(best, gap)
    return best


def cost_gaps(x, u, cost_prog, prob, control=False):
    """(H,) relative gap of each trajectory's cost against the float64
    reference cost (the control: the reference cost in bfloat16)."""
    d = lambda a: a.double()
    truth = trajectory_cost(d(x), d(u), *map(d, prob))
    if control:
        b = lambda a: a.bfloat16()
        got = trajectory_cost(b(x), b(u), *map(b, prob)).double()
    else:
        got = d(cost_prog)
    gap = (got - truth).abs() / truth.abs()
    return torch.where(torch.isnan(gap), float("inf"), gap)


def _summary(step: List[torch.Tensor], gain: List[torch.Tensor],
             cost: List[torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of the checked trajectories' step gaps (H,
    N-1), gain gaps and cost gaps (H,): quantiles and shares of the steps
    (contact flips are sporadic), and the largest of each trajectory's
    median step gap (a lane that is wrong is wrong at every step)."""
    out = {}
    if step:
        s = torch.cat([a.flatten() for a in step])
        q = lambda p: float(torch.quantile(
            torch.where(torch.isfinite(s), s, 1e30).float(), p))
        out.update(
            step_lane_steps=float(s.numel()), step_gap_max=float(s.max()),
            step_gap_median=q(0.5), step_gap_q90=q(0.9), step_gap_q99=q(0.99),
            step_flip_share=float((s > CROSSING).double().mean()),
            step_share_over_1e2=float((s > 1e-2).double().mean()),
            lane_step_gap_median_max=float(torch.cat(
                [a.median(dim=1).values for a in step]).max()))
    if gain:
        g = torch.cat(gain)
        q = lambda p: float(torch.quantile(
            torch.where(torch.isfinite(g), g, 1e30).float(), p))
        out.update(gain_lanes=float(g.numel()), gain_gap_max=float(g.max()),
                   gain_gap_median=q(0.5), gain_gap_q90=q(0.9))
    if cost:
        c = torch.cat(cost)
        out.update(cost_gap_max=float(c.max()),
                   cost_gap_median=float(c.median()))
    return out


def mpc_readings(ref: Reference, records: List[Dict], mpc: Dict,
                 control=False) -> Dict[str, float]:
    """The numbers of an MPC chain's checked resolves."""
    steps, gains, costs = [], [], []
    handoff = 0
    for rec in records:
        prob, consec0, res = rec["prob"], rec["consec0"], rec["res"]
        dead0 = prob.frozen
        div = res.diverged[:, 0]
        cost = res.costs[:, 0]
        ok = ~div
        # the handoff, exactly
        same = lambda a, b: (a == b).flatten(1).all(1)
        bad = torch.zeros_like(div)
        bad |= ok & ~same(res.final_x[:, 0], prob.x0)
        bad |= div & ~(same(res.final_x, prob.x_ref_init)
                       & same(res.final_u, prob.u_init)
                       & same(res.final_K, prob.K_init))
        consec = torch.where(div & ~dead0, consec0 + 1,
                             torch.zeros_like(consec0))
        bad |= consec != res.consec
        dead = dead0 | (consec >= mpc["freeze_after"])
        bad |= dead != res.dead
        bad |= ~(cost <= mpc["resolve_cost_ceiling"]) & ok
        bad |= dead0 & ok
        handoff += int(bad.sum())
        if not bool(ok.any()):
            continue
        x, u, K = res.final_x[ok], res.final_u[ok], res.final_K[ok]
        P = (prob.x_nom[ok], prob.Q[ok], prob.R[ok], prob.Qf[ok])
        steps.append(step_gaps(ref, x, u, control))
        gains.append(gain_gaps(ref, x, u, K, P, root=True, control=control))
        costs.append(cost_gaps(x, u, cost[ok], P, control))
    out = _summary(steps, gains, costs)
    out["handoff_mismatches"] = float(handoff)
    out["resolves_checked"] = float(len(records))
    return out


def multistart_readings(ref: Reference, records: List[Dict], prob,
                        control=False) -> Dict[str, float]:
    """The numbers of the multi-start batches' checked starts: of every
    batch the best and a sample drawn from the seed, diverged or not;
    a start that ended non-finite is the run's ``failed`` (when it did
    not diverge), not a number here.  The pick is held to the lowest
    cost among the batch's finite starts that did not diverge."""
    mismatches = unusable = 0
    xs, us, Ks, cs = [], [], [], []
    for rec in records:
        costs, div = rec["costs"], rec["diverged"]
        score = torch.where(div | ~torch.isfinite(costs), float("inf"),
                            costs.double())
        best = int(rec["best_index"])
        mismatches += int(bool(score[best] != score.min())
                          or bool(costs[best] != rec["cost"][-1]))
        unusable += int(not bool(torch.isfinite(score.min())))
        ok = rec["checked_usable"]
        xs.append(rec["x"][ok])
        us.append(rec["u"][ok])
        Ks.append(rec["K"][ok])
        cs.append(rec["cost"][ok])
    out = {}
    if xs:
        x, u, K, c = (torch.cat(a) for a in (xs, us, Ks, cs))
        if x.shape[0]:
            H = x.shape[0]
            P = tuple(a[None].expand(H, *a.shape)
                      for a in (prob.x_nom, prob.Q, prob.R, prob.Qf))
            out = _summary([step_gaps(ref, x, u, control)],
                           [gain_gaps(ref, x, u, K, P, root=False,
                                      control=control)],
                           [cost_gaps(x, u, c, P, control)])
    out["best_mismatches"] = float(mismatches)
    out["batches_checked"] = float(len(records))
    out["best_unusable"] = float(unusable)
    return out


def judge(readings: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """Each compared number beside its limit; a number missing from the
    readings (nothing of its kind was checked) reads as infinity."""
    return {name: {"value": readings.get(name, float("inf")),
                   "limit": lim}
            for name, lim in limits.items()}


def passed(judged: Dict[str, Dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in judged.values())
