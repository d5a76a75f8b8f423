"""The Panda side task's solve, one iLQR round at a time, JAX against the
port on identical inputs (teacher-forced lockstep), in float64 on the CPU.

JAX's per-scenario loop is driven round by round from its module-level
phases (``_linesearch``, ``keypoints.compute_derivatives``,
``_backward_pass``) and the round logic of ``solve_ilqr``; at every round
the port's phases get JAX's iterate (``x_bar``, ``u_bar``, the gains, the
regularization, the cost) and JAX's phase inputs, so chaos cannot build
up between rounds:

- the linesearch (``_linesearch_batched`` at B = 1 on the megaroll
  route, on CPU tensors its plain rollout): the accepted step size, the
  candidates tried, the failure and floor flags (equal), the accepted
  trajectory, cost and improvement;
- the derivative stack at JAX's accepted trajectory (the cold megajac
  route, on CPU tensors the plain cold lane Jacobian): ``fx``, ``fu`` and
  ``percent_derivs``;
- the Riccati sweep on JAX's stack: ``K``, ``kappa`` and the expected
  reduction;
- the regularization update and the retry and divergence flags
  (``_round_flags``), and the stopping test (``_lane_cond``).

A discrete choice that differs on identical inputs is a fault of the
port, and so is a continuous output more than ``REL`` apart (relative to
the output's largest entry; ten times the per-step float64 pin of
tests/test_torch_manipulation.py).  Every phase's largest relative
difference is printed for every round (``-s``), and JAX's round-by-round
loop is held to JAX's own ``solve_ilqr`` (iterations, cost).

    python -m pytest -m slow tests/test_torch_panda_lockstep.py -s

At the example's ``Config()`` (T 0.5, N 50, contact_iters 8, 69 contacts,
no noise) it takes a few minutes on one core: the JAX compiles and the
port's plain float64 rollouts and Jacobians.
"""

import math

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

REL = 1e-4


def _rel(got, want, scale=0.0):
    """Largest |got - want| over the largest |want| (or ``scale`` if that
    is larger; entries both infinite and equal count as equal)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same = (got == want)
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(got - want))
    scale = max(scale, np.abs(np.where(np.isfinite(want), want, 0.0)).max(
        initial=0.0))
    return float(d.max(initial=0.0) / max(scale, 1e-300))


def _jax_round_logic(cfg, state, ls_out, derivs, backward, prob):
    """JAX ``solve_ilqr``'s ``forward_and_backward`` after its linesearch
    (drake_ddp_tpu/solver/ilqr.py), on host values: returns the round's
    pieces and the next state."""
    from drake_ddp_tpu.solver.ilqr import ILQRStats, _LoopState

    eps, x, u, L_new, imp, ls_iters, failed, floor_cut = ls_out
    failed = bool(failed)
    x_use = state.x_bar if failed else x
    u_use = state.u_bar if failed else u
    L_use = state.L if failed else L_new
    adaptive = cfg.reg > 0.0
    reg = float(state.reg)
    reg_new = ((reg * cfg.reg_mult if failed
                else max(reg / cfg.reg_mult, cfg.reg)) if adaptive else reg)
    it = int(state.iteration)
    at_optimum = ((float(jnp.sum(state.dV_coeff)) <= cfg.delta
                   or bool(floor_cut)) and it > 0
                  and math.isfinite(float(state.L)))
    exhausted = (not adaptive) or reg >= cfg.reg_max or at_optimum
    retry = failed and not exhausted
    diverged = failed and exhausted and not at_optimum
    fresh = not (failed and it > 0)
    if fresh:
        fx, fu, pct = derivs(x_use, u_use)
    else:
        fx, fu, pct = state.fx, state.fu, 0.0
    pct = 0.0 if failed else float(pct)
    dt = state.x_bar.dtype
    kappa, K, dV = backward(prob, x_use, u_use, fx, fu,
                            jnp.asarray(reg_new, dt))
    st = state.stats
    stats = ILQRStats(
        cost=st.cost.at[it].set(L_use),
        eps=st.eps.at[it].set(0.0 if failed else eps),
        ls_iters=st.ls_iters.at[it].set(ls_iters),
        percent_derivs=st.percent_derivs.at[it].set(pct))
    new = _LoopState(
        x_bar=x_use, u_bar=u_use, fx=fx, fu=fu, kappa=kappa, K=K,
        dV_coeff=dV, L=jnp.asarray(L_use, dt),
        improvement=jnp.asarray(0.0 if failed else imp, dt),
        iteration=jnp.asarray(it + 1, jnp.int32),
        reg=jnp.asarray(reg_new, dt), retry=jnp.asarray(retry),
        diverged=jnp.asarray(diverged), stats=stats)
    pieces = dict(x_use=x_use, u_use=u_use, fresh=fresh, fx=fx, fu=fu,
                  pct=pct, reg_new=reg_new, retry=retry, diverged=diverged,
                  kappa=kappa, K=K, dV=dV)
    return pieces, new


def _jax_cond(cfg, state):
    return bool(((float(state.improvement) > cfg.delta) or bool(state.retry))
                and int(state.iteration) < cfg.max_iters
                and not bool(state.diverged))


def lockstep(cfg_kw, log=print):
    """Run the Panda side task at ``panda_fr3.Config(**cfg_kw)`` round by
    round in both packages (see the module docstring), ``log`` each
    round's report.  Returns the reports: one dict per round with each
    phase's largest relative difference and its discrete outputs on both
    sides, and ``faults``, the (round, phase, what) that crossed ``REL``
    or differed."""
    from drake_ddp_tpu.examples import panda_fr3 as jp
    from drake_ddp_tpu.solver import ilqr as jil
    from drake_ddp_tpu.solver import keypoints as jkp
    from drake_ddp_tpu_torch.examples import panda_fr3 as tp
    from drake_ddp_tpu_torch.solver import batched as tb
    from drake_ddp_tpu_torch.solver import ilqr as til
    from drake_ddp_tpu_torch.solver import keypoints as tkp

    jilqr = jp.build_solver(jp.Config(verbose=False, **cfg_kw))
    tilqr = tp.build_solver(tp.Config(verbose=False, **cfg_kw),
                            device="cpu")
    jcfg = jilqr.config
    tcfg = tilqr.config
    assert tuple(tcfg._replace(derivs=None)) == tuple(
        jcfg._replace(derivs=None)), (tcfg, jcfg)
    assert tuple(tcfg.derivs) == tuple(jcfg.derivs)
    tsys = tilqr.system
    routes = til.scenario_routes(tsys)
    assert routes == dict(rollout_kernel="fused", deriv_kernel="megajac",
                          root_seed=False)
    rollout = tb._rollout_for(tsys, routes["rollout_kernel"])
    jac, root = tb._jac_for(tsys, routes["deriv_kernel"], False)

    f64 = jnp.float64
    jprob = jilqr._problem(f64)
    T = lambda a: torch.as_tensor(np.array(a))[None]
    tprob = til.ILQRProblem(*(T(a) for a in jprob[:6]))
    step = jilqr.system.bound_step()
    jls = jax.jit(lambda p, s: jil._linesearch(step, jcfg, p, s))
    jder = jax.jit(lambda x, u: jkp.compute_derivatives(
        step, jcfg.derivs, x, u))
    jbwd = jax.jit(lambda p, x, u, fx, fu, reg: jil._backward_pass(
        jcfg, p, x, u, fx, fu, reg))

    N, n, m = jcfg.num_steps, jilqr.n, jilqr.m
    z = lambda *s: jnp.zeros(s, f64)
    state = jil._LoopState(
        x_bar=z(N, n), u_bar=jprob.u_init, fx=z(N - 1, n, n),
        fu=z(N - 1, n, m), kappa=z(N - 1, m), K=z(N - 1, m, n),
        dV_coeff=z(N - 1), L=jnp.asarray(jnp.inf, f64),
        improvement=jnp.asarray(jnp.inf, f64),
        iteration=jnp.asarray(0, jnp.int32), reg=jnp.asarray(jcfg.reg, f64),
        retry=jnp.asarray(False), diverged=jnp.asarray(False),
        stats=jil.ILQRStats(z(jcfg.max_iters), z(jcfg.max_iters),
                            jnp.zeros(jcfg.max_iters, jnp.int32),
                            z(jcfg.max_iters)))

    def port_state(s):
        return til._LoopState(*(
            til.ILQRStats(*map(T, a)) if isinstance(a, tuple) else T(a)
            for a in s))

    rounds, faults = [], []
    while _jax_cond(jcfg, state):
        r = int(state.iteration)
        rep = {"round": r}
        ts = port_state(state)

        def check(phase, what, got, want, discrete=False, scale=0.0):
            if discrete:
                ok = bool(np.all(np.asarray(got) == np.asarray(want)))
                rep[f"{phase}.{what}"] = (np.asarray(got).tolist(),
                                          np.asarray(want).tolist())
            else:
                d = _rel(got, want, scale)
                rep[f"{phase}.{what}"] = d
                ok = d <= REL
            if not ok:
                faults.append((r, phase, what))

        # the linesearch on JAX's iterate
        jout = jax.device_get(jls(jprob, state))
        (eps, x, u, L, imp, nit, failed,
         floor_cut) = tb._linesearch_batched(rollout, tcfg, tprob, ts)
        for what, g, w in (("eps", eps, jout[0]), ("ls_iters", nit, jout[5]),
                           ("failed", failed, jout[6]),
                           ("floor_cut", floor_cut, jout[7])):
            check("linesearch", what, g[0].numpy(), w, discrete=True)
        for what, g, w in (("x", x, jout[1]), ("u", u, jout[2]),
                           ("cost", L, jout[3])):
            check("linesearch", what, g[0].numpy(), w)
        # a difference of two costs: relative to the incumbent's cost
        L_bar = float(state.L)
        check("linesearch", "improvement", imp[0].item(), jout[4],
              scale=L_bar if math.isfinite(L_bar) else 0.0)

        pieces, new = _jax_round_logic(jcfg, state, jout, jder, jbwd, jprob)
        # the regularization update and the flags on JAX's state and flags
        reg_new, retry, diverged = tb._round_flags(
            tcfg, ts, torch.tensor([bool(jout[6])]),
            torch.tensor([bool(jout[7])]))
        check("flags", "reg", reg_new[0].item(), pieces["reg_new"])
        check("flags", "retry", retry[0].item(), pieces["retry"], True)
        check("flags", "diverged", diverged[0].item(), pieces["diverged"],
              True)

        # the derivative stack at JAX's accepted trajectory
        if pieces["fresh"]:
            fx, fu, pct = tkp.compute_derivatives_batched(
                jac, tcfg.derivs, T(pieces["x_use"]), T(pieces["u_use"]),
                root=root)
            check("derivs", "fx", fx[0].numpy(), pieces["fx"])
            check("derivs", "fu", fu[0].numpy(), pieces["fu"])
            if not bool(jout[6]):
                check("derivs", "percent", pct[0].item(), pieces["pct"],
                      True)

        # the Riccati sweep on JAX's stack
        kappa, K, dV = til._backward_pass(
            tcfg, tprob, T(pieces["x_use"]), T(pieces["u_use"]),
            T(pieces["fx"]), T(pieces["fu"]),
            torch.tensor([pieces["reg_new"]], dtype=torch.float64))
        check("riccati", "kappa", kappa[0].numpy(), pieces["kappa"])
        check("riccati", "K", K[0].numpy(), pieces["K"])
        check("riccati", "dV", dV[0].numpy(), pieces["dV"])

        # the stopping test on JAX's next state
        state = new
        go = tb._lane_cond(tcfg, tprob, port_state(state))[0].item()
        check("stop", "continue", go, _jax_cond(jcfg, state), True)
        rounds.append(rep)
        log(rep)
    return {"rounds": rounds, "faults": faults, "state": state,
            "jilqr": jilqr}


@pytest.mark.slow
def test_panda_lockstep_rounds_match_jax():
    """Every round of the Panda side task at the example's ``Config()``:
    the port's phases on JAX's iterate match JAX's, discrete outputs
    equal and continuous ones within ``REL``; and the round-by-round
    loop is JAX's own ``solve_ilqr``."""
    from drake_ddp_tpu.solver.ilqr import solve_ilqr as jsolve

    out = lockstep({})
    rounds, state = out["rounds"], out["state"]
    assert len(rounds) >= 3
    assert not out["faults"], out["faults"]
    jilqr = out["jilqr"]
    ref = jax.jit(lambda p: jsolve(jilqr.system, jilqr.config, p))(
        jilqr._problem(jnp.float64))
    assert int(ref.iterations) == int(state.iteration) == len(rounds)
    np.testing.assert_allclose(float(state.L), float(ref.cost), rtol=1e-9)
