"""The slice as a whole: the port's ``mpc_solve_batched`` on the mini
cheetah against the JAX package's, both with ``deriv_kernel="lane"``
(root-seeded lane Jacobian) and the JAX scan rollout, at small sizes:
N 8, B 2, contact_iters 2, max_iters 2, one resolve, setInterval minN 4,
with the flagship's chain-health policy (policy warm start, rescue tape,
freeze latch, resolve cost ceiling, consec0 threading).

The JAX reference runs once, in f64.  The port's f64 chain must match
it: equal iterations, costs within 1e-6 relative.  The port's f32 chain
is held to the same f64 reference with the loose chain pin
(iterations +-1, costs 15%, the JAX package's chain-level pins),
and its configuration part q to rtol/atol 5e-2.  Joint velocities are
left out of the f32 pin: at contact_iters 2 a 1e-6 change of x0 moves
stiff-impact joint velocities by O(1) (measured up to 4.1 on this
chain) while q, costs and iterations stay inside the pin."""

import dataclasses

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import (JAX_QUICK_COMPILE, jax_cheetah_lane_jac,
                              port_system_from_jax)

N, B, CI, MAX_ITERS = 8, 2, 2, 2


def _arrays(jmc, cfg):
    Q, R, Qf = jmc.costs(cfg)
    x0, x_nom = jmc.initial_and_target(cfg)
    rng = np.random.default_rng(0)
    x0b = np.tile(x0, (B, 1))
    x0b[:, 19:] += 0.05 * rng.standard_normal((B, 18))
    prob = dict(x0=x0b, x_nom=np.tile(x_nom, (B, 1)),
                Q=np.tile(cfg.dt * Q, (B, 1, 1)),
                R=np.tile(cfg.dt * R, (B, 1, 1)), Qf=np.tile(Qf, (B, 1, 1)),
                u_init=np.tile(jmc.U_STAND, (B, N - 1, 1)),
                K_init=np.zeros((B, N - 1, 12, 37)),
                x_ref_init=np.tile(x0b[:, None], (1, N, 1)))
    shift = np.zeros(37)
    shift[4] = cfg.target_vel * cfg.dt * cfg.replan_steps
    rescue = np.tile(jmc.U_STAND, (N - 1, 1))
    solver = dict(num_steps=N, delta=cfg.delta, beta=cfg.beta,
                  max_iters=MAX_ITERS, ls_parallel=2, eps_min=1e-3,
                  ls_expected_floor=cfg.delta, cost_ceiling=1e4)
    mpc = dict(num_resolves=1, replan_steps=cfg.replan_steps,
               policy_warm_start=True, freeze_diverged=True, freeze_after=3,
               resolve_cost_ceiling=1e3)
    return prob, shift, rescue, solver, mpc


def _python_scan(f, init, xs, length=None):
    carry, ys = init, []
    for _ in range(length):
        carry, y = f(carry, None)
        ys.append(y)
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


class _LaxWithPythonScan:
    scan = staticmethod(_python_scan)

    def __getattr__(self, name):
        return getattr(jax.lax, name)


class _JaxWithPythonScan:
    lax = _LaxWithPythonScan()

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture(scope="module")
def chain():
    import drake_ddp_tpu.mpc.driver as jdriver
    import drake_ddp_tpu.solver.batched as jbatched
    from drake_ddp_tpu.examples import mini_cheetah as jmc
    from drake_ddp_tpu.solver import keypoints as jkp
    from drake_ddp_tpu.solver.ilqr import ILQRConfig, ILQRProblem

    cfg = jmc.Config(contact_iters=CI)
    jsys, _ = jmc.build_system(cfg)
    # the solve reaches the JAX lane Jacobian through a host callback into
    # the one compile that the lane Jacobian test shares (same function of
    # the same constants; compiled inside the solve it would take as long
    # again)
    n, m = jsys.n, jsys.m
    host_jac = jax_cheetah_lane_jac()          # built outside any trace

    def lane_jac_root(x, u, x_next):
        L = x.shape[-1]
        return jax.pure_callback(
            host_jac,
            (jax.ShapeDtypeStruct((n, n, L), x.dtype),
             jax.ShapeDtypeStruct((n, m, L), x.dtype)), x, u, x_next)

    jsys = dataclasses.replace(jsys, lane_jac_root_fn=lane_jac_root)
    prob, shift, rescue, solver, mpc = _arrays(jmc, cfg)
    scfg = ILQRConfig(derivs=jkp.DerivsInterpolation("setInterval", minN=4),
                      **solver)

    # compile time only: one jitted solve serves the entry solve and the
    # resolve (the resolve scan of mpc_solve_batched runs as a Python
    # loop)
    solve, jitted = jbatched.solve_ilqr_batched, {}

    def solve_once(system, cfg_, p, rollout_kernel, deriv_kernel):
        key = (rollout_kernel, deriv_kernel)
        if key not in jitted:
            jitted[key] = jax.jit(lambda q: solve(
                system, cfg_, q, rollout_kernel=rollout_kernel,
                deriv_kernel=deriv_kernel),
                compiler_options=JAX_QUICK_COMPILE)
        return jitted[key](p)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbatched, "solve_ilqr_batched", solve_once)
        mp.setattr(jdriver, "jax", _JaxWithPythonScan())
        ref = jdriver.mpc_solve_batched(
            jsys, scfg,
            ILQRProblem(**{k: jnp.asarray(v) for k, v in prob.items()},
                        frozen=jnp.zeros(B, bool)),
            jdriver.MPCConfig(**mpc), jnp.asarray(shift),
            rollout_kernel="lane", deriv_kernel="lane",
            consec0=jnp.zeros(B, jnp.int32), rescue_u=jnp.asarray(rescue))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return jsys, prob, shift, rescue, solver, mpc, ref


def _port_chain(chain, dtype):
    from drake_ddp_tpu_torch.mpc.driver import MPCConfig, mpc_solve_batched
    from drake_ddp_tpu_torch.solver import keypoints as tkp
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig, ILQRProblem

    jsys, prob, shift, rescue, solver, mpc, _ = chain
    tsys = port_system_from_jax(jsys, contact_iters=CI)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    scfg = ILQRConfig(derivs=tkp.DerivsInterpolation("setInterval", minN=4),
                      **solver)
    return mpc_solve_batched(
        tsys, scfg,
        ILQRProblem(**{k: t(v) for k, v in prob.items()},
                    frozen=torch.zeros(B, dtype=torch.bool)),
        MPCConfig(**mpc), t(shift), rollout_kernel="fused",
        deriv_kernel="lane", consec0=torch.zeros(B, dtype=torch.int32),
        rescue_u=t(rescue))


def _check_shapes(got, ref):
    for name in ("states", "costs", "iterations", "diverged", "final_x",
                 "final_u", "final_K", "dead", "consec"):
        assert tuple(getattr(got, name).shape) == \
            getattr(ref, name).shape, name
    np.testing.assert_array_equal(got.diverged.numpy(), ref.diverged)
    np.testing.assert_array_equal(got.dead.numpy(), ref.dead)
    np.testing.assert_array_equal(got.consec.numpy(), ref.consec)


def test_mpc_chain_matches_jax_f64(chain):
    ref = chain[-1]
    got = _port_chain(chain, torch.float64)
    _check_shapes(got, ref)
    np.testing.assert_array_equal(got.iterations.numpy(), ref.iterations)
    np.testing.assert_allclose(got.costs.numpy(), ref.costs, rtol=1e-6)
    np.testing.assert_allclose(got.states.numpy(), ref.states, rtol=1e-6,
                               atol=1e-6)


def test_mpc_chain_f32_within_chain_pin(chain):
    ref = chain[-1]
    got = _port_chain(chain, torch.float32)
    _check_shapes(got, ref)
    d_it = np.abs(got.iterations.numpy().astype(np.int64)
                  - ref.iterations.astype(np.int64))
    assert d_it.max() <= 1
    np.testing.assert_allclose(got.costs.double().numpy(), ref.costs,
                               rtol=0.15)
    np.testing.assert_allclose(got.states[..., :19].double().numpy(),
                               ref.states[..., :19], rtol=5e-2, atol=5e-2)
    assert torch.isfinite(got.states).all()
