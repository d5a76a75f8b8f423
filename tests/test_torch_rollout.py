"""The port's linesearch rollouts against the JAX package's
``_chunk_rollout_lanes`` (solver/batched.py, scan path, ``fused=None``).

Both rollout kernels of the port (``fused``: megaroll; ``megastep``: one
step launch per horizon step) run their plain versions on CPU tensors,
so without a card the test pins the closed-loop policy, the candidate
lane folding (lane c*B + b), the tape layouts and the per-step costs
around the plain step; the CUDA kernels are held to those same plain
versions on the card (tests/test_torch_kernels.py, chip_smoke.py).
f64, 1e-5 (the per-step pin, tests/test_torch_lanestep.py)."""

from collections import namedtuple

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import JAX_QUICK_COMPILE, port_system_from_jax

T_STEPS, C, B = 6, 2, 3
_State = namedtuple("_State", "x_bar u_bar kappa K")


def _inputs(jmc, cfg, n, m):
    rng = np.random.default_rng(11)
    N = T_STEPS + 1
    Q, R, Qf = jmc.costs(cfg)
    x0, x_nom = jmc.initial_and_target(cfg)
    x0b = np.tile(x0, (B, 1))
    x0b[:, 19:] += 0.05 * rng.standard_normal((B, 18))
    prob = dict(x0=x0b, x_nom=np.tile(x_nom, (B, 1)),
                Q=np.tile(cfg.dt * Q, (B, 1, 1)),
                R=np.tile(cfg.dt * R, (B, 1, 1)), Qf=np.tile(Qf, (B, 1, 1)))
    state = _State(
        x_bar=np.tile(x0b[:, None], (1, N, 1))
        + 0.01 * rng.standard_normal((B, N, n)),
        u_bar=np.tile(jmc.U_STAND, (B, N - 1, 1))
        + 0.3 * rng.standard_normal((B, N - 1, m)),
        kappa=0.3 * rng.standard_normal((B, N - 1, m)),
        K=0.05 * rng.standard_normal((B, N - 1, m, n)))
    eps_cb = np.array([[1.0, 0.8, 0.6], [0.5, 0.4, 0.3]])
    return prob, state, eps_cb


@pytest.fixture(scope="module")
def rollout_case():
    from drake_ddp_tpu.examples import mini_cheetah as jmc
    from drake_ddp_tpu.solver.batched import _chunk_rollout_lanes as jroll
    from drake_ddp_tpu.solver.ilqr import ILQRProblem

    # contact_iters 2: the step itself is pinned at the flagship's 8 in
    # tests/test_torch_lanestep.py; here the policy and layouts around it
    cfg = jmc.Config(contact_iters=2)
    jsys, _ = jmc.build_system(cfg)
    prob, state, eps_cb = _inputs(jmc, cfg, jsys.n, jsys.m)
    jprob = ILQRProblem(**{k: jnp.asarray(v) for k, v in prob.items()},
                        u_init=None)
    jstate = _State(*map(jnp.asarray, state))
    ref = jax.jit(lambda p, s, e: jroll(jsys.lane_step_fn, p, s, e,
                                        cost_ceiling=1e4, fused=None),
                  compiler_options=JAX_QUICK_COMPILE)(
        jprob, jstate, jnp.asarray(eps_cb))
    ref = [np.asarray(a) for a in ref]
    return jsys, cfg, prob, state, eps_cb, ref


@pytest.mark.parametrize("rollout_kernel", ["fused", "megastep"])
def test_rollout_matches_jax_scan(rollout_case, rollout_kernel):
    from drake_ddp_tpu_torch.solver.batched import (_chunk_rollout_lanes,
                                                    _rollout_for)
    from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem

    jsys, cfg, prob, state, eps_cb, ref = rollout_case
    tsys = port_system_from_jax(jsys, contact_iters=cfg.contact_iters)
    t = lambda a: torch.as_tensor(a)
    got = _chunk_rollout_lanes(
        _rollout_for(tsys, rollout_kernel),
        ILQRProblem(**{k: t(v) for k, v in prob.items()}, u_init=None),
        _State(*map(t, state)), t(eps_cb), cost_ceiling=1e4)
    for name, g, r in zip(("x", "u", "L", "steps"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_megaroll_plain_matches_per_step_plain():
    """The fused rollout's plain version and a per-step loop over the
    megastep wrapper agree exactly on CPU (same plain step, same policy),
    and neither counts a kernel launch."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as tmc
    from drake_ddp_tpu_torch.ops.megaroll import megaroll, rollout_plain
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system

    system, _ = tmc.build_system(tmc.Config(contact_iters=2), device="cpu")
    kd = kernel_data_for_system(system)
    gen = torch.Generator().manual_seed(3)
    n, m, T, L = 37, 12, 3, 5
    x0, _ = tmc.initial_and_target(tmc.Config())
    x0 = torch.as_tensor(x0, dtype=torch.float32)[:, None].repeat(1, L)
    rnd = lambda *s: torch.randn(s, generator=gen)
    tapes = (x0, torch.rand(L, generator=gen),
             torch.as_tensor(tmc.U_STAND, dtype=torch.float32)[None, :, None]
             + 0.2 * rnd(T, m, L), 0.2 * rnd(T, m, L),
             0.02 * rnd(T, m, n, L), x0[None] + 0.01 * rnd(T, n, L))
    before = (megaroll.launches, megastep.launches)
    xs_f, us_f = megaroll(kd, *tapes)
    xs_s, us_s = rollout_plain(lambda x, u: megastep(kd, x, u), *tapes)
    assert torch.equal(xs_f, xs_s) and torch.equal(us_f, us_s)
    assert xs_f.shape == (T, n, L) and us_f.shape == (T, m, L)
    assert (megaroll.launches, megastep.launches) == before
