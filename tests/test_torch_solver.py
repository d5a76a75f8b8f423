"""The port's keypoint interpolation, per-step costs, Cholesky solve and
batched Riccati sweep against the JAX package (solver/keypoints.py,
solver/ilqr.py, utils/linalg.py), in f64 on seeded numpy inputs.

The keypoint path is driven through an analytic lane "Jacobian" written
once per framework, so the test pins the gather of keypoint lanes, the
root-seeded next-state argument, the layouts and the static lerp, not
the dynamics (tests/test_torch_lanejac.py pins those)."""

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402


def _analytic_jac(lib):
    sin, cos = (jnp.sin, jnp.cos) if lib is jnp else (torch.sin, torch.cos)

    def jac_T(x, u, x_next):
        fx = sin(x)[:, None] * x_next[None] + 0.1 * x[None]
        fu = cos(u)[None] * x_next[:, None]
        return fx, fu

    return jac_T


@pytest.mark.parametrize("minN", [8, 1])
def test_set_interval_derivatives_match_jax(minN):
    from drake_ddp_tpu.solver import keypoints as jkp
    from drake_ddp_tpu_torch.solver import keypoints as tkp

    rng = np.random.default_rng(0)
    B, N, n, m = 3, 17, 5, 2
    x = rng.standard_normal((B, N, n))
    u = rng.standard_normal((B, N - 1, m))
    ref = jkp.compute_derivatives_batched(
        _analytic_jac(jnp), jkp.DerivsInterpolation("setInterval", minN=minN),
        jnp.asarray(x), jnp.asarray(u), root=True)
    got = tkp.compute_derivatives_batched(
        _analytic_jac(torch), tkp.DerivsInterpolation("setInterval",
                                                      minN=minN),
        torch.as_tensor(x), torch.as_tensor(u), root=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)
    mask = tkp.set_interval_mask(N, minN)
    np.testing.assert_array_equal(mask, jkp.set_interval_mask(N, minN))


def test_set_interval_needs_a_keypoint_at_zero():
    """arange(0, N-1, minN) = [0] with its last element replaced by N-2
    leaves no keypoint at t = 0; the JAX lookup would wrap, the port
    refuses.  An adaptiveJerk mask whose only keypoint is the forced last
    one (a flat trajectory, maxN beyond the horizon) is the JAX package's
    data-dependent case of the same wrap, and the port follows it: every
    step reads the last step's Jacobian, as in JAX."""
    from drake_ddp_tpu.solver import keypoints as jkp
    from drake_ddp_tpu_torch.solver import keypoints as tkp

    x, u = torch.zeros(1, 5, 3), torch.zeros(1, 4, 1)
    with pytest.raises(ValueError, match="no keypoint at t = 0"):
        tkp.compute_derivatives_batched(
            _analytic_jac(torch), tkp.DerivsInterpolation("setInterval",
                                                          minN=8),
            x, u, root=True)
    rng = np.random.default_rng(2)
    x = np.zeros((1, 5, 3)) + rng.standard_normal(3)
    u = rng.standard_normal((1, 4, 1))
    cfg = ("adaptiveJerk", 2, 9)
    got = tkp.compute_derivatives_batched(
        _analytic_jac(torch), tkp.DerivsInterpolation(*cfg),
        torch.as_tensor(x), torch.as_tensor(u), root=True)
    want = jkp.compute_derivatives_batched(
        _analytic_jac(jnp), jkp.DerivsInterpolation(*cfg), jnp.asarray(x),
        jnp.asarray(u), root=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    assert float(got[2][0]) == pytest.approx(25.0)
    assert torch.equal(got[0][0, 0], got[0][0, 3])


def _problem(rng, B, N, n, m):
    def spd(k, scale):
        a = rng.standard_normal((B, k, k))
        return scale * (np.einsum("bij,bkj->bik", a, a) / k + np.eye(k))

    return dict(x0=rng.standard_normal((B, n)),
                x_nom=rng.standard_normal((B, n)), Q=spd(n, 0.5),
                R=spd(m, 0.1), Qf=spd(n, 2.0),
                u_init=rng.standard_normal((B, N - 1, m)))


def test_cost_steps_and_riccati_match_jax():
    from drake_ddp_tpu.solver.ilqr import (ILQRConfig as JCfg,
                                           ILQRProblem as JProb,
                                           _backward_pass as jbp,
                                           _cost_steps as jcost)
    from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig as TCfg,
                                                 ILQRProblem as TProb,
                                                 _backward_pass as tbp,
                                                 _cost_steps as tcost)

    rng = np.random.default_rng(1)
    B, N, n, m = 3, 9, 7, 3
    p = _problem(rng, B, N, n, m)
    x = rng.standard_normal((B, N, n))
    u = p["u_init"]
    fx = np.eye(n) + 0.1 * rng.standard_normal((B, N - 1, n, n))
    fu = 0.3 * rng.standard_normal((B, N - 1, n, m))
    reg = np.array([1e-6, 1e-3, 1e-1])
    jp = JProb(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = TProb(**{k: torch.as_tensor(v) for k, v in p.items()})

    ref = jax.vmap(jcost)(jp, jnp.asarray(x), jnp.asarray(u))
    got = tcost(tp, torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)

    ref = jax.vmap(lambda pp, xx, uu, a, b, r: jbp(
        JCfg(num_steps=N), pp, xx, uu, a, b, reg=r))(
        jp, jnp.asarray(x), jnp.asarray(u), jnp.asarray(fx),
        jnp.asarray(fu), jnp.asarray(reg))
    got = tbp(TCfg(num_steps=N), tp, torch.as_tensor(x), torch.as_tensor(u),
              torch.as_tensor(fx), torch.as_tensor(fu), torch.as_tensor(reg))
    for name, g, r in zip(("kappa", "K", "dV"), got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        scale = np.abs(r).max()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-8,
                                   atol=1e-8 * scale, err_msg=name)


def test_solve_spd_matches_jax_and_flags_indefinite():
    from drake_ddp_tpu.utils.linalg import solve_spd as jsolve
    from drake_ddp_tpu_torch.utils.linalg import solve_spd as tsolve

    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 12, 12))
    A = np.einsum("bij,bkj->bik", a, a) + 0.5 * np.eye(12)
    b = rng.standard_normal((4, 12, 13))
    np.testing.assert_allclose(
        tsolve(torch.as_tensor(A), torch.as_tensor(b)).numpy(),
        np.asarray(jsolve(jnp.asarray(A), jnp.asarray(b))), rtol=1e-9,
        atol=1e-10)
    v = rng.standard_normal((4, 12))
    np.testing.assert_allclose(
        tsolve(torch.as_tensor(A), torch.as_tensor(v)).numpy(),
        np.linalg.solve(A, v[..., None])[..., 0], rtol=1e-9, atol=1e-10)
    A[1] = -A[1]                  # indefinite: NaN for that matrix only
    out = tsolve(torch.as_tensor(A), torch.as_tensor(v))
    assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2, 3]]).all()


def test_lane_step_from_scalar_matches_jax():
    """``lane_step_from_scalar``, the per-scenario step vmapped over a
    trailing lane axis, against the JAX package's wrapper on random
    float64 lanes of the pendulum and the cart-pole, and against the
    port's own step lane by lane; the wrapped step is a
    ``dynamics.base.StepFn`` bound to its params."""
    from drake_ddp_tpu.dynamics import analytic as jan
    from drake_ddp_tpu.multibody.lanestep import (
        lane_step_from_scalar as jwrap)
    from drake_ddp_tpu_torch.dynamics import analytic as tan
    from drake_ddp_tpu_torch.dynamics import base
    from drake_ddp_tpu_torch.multibody.lanestep import (
        lane_step_from_scalar as twrap)

    assert base.StepFn.__origin__ is base.Callable.__origin__
    rng = np.random.default_rng(11)
    L = 7
    for system in ("pendulum", "cart_pole"):
        jsys = getattr(jan, f"{system}_system")(dt=0.01)
        tsys = getattr(tan, f"{system}_system")(dt=0.01)
        x = rng.normal(size=(tsys.n, L))
        u = rng.normal(size=(tsys.m, L))
        want = np.asarray(jwrap(jsys.bound_step())(jnp.asarray(x),
                                                    jnp.asarray(u)))
        step = tsys.bound_step()
        got = twrap(step)(torch.as_tensor(x), torch.as_tensor(u))
        assert got.shape == (tsys.n, L) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)
        for i in range(L):
            lane = step(torch.as_tensor(x[:, i]), torch.as_tensor(u[:, i]))
            np.testing.assert_array_equal(got[:, i].numpy(), lane.numpy())
