"""The port's structured-IFT lane Jacobians
(drake_ddp_tpu_torch/multibody/lanejac.py) against the JAX package's
``make_lane_jac``, root-seeded on the cheetah and cold-Newton on a small
model of every contact family, and against central finite differences
of the port's own plain step.

The finite-difference check runs with a constant stiction schedule
(stiction_vel at the 5e-2 cap): the implicit-function theorem
differentiates the root of the final-width residual, and with the
default continuation only the last Newton iteration runs at the final
width, so the step map's output is not yet that root and differs from
its derivative by a few percent of scale (measured 5.7% on these
states, unchanged from contact_iters 8 to 16 and from h = 1e-5 to 1e-6).
With a converged Newton the two agree to ~3e-8 of scale."""

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import (JAX_QUICK_COMPILE, jax_cheetah_lane_jac,
                              port_system_from_jax, small_families)


def _states(jmc, B, seed):
    x0, _ = jmc.initial_and_target(jmc.Config())
    rng = np.random.default_rng(seed)
    xb = np.tile(np.asarray(x0, np.float64), (B, 1))
    xb[:, 19:] += 0.2 * rng.standard_normal((B, 18))
    xb[:, 4:7] += 0.01 * rng.standard_normal((B, 3))
    ub = np.tile(np.asarray(jmc.U_STAND, np.float64), (B, 1))
    ub += 0.5 * rng.standard_normal(ub.shape)
    return xb.T, ub.T


def test_root_seeded_lane_jac_matches_jax():
    from drake_ddp_tpu.examples import mini_cheetah as jmc

    jsys, _ = jmc.build_system(jmc.Config(contact_iters=8))
    tsys = port_system_from_jax(jsys, contact_iters=8)
    x, u = _states(jmc, 4, 0)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    xn = tsys.lane_step_fn(xt, ut)
    fx, fu = tsys.lane_jac_root_fn(xt, ut, xn)
    fxj, fuj = jax_cheetah_lane_jac()(x, u, xn.numpy())
    assert fx.shape == (37, 37, 4) and fu.shape == (37, 12, 4)
    np.testing.assert_allclose(fx.numpy(), np.asarray(fxj), rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_allclose(fu.numpy(), np.asarray(fuj), rtol=1e-8,
                               atol=1e-9)


def test_root_seeded_lane_jac_matches_finite_differences():
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams
    from drake_ddp_tpu_torch.examples import mini_cheetah as tmc
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system

    base, _ = tmc.build_system(tmc.Config(contact_iters=8), device="cpu")
    system = make_multibody_system(
        *base.params, base.dt, contact_iters=8,
        force_params=ContactForceParams(smooth_width=1e-3,
                                        stiction_vel=5e-2))
    x, u = _states(tmc, 4, 1)
    x, u = torch.as_tensor(x), torch.as_tensor(u)
    n, m, B = 37, 12, x.shape[-1]
    fx, fu = system.lane_jac_root_fn(x, u, system.lane_step_fn(x, u))
    # every direction of every lane in one lane batch: (n, n+m, B)
    h = 1e-6
    E = torch.eye(n + m, dtype=torch.float64)
    step = lambda s: system.lane_step_fn(
        (x[:, None] + s * h * E[:n, :, None]).reshape(n, -1),
        (u[:, None] + s * h * E[n:, :, None]).reshape(m, -1),
    ).reshape(n, n + m, B)
    fd = (step(1.0) - step(-1.0)) / (2 * h)
    J = torch.cat([fx, fu], dim=1)
    rel = ((fd - J).abs().max() / J.abs().max()).item()
    assert rel <= 1e-4, rel


def test_cold_lane_jac_matches_jax_contact_families():
    """The cold-Newton Jacobian (root_seed=False: the step's own
    predictor and continuation Newton, then the IFT at that root) on the
    sh, sb and bh families and free, revolute, prismatic and fixed
    joints."""
    import drake_ddp_tpu.contact.geometry as jgeom
    import drake_ddp_tpu.multibody.model as jmodel
    import drake_ddp_tpu_torch.contact.geometry as tgeom
    import drake_ddp_tpu_torch.multibody.model as tmodel
    from drake_ddp_tpu.contact.forces import ContactForceParams as JFP
    from drake_ddp_tpu.multibody.lanejac import make_lane_jac as jmake
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams as TFP
    from drake_ddp_tpu_torch.multibody.lanejac import make_lane_jac as tmake

    jm, jc = small_families(jmodel, jgeom)
    tm, tc = small_families(tmodel, tgeom, device="cpu")
    dt, iters = 2e-3, 2
    jjac = jax.jit(jmake(jm, jc, dt, contact_iters=iters,
                         force_params=JFP(smooth_width=1e-3)),
                   compiler_options=JAX_QUICK_COMPILE)
    tjac = tmake(tm, tc, dt, contact_iters=iters,
                 force_params=TFP(smooth_width=1e-3))
    rng = np.random.default_rng(5)
    B = 4
    x = np.zeros((tm.nq + tm.nv, B))
    quat = np.array([1.0, 0.0, 0.0, 0.0])[:, None] + 0.15 * \
        rng.standard_normal((4, B))
    x[:4] = quat / np.linalg.norm(quat, axis=0)
    x[6] = 0.04 + np.linspace(-0.01, 0.01, B)        # box face at the ground
    x[7] = rng.uniform(-np.pi, np.pi, B)             # hip angle
    x[8] = np.linspace(0.0, 0.2, B)                  # slider through the box
    x[9:] = 0.5 * rng.standard_normal((tm.nv, B))
    u = rng.standard_normal((tm.nu, B))
    want = jjac(jnp.asarray(x), jnp.asarray(u))
    got = tjac(torch.as_tensor(x), torch.as_tensor(u))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max())


def test_inv_small_matches_jax():
    from drake_ddp_tpu.multibody.lanejac import inv_small_T as jinv
    from drake_ddp_tpu_torch.multibody.lanejac import inv_small_T as tinv

    rng = np.random.default_rng(2)
    n, L = 6, 5
    A = rng.standard_normal((n, n, L)) + 4.0 * np.eye(n)[:, :, None]
    got = tinv(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jinv(jnp.asarray(A))),
                               rtol=1e-12, atol=1e-13)
    eye = np.einsum("ijl,jkl->ikl", A, got)
    np.testing.assert_allclose(eye, np.broadcast_to(
        np.eye(n)[:, :, None], eye.shape), atol=1e-12)
