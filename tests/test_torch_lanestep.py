"""The port's plain lane step (drake_ddp_tpu_torch/multibody/lanestep.py)
against the JAX package's ``make_lane_step``.

The plain step is what the CUDA kernels are held to on the card, so it is
pinned here as the JAX package pins its own lane step
(tests/test_lanestep.py): (a) agreement in f64 at 1e-5 (model constants
are f32 and derived constants round at different points), and (b) in
f32 the port's error against the f64 result is at most 3x the JAX f32
error + 1e-5.  The cheetah covers the flagship's contact families; a
small model built through the port's ModelBuilder pins the sphere-
halfspace, sphere-box (both the inside and outside branches) and
box-face-halfspace families, revolute, prismatic, fixed and free joints,
without the cheetah's compile time."""

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import (JAX_QUICK_COMPILE, assert_same_tables,
                              jax_tables, small_families)


def _compare(jstep, tstep, xb, ub):
    """xb (B, n), ub (B, m) numpy float64.  jstep is the JAX step, run as
    the caller chose: for the cheetah op by op, where a small compile for
    each distinct primitive costs about half of what compiling the whole
    unrolled step does; for the small model jitted."""
    j64 = np.asarray(jstep(jnp.asarray(xb.T), jnp.asarray(ub.T)))
    t64 = tstep(torch.as_tensor(xb.T), torch.as_tensor(ub.T)).numpy()
    np.testing.assert_allclose(t64, j64, rtol=1e-5, atol=1e-5)

    j32 = np.asarray(jstep(jnp.asarray(xb.T, jnp.float32),
                           jnp.asarray(ub.T, jnp.float32)))
    t32 = tstep(torch.as_tensor(xb.T, dtype=torch.float32),
                torch.as_tensor(ub.T, dtype=torch.float32)).numpy()
    e_jax = np.abs(j32 - j64).max()
    e_port = np.abs(t32 - j64).max()
    assert e_port <= 3.0 * e_jax + 1e-5, (e_port, e_jax)


def test_lane_step_matches_jax_cheetah():
    from drake_ddp_tpu.examples import mini_cheetah as jmc
    from test_torch_model import port_system_from_jax

    cfg = jmc.Config(contact_iters=8)
    jsys, _ = jmc.build_system(cfg)
    tsys = port_system_from_jax(jsys, contact_iters=8)
    x0, _ = jmc.initial_and_target(cfg)
    rng = np.random.default_rng(0)
    B = 8
    xb = np.tile(np.asarray(x0, np.float64), (B, 1))
    xb[:, 19:] += 0.2 * rng.standard_normal((B, 18))
    xb[:, 4:7] += 0.01 * rng.standard_normal((B, 3))
    ub = np.tile(np.asarray(jmc.U_STAND, np.float64), (B, 1))
    ub += 0.5 * rng.standard_normal(ub.shape)
    _compare(jsys.lane_step_fn, tsys.lane_step_fn, xb, ub)


def test_lane_step_matches_jax_contact_families():
    import drake_ddp_tpu.contact.geometry as jgeom
    import drake_ddp_tpu.multibody.model as jmodel
    import drake_ddp_tpu_torch.contact.geometry as tgeom
    import drake_ddp_tpu_torch.multibody.model as tmodel
    from drake_ddp_tpu.contact.forces import ContactForceParams as JFP
    from drake_ddp_tpu.multibody.lanestep import make_lane_step as jmake
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams as TFP
    from drake_ddp_tpu_torch.multibody.lanestep import make_lane_step as tmake

    jm, jc = small_families(jmodel, jgeom)
    tm, tc = small_families(tmodel, tgeom, device="cpu")
    assert_same_tables(*tmodel.from_numpy(
        *jax_tables(type("S", (), {"params": (jm, jc)})), device="cpu"),
        tm, tc)
    assert (len(tc.pair_sh_s), len(tc.pair_sb_s), len(tc.pair_bh_b)) \
        == (2, 2, 1) and tc.num_contacts == 12
    dt, iters = 2e-3, 2
    jstep = jmake(jm, jc, dt, contact_iters=iters,
                  force_params=JFP(smooth_width=1e-3))
    tstep = tmake(tm, tc, dt, contact_iters=iters,
                  force_params=TFP(smooth_width=1e-3))

    rng = np.random.default_rng(4)
    B = 8
    xb = np.zeros((B, tm.nq + tm.nv))
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.15 * rng.standard_normal(
        (B, 4))
    xb[:, :4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    xb[:, 4:6] = 0.05 * rng.standard_normal((B, 2))
    xb[:, 6] = 0.04 + np.linspace(-0.01, 0.01, B)   # box face at the ground
    xb[:, 7] = rng.uniform(-np.pi, np.pi, B)        # hip angle
    xb[:, 8] = np.linspace(0.0, 0.2, B)             # slider through the box
    xb[:, 9:] = 0.5 * rng.standard_normal((B, tm.nv))
    ub = rng.standard_normal((B, tm.nu))
    _compare(jax.jit(jstep, compiler_options=JAX_QUICK_COMPILE), tstep, xb,
             ub)
