"""The port's per-contact force law, narrowphase, small solves and
subpackage exports against the JAX package, on the CPU.

- ``contact.forces``: ``smooth_penetration``, ``smooth_relu``,
  ``contact_forces`` and ``contact_forces_implicit`` (the lane-major law
  on one lane) at JAX's signatures;
- ``contact.geometry.narrowphase`` on the mini cheetah's scene (sphere-
  ground, sphere-body-box and box-face rows) and the Panda's (sphere-
  ground and arm-ball sphere-sphere rows);
- ``utils.linalg.solve_small`` and ``inv_spd``;
- each subpackage's ``__all__`` holds JAX's.

Inputs are numpy-seeded float32 (the scenes at their examples' initial
configurations, moved by seeded noise; forces at seeded penetrations and
velocities, some near zero slip).  Tolerances: the per-step pin, rtol
1e-5 with atol 1e-5 of each output's scale (float32 rounding of the same
arithmetic); index tuples equal."""

import functools
import importlib

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import JAX_QUICK_COMPILE  # noqa: E402

SCENES = ("mini_cheetah", "panda_fr3")
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """Both packages' (model, contact) of an example at its Config(), and
    its initial q with seeded noise."""
    jex = importlib.import_module(f"drake_ddp_tpu.examples.{name}")
    tex = importlib.import_module(f"drake_ddp_tpu_torch.examples.{name}")
    jsys, _ = jex.build_system(jex.Config())
    tsys, tmodel = tex.build_system(tex.Config(), device="cpu")
    x0 = (tex.initial_and_target(tex.Config())[0] if name == "mini_cheetah"
          else tex.scenario_states(tex.Config())[0])
    q = np.asarray(x0[:tmodel.nq], np.float64)
    rng = np.random.default_rng(7)
    q = q + 0.02 * rng.standard_normal(q.shape)
    q.flags.writeable = False
    return jsys.params, tsys.params, q


def _poses(tmodel, tcm, q):
    """Body poses (nb, 3, 3), (nb, 3) and sphere centers (ns, 3) at q,
    float32 numpy, from the port's kinematics in float64."""
    from drake_ddp_tpu_torch.multibody.algorithms import forward_kinematics

    kin = forward_kinematics(tmodel, torch.tensor(q))
    R, p = kin.R.numpy(), kin.p.numpy()
    body = np.asarray(tcm.sph_body, int)
    off = tcm.sph_offset.double().numpy()
    centers = p[body] + np.einsum("sij,sj->si", R[body], off)
    f32 = lambda a: a.astype(np.float32)
    return f32(R), f32(p), f32(centers)


@pytest.mark.parametrize("name", SCENES)
def test_narrowphase_matches_jax(name):
    from drake_ddp_tpu.contact.geometry import narrowphase as jnarrow
    from drake_ddp_tpu_torch.contact import narrowphase

    (jmodel, jcm), (tmodel, tcm), q = _scene(name)
    R, p, centers = _poses(tmodel, tcm, q)
    want = jnarrow(jcm, jnp.asarray(centers), jnp.asarray(R),
                   jnp.asarray(p))
    t = torch.as_tensor
    got = narrowphase(tcm, t(centers), t(R), t(p))
    assert len(got) == len(want) == 9
    assert got[3] == want[3] and got[4] == want[4]        # body_a, body_b
    for i in (0, 1, 2, 5, 6, 7, 8):
        assert got[i].dtype == torch.float32
        _close(got[i], want[i])
    phi = got[0].numpy()
    assert (phi > -0.01).sum() >= 2          # some rows near or in contact


def _force_inputs(name, seed):
    """Per-contact inputs of a scene's rows: phi around the smoothing
    width, unit normals, relative velocities (a third of them slipping
    below the stiction width), and the rows' K, K1, d, mu."""
    from drake_ddp_tpu.contact.geometry import narrowphase as jnarrow

    (jmodel, jcm), (tmodel, tcm), q = _scene(name)
    R, p, centers = _poses(tmodel, tcm, q)
    _, normal, _, _, _, K, K1, d, mu = jnarrow(
        jcm, jnp.asarray(centers), jnp.asarray(R), jnp.asarray(p))
    nc = normal.shape[0]
    rng = np.random.default_rng(seed)
    phi = 0.01 * rng.standard_normal(nc)
    v_rel = 0.2 * rng.standard_normal((nc, 3))
    slow = rng.random(nc) < 1 / 3
    v_rel[slow] = 1e-3 * rng.standard_normal((int(slow.sum()), 3))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(phi=f32(phi), normal=f32(normal), v_rel=f32(v_rel),
                K=f32(K), d=f32(d), mu=f32(mu)), f32(K1)


@pytest.mark.parametrize("name", SCENES)
def test_force_law_matches_jax(name):
    from drake_ddp_tpu.contact import forces as jf
    from drake_ddp_tpu_torch.contact import forces as tf

    params = tf.ContactForceParams(smooth_width=1e-2)
    jparams = jf.ContactForceParams(*params)
    inputs, K1 = _force_inputs(name, seed=3)
    J = {k: jnp.asarray(v) for k, v in inputs.items()}
    T = {k: torch.tensor(v) for k, v in inputs.items()}
    for k1 in (None, K1):
        jk1 = None if k1 is None else jnp.asarray(k1)
        tk1 = None if k1 is None else torch.tensor(k1)
        _close(tf.contact_forces(**T, params=params, K1=tk1),
               jf.contact_forces(**J, params=jparams, K1=jk1))
        got = tf.contact_forces_implicit(**T, dt=1e-2, params=params,
                                         K1=tk1)
        want = jf.contact_forces_implicit(**J, dt=1e-2, params=jparams,
                                          K1=jk1)
        assert got[1].shape == (K1.shape[0], 3, 3)
        for g, w in zip(got, want):
            _close(g, w)
    x = torch.as_tensor(inputs["phi"])
    _close(tf.smooth_penetration(x, 1e-2),
           jf.smooth_penetration(jnp.asarray(inputs["phi"]), 1e-2))
    _close(tf.smooth_relu(x), jf.smooth_relu(jnp.asarray(inputs["phi"])))
    _close(tf.smooth_relu(x, 0.1),
           jf.smooth_relu(jnp.asarray(inputs["phi"]), 0.1))


def test_contact_forces_are_the_lane_law_on_one_lane():
    """The per-contact functions are the lane step's law: the same bits as
    the lane-major function on a lane of one."""
    from drake_ddp_tpu_torch.contact import forces as tf

    params = tf.ContactForceParams(smooth_width=1e-2)
    inputs, K1 = _force_inputs("panda_fr3", seed=5)
    T = {k: torch.tensor(v) for k, v in inputs.items()}
    lane = dict(T, phi=T["phi"][:, None], normal=T["normal"][..., None],
                v_rel=T["v_rel"][..., None])
    k1 = torch.tensor(K1)
    f, D = tf.contact_forces_implicit(**T, dt=1e-2, params=params, K1=k1)
    fT, DT = tf._contact_forces_implicit_T(**lane, dt=1e-2, params=params,
                                           K1=k1[:, None])
    assert torch.equal(f, fT[..., 0]) and torch.equal(D, DT[..., 0])
    assert torch.equal(
        tf.contact_forces(**T, params=params),
        tf._contact_forces_T(**lane, params=params)[..., 0])


@pytest.mark.parametrize("n", [1, 2, 7])
def test_solve_small_and_inv_spd_match_jax(n):
    from drake_ddp_tpu.utils import linalg
    from drake_ddp_tpu_torch.utils import inv_spd, solve_small

    jsolve, jinv = (jax.jit(f, compiler_options=JAX_QUICK_COMPILE)
                    for f in (linalg.solve_small, linalg.inv_spd))

    rng = np.random.default_rng(n)
    a = rng.standard_normal((5, n, n))
    spd = (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    dom = (a + 3 * n * np.eye(n)).astype(np.float32)   # diagonally dominant
    b = rng.standard_normal((5, n)).astype(np.float32)
    _close(solve_small(torch.as_tensor(dom), torch.as_tensor(b)),
           jsolve(jnp.asarray(dom), jnp.asarray(b)))
    _close(solve_small(torch.as_tensor(dom[0]), torch.as_tensor(b[0])),
           jsolve(jnp.asarray(dom[0]), jnp.asarray(b[0])))
    got = inv_spd(torch.as_tensor(spd))
    _close(got, jinv(jnp.asarray(spd)))
    np.testing.assert_allclose(got.numpy() @ spd, np.broadcast_to(
        np.eye(n), spd.shape), atol=1e-4)


@pytest.mark.parametrize("sub", ["contact", "multibody", "solver", "models",
                                 "utils"])
def test_subpackage_exports_hold_jax_all(sub):
    jmod = importlib.import_module(f"drake_ddp_tpu.{sub}")
    tmod = importlib.import_module(f"drake_ddp_tpu_torch.{sub}")
    assert set(jmod.__all__) <= set(tmod.__all__)
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name
