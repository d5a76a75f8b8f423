"""The port's manipulation slice against the JAX package: the contact
families that the manipulation robots add to the step (sphere-sphere,
body sphere vs world sphere, box face vs body sphere), the Panda and
Kinova scenes, ``multibody/algorithms.py`` and ``utils/spatial.py``.

Tolerances: the plain lane step as tests/test_torch_lanestep.py pins it
(float64 to 1e-5; in float32 at most 3x the JAX float32 error + 1e-5
against the JAX float64 step); the lane Jacobians in float64 to 1e-8 of
scale, as tests/test_torch_lanejac.py; the scenes' tables exactly; the
rigid-body algorithms and spatial helpers in float64 to 1e-12 (the same
closed forms).  The per-scenario solves against JAX ``solve_ilqr`` (cold
Jacobians on both sides) are marked slow: they compile the JAX solve."""

import functools

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from drake_ddp_tpu_torch.models.small import (  # noqa: E402
    manipulation_states, small_manipulation)
from test_torch_model import (JAX_QUICK_COMPILE,  # noqa: E402
                              assert_same_tables, jax_tables)

DT, ITERS = 2e-3, 2


def _both_models():
    import drake_ddp_tpu.contact.geometry as jgeom
    import drake_ddp_tpu.multibody.model as jmodel
    import drake_ddp_tpu_torch.contact.geometry as tgeom
    import drake_ddp_tpu_torch.multibody.model as tmodel

    jm, jc = small_manipulation(jmodel, jgeom)
    tm, tc = small_manipulation(tmodel, tgeom, device="cpu")
    return (jm, jc), (tm, tc)


def _force_params():
    from drake_ddp_tpu.contact.forces import ContactForceParams as JFP
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams as TFP
    return JFP(smooth_width=1e-3), TFP(smooth_width=1e-3)


def test_lane_step_matches_jax_manipulation_families():
    from drake_ddp_tpu.multibody.lanestep import make_lane_step as jmake
    from drake_ddp_tpu_torch.multibody.lanestep import make_lane_step as tmake
    from drake_ddp_tpu_torch.multibody.model import from_numpy

    (jm, jc), (tm, tc) = _both_models()
    assert_same_tables(*from_numpy(
        *jax_tables(type("S", (), {"params": (jm, jc)})), device="cpu"),
        tm, tc)
    assert (len(tc.pair_sh_s), len(tc.pair_sb_s), len(tc.pair_ss_a),
            len(tc.pair_sw_s), len(tc.pair_bh_b), len(tc.pair_bs_b)) \
        == (3, 3, 2, 3, 1, 1) and tc.num_contacts == 27
    jfp, tfp = _force_params()
    jstep = jax.jit(jmake(jm, jc, DT, contact_iters=ITERS, force_params=jfp),
                    compiler_options=JAX_QUICK_COMPILE)
    tstep = tmake(tm, tc, DT, contact_iters=ITERS, force_params=tfp)
    x, u = manipulation_states(tm, 8, 4)
    j64 = np.asarray(jstep(jnp.asarray(x), jnp.asarray(u)))
    t64 = tstep(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(t64, j64, rtol=1e-5, atol=1e-5)
    j32 = np.asarray(jstep(jnp.asarray(x, jnp.float32),
                           jnp.asarray(u, jnp.float32)))
    t32 = tstep(torch.as_tensor(x, dtype=torch.float32),
                torch.as_tensor(u, dtype=torch.float32)).numpy()
    e_jax, e_port = np.abs(j32 - j64).max(), np.abs(t32 - j64).max()
    assert e_port <= 3.0 * e_jax + 1e-5, (e_port, e_jax)


@functools.lru_cache(maxsize=None)
def _jax_cold_lane_jac():
    """The JAX package's cold lane Jacobian of the small manipulation
    model, jitted once for both cases below."""
    from drake_ddp_tpu.multibody.lanejac import make_lane_jac as jmake

    (jm, jc), _ = _both_models()
    return jax.jit(jmake(jm, jc, DT, contact_iters=ITERS,
                         force_params=_force_params()[0]),
                   compiler_options=JAX_QUICK_COMPILE)


@pytest.mark.parametrize("root_seed", [False, True], ids=["cold", "root"])
def test_lane_jac_matches_jax_manipulation_families(root_seed):
    """The cold-Newton Jacobian (the step's own Newton, then the IFT at
    that root) and the root-seeded one at the step's next state, on every
    contact family, against the JAX cold Jacobian.  At the step's own
    root the root-seeded Jacobian is the cold one (to 1e-10 in both
    packages, tests/test_torch_megajac.py), so one JAX program, whose
    compile takes most of this file's time, serves both."""
    from drake_ddp_tpu_torch.multibody.lanejac import make_lane_jac as tmake
    from drake_ddp_tpu_torch.multibody.lanestep import make_lane_step

    _, (tm, tc) = _both_models()
    _, tfp = _force_params()
    x, u = manipulation_states(tm, 4, 5)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    want = _jax_cold_lane_jac()(jnp.asarray(x), jnp.asarray(u))
    tjac = tmake(tm, tc, DT, contact_iters=ITERS, force_params=tfp,
                 root_seed=root_seed)
    if root_seed:
        xn = make_lane_step(tm, tc, DT, contact_iters=ITERS,
                            force_params=tfp)(xt, ut)
        got = tjac(xt, ut, xn)
    else:
        got = tjac(xt, ut)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max())


def test_table_packs_manipulation_rows_in_plain_step_order():
    """The CUDA step's table lists the rows as the plain narrowphase
    returns them: kinds in the order sh, sb, ss, sw, then 8 corners a bh
    and a bs pair, each row's bodies those of the plain step's row, each
    box-face row its pair's pressure gradient and corner."""
    import drake_ddp_tpu_torch.contact.geometry as tgeom
    import drake_ddp_tpu_torch.multibody.model as tmodel
    from drake_ddp_tpu_torch.multibody.lanestep import LaneConsts
    from drake_ddp_tpu_torch.ops import _table

    tm, tc = small_manipulation(tmodel, tgeom, device="cpu")
    T = _table.pack_step_table(tm, tc, DT, ITERS, _force_params()[1])
    C = LaneConsts(tm, tc, torch.float32)
    nc = tc.num_contacts
    assert (T.nc, T.ns, T.nbox, T.nh, T.nws) == (nc, 3, 2, 1, 1)
    kinds = list(T.c_kind[:nc])
    assert kinds == ([_table.C_SH] * 3 + [_table.C_SB] * 3
                     + [_table.C_SS] * 2 + [_table.C_SW] * 3
                     + [_table.C_BH] * 8 + [_table.C_BS] * 8)
    assert list(T.c_body_a[:nc]) == list(C.body_a)
    assert list(T.c_body_b[:nc]) == list(C.body_b)
    ss = slice(6, 8)
    assert list(T.c_i0[ss]) == list(tc.pair_ss_a)
    assert list(T.c_i1[ss]) == list(tc.pair_ss_b)
    sw = slice(8, 11)
    assert list(T.c_i0[sw]) == list(tc.pair_sw_s)
    assert list(T.c_i1[sw]) == list(tc.pair_sw_w)
    bs = slice(19, 27)
    assert list(T.c_i0[bs]) == [b for b in tc.pair_bs_b for _ in range(8)]
    assert list(T.c_i1[bs]) == [s for s in tc.pair_bs_s for _ in range(8)]
    assert list(T.c_corner[bs]) == list(range(8))
    np.testing.assert_array_equal(
        np.asarray(T.c_g[:nc]), np.concatenate(
            [np.zeros(11), np.repeat(tc.bh_g.numpy(), 8),
             np.repeat(tc.bs_g.numpy(), 8)]).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(T.c_K[:nc]), C.K.numpy())
    np.testing.assert_array_equal(np.asarray(T.ws_pos[0]),
                                  tc.ws_pos[0].numpy())
    assert T.ws_r[0] == tc.ws_radius[0].item()


@pytest.mark.parametrize("which", ["panda", "kinova", "kinova_pad"])
def test_arm_scenes_match_jax_build(which):
    """Model and contact tables of the examples' scenes, equal to the
    JAX build's, and the tasks' states and weights."""
    from drake_ddp_tpu.examples import kinova_gen3 as jk
    from drake_ddp_tpu.examples import panda_fr3 as jp
    from drake_ddp_tpu_torch.examples import kinova_gen3 as tk
    from drake_ddp_tpu_torch.examples import panda_fr3 as tp
    from drake_ddp_tpu_torch.multibody.model import from_numpy

    jex, tex = (jp, tp) if which == "panda" else (jk, tk)
    kw = dict(pad_face_quadrature=True) if which == "kinova_pad" else {}
    jsys, _ = jex.build_system(jex.Config(**kw))
    tsys, _ = tex.build_system(tex.Config(**kw), device="cpu")
    assert_same_tables(*from_numpy(*jax_tables(jsys), device="cpu"),
                       *tsys.params)
    model, contact = tsys.params
    pairs = {"panda": (35, 0, 34, 0, 0, 0, 69),
             "kinova": (55, 2, 54, 0, 2, 0, 127),
             "kinova_pad": (55, 0, 54, 0, 2, 2, 141)}[which]
    assert (len(contact.pair_sh_s), len(contact.pair_sb_s),
            len(contact.pair_ss_a), len(contact.pair_sw_s),
            len(contact.pair_bh_b), len(contact.pair_bs_b),
            contact.num_contacts) == pairs
    assert (model.nq, model.nv, model.nu) == (14, 13, 7)
    for scenario in ("side", "forward", "lift"):
        jc, tc = jex.Config(scenario=scenario), tex.Config(scenario=scenario)
        for a, b in zip(jex.scenario_states(jc) + jex.costs(jc),
                        tex.scenario_states(tc) + tex.costs(tc)):
            np.testing.assert_array_equal(a, b)


def test_algorithms_match_jax_on_panda():
    """forward_kinematics, mass_matrix, dynamics_terms,
    gravity_compensation, point_jacobian and integrate_positions on the
    Panda scene (the arm and the free ball) in float64."""
    from drake_ddp_tpu.examples import panda_fr3 as jp
    from drake_ddp_tpu.multibody import algorithms as ja
    from drake_ddp_tpu.multibody.model import ancestor_dof_mask
    from drake_ddp_tpu_torch.examples import panda_fr3 as tp
    from drake_ddp_tpu_torch.multibody import algorithms as ta

    _, jmodel = jp.build_system(jp.Config())
    _, tmodel = tp.build_system(tp.Config(), device="cpu")
    rng = np.random.default_rng(7)
    x0, _ = tp.scenario_states(tp.Config())
    q = x0[:14] + 0.3 * rng.standard_normal(14)
    q[7:11] /= np.linalg.norm(q[7:11])
    v = rng.standard_normal(13)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)
    anc = ancestor_dof_mask(jmodel)[6]
    p = np.array([0.1, -0.2, 0.5])

    @jax.jit                                 # one compile, not one per op
    def reference(q, v):
        d = ja.dynamics_terms(jmodel, q, v)
        return (d, ja.mass_matrix(jmodel, d.kin),
                ja.gravity_compensation(jmodel, q),
                ja.point_jacobian(jmodel, d.kin, 6, jnp.asarray(p),
                                  jnp.asarray(anc)),
                ja.integrate_positions(jmodel, q, v, 1e-2))

    jd, jM, jg, jJ, jqn = reference(jnp.asarray(q), jnp.asarray(v))  # f64
    tq, tv = torch.as_tensor(q), torch.as_tensor(v)
    td = ta.dynamics_terms(tmodel, tq, tv)
    for a, b in zip(jd.kin, td.kin):
        close(b, a)
    for name in ("M", "bias", "w", "v_origin"):
        close(getattr(td, name), getattr(jd, name))
    close(ta.mass_matrix(tmodel, td.kin), jM)
    close(ta.gravity_compensation(tmodel, tq), jg)
    close(ta.point_jacobian(tmodel, td.kin, 6, torch.as_tensor(p),
                            torch.as_tensor(anc)), jJ)
    close(ta.integrate_positions(tmodel, tq, tv, 1e-2), jqn)


def test_spatial_matches_jax():
    from drake_ddp_tpu.utils import spatial as js
    from drake_ddp_tpu_torch.utils import spatial as ts

    rng = np.random.default_rng(8)
    v = rng.standard_normal((5, 3))
    q = rng.standard_normal((5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w = rng.standard_normal((5, 3))
    axis = np.array([0.6, 0.0, 0.8])
    angle = rng.standard_normal(5)
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-12)
    t, j = torch.as_tensor, jnp.asarray               # float64 (conftest)
    close(ts.hat(t(v)), js.hat(j(v)))
    close(ts.quat_to_rot(t(q)), js.quat_to_rot(j(q)))
    close(ts.quat_mul(t(q), t(q[::-1].copy())), js.quat_mul(j(q), j(q[::-1])))
    close(ts.quat_integrate(t(q), t(w), 1e-2),
          js.quat_integrate(j(q), j(w), 1e-2))
    close(ts.axis_angle_rot(t(axis), t(angle)),
          js.axis_angle_rot(j(axis), j(angle)))
    close(ts.rpy_to_rot((0.3, -0.2, np.pi / 2)),
          js.rpy_to_rot((0.3, -0.2, np.pi / 2)))


def test_kinova_keypoint_methods_raise_until_ported(monkeypatch):
    """Ported behaviour under the id of the test that asserted the raise:
    the Kinova example's default interpolation (adaptiveJerk at the JAX
    example's minN 5, maxN 40, jerk_threshold 1e-4) solves at T 0.1 (N
    10), and every derivative call's percentage equals JAX
    ``adaptive_jerk_mask``'s on that call's own trajectory; the solve's
    per-round record is those percentages.  The whole solve against JAX's
    is the slow test_kinova_adaptive_jerk_solve_matches_jax."""
    from drake_ddp_tpu.examples import kinova_gen3 as jk
    from drake_ddp_tpu.solver import keypoints as jkp
    from drake_ddp_tpu_torch.examples import kinova_gen3 as tk
    from drake_ddp_tpu_torch.solver import keypoints as tkp

    cfg = tk.Config(use_derivative_interpolation=True, verbose=False,
                    T=0.1, contact_iters=2)
    ilqr = tk.build_solver(cfg, device="cpu")
    jcfg = jk.Config(use_derivative_interpolation=True)
    assert tuple(ilqr.config.derivs) == (
        jcfg.keypoint_method, jcfg.minN, jcfg.maxN, jcfg.jerk_threshold,
        jcfg.iterative_error_threshold, jcfg.max_keypoints, None)
    calls = []
    derivs = tkp.compute_derivatives_batched

    def recorded(jac_T, dcfg, x, u, root=False):
        out = derivs(jac_T, dcfg, x, u, root=root)
        calls.append((x.detach().clone(), out[2].clone()))
        return out
    monkeypatch.setattr(tkp, "compute_derivatives_batched", recorded)
    x, u, _, cost = ilqr.Solve()
    sol = ilqr._solution
    k = int(sol.iterations)
    assert np.isfinite(x).all() and np.isfinite(cost) and k > 0
    jd = jkp.DerivsInterpolation(**ilqr.config.derivs._asdict())
    N, n = calls[0][0].shape[1:]
    assert N == 10
    pcts = []
    for xs, pct in calls:
        mask = jkp.adaptive_jerk_mask(jd, jnp.asarray(xs[0].numpy()), N, n)
        pcts.append(100.0 * int(np.asarray(mask).sum()) / (N - 1))
        assert float(pct[0]) == pytest.approx(pcts[-1], abs=1e-4)
    got = sol.stats.percent_derivs[:k]
    fresh = got[got > 0]
    np.testing.assert_allclose(fresh, pcts[-len(fresh):], atol=1e-4)


@pytest.mark.parametrize("knob", [
    ("maxN", 30), ("jerk_threshold", 1e-3), ("max_keypoints", 12),
    ("iterative_error_threshold", 1e-3), ("mesh_max_spheres", 6)])
def test_arm_knobs_without_a_port_raise(knob, monkeypatch):
    """Ported behaviour under the id of the test that asserted the raise:
    each Kinova Config knob reaches what it names: the dynamic keypoint
    methods' thresholds and budget the solver's DerivsInterpolation, the
    mesh cover's size every add_urdf call."""
    from drake_ddp_tpu_torch.examples import kinova_gen3 as tk

    field, value = knob
    seen = []
    add_urdf = tk.add_urdf
    monkeypatch.setattr(tk, "add_urdf", lambda *a, **kw: seen.append(
        kw["mesh_max_spheres"]) or add_urdf(*a, **kw))
    ilqr = tk.build_solver(tk.Config(verbose=False, T=0.03,
                                     use_derivative_interpolation=True,
                                     **{field: value}), device="cpu")
    if field == "mesh_max_spheres":
        assert seen == [value, value]
    else:
        assert getattr(ilqr.config.derivs, field) == value


def _solve_pin(jilqr, tilqr):
    """The port's per-scenario solve against JAX solve_ilqr on the same
    problem: iterations +-1, final cost within 15%.  Returns JAX's."""
    from drake_ddp_tpu.solver.ilqr import solve_ilqr as jsolve

    ref = jax.jit(lambda p: jsolve(jilqr.system, jilqr.config, p),
                  compiler_options=JAX_QUICK_COMPILE)(jilqr._problem())
    tilqr.Solve()
    got = tilqr._solution
    assert np.isfinite(got.x).all() and not bool(got.diverged)
    assert not bool(ref.diverged)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1, (
        int(got.iterations), int(ref.iterations))
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=0.15)
    return ref


@pytest.mark.slow
def test_cheetah_scenario_solve_matches_jax_solve_ilqr():
    """The per-scenario cheetah at N 10, contact_iters 2 (cold Jacobians
    on both sides: the port's megajac route, on CPU tensors its plain
    cold lane Jacobian; the JAX step's custom_root IFT at its own
    root)."""
    from drake_ddp_tpu.examples import mini_cheetah as jmc
    from drake_ddp_tpu_torch.examples import mini_cheetah as tmc

    kw = dict(T=10 * 4e-3, contact_iters=2, verbose=False)
    jilqr = jmc.build_solver(jmc.Config(**kw))[0]
    tilqr = tmc.build_solver(tmc.Config(**kw), device="cpu")[0]
    assert jilqr.N == tilqr.N == 10
    _solve_pin(jilqr, tilqr)


@pytest.mark.slow
def test_panda_scenario_solve_matches_jax_solve_ilqr():
    """The Panda side task at T 0.05 (N 5), contact_iters 2."""
    from drake_ddp_tpu.examples import panda_fr3 as jp
    from drake_ddp_tpu_torch.examples import panda_fr3 as tp

    kw = dict(T=0.05, contact_iters=2, verbose=False)
    jilqr = jp.build_solver(jp.Config(**kw))
    tilqr = tp.build_solver(tp.Config(**kw), device="cpu")
    assert jilqr.N == tilqr.N == 5
    _solve_pin(jilqr, tilqr)


@pytest.mark.slow
def test_kinova_adaptive_jerk_solve_matches_jax():
    """The Kinova example's adaptiveJerk solve at T 0.1 (N 10),
    contact_iters 2, against JAX solve_ilqr on the example's own problem:
    the solve pins, and equal per-round derivative percentages over the
    rounds both ran (about a minute on one core: the JAX solve's compile)."""
    from drake_ddp_tpu.examples import kinova_gen3 as jk
    from drake_ddp_tpu_torch.examples import kinova_gen3 as tk

    kw = dict(use_derivative_interpolation=True, T=0.1, contact_iters=2,
              verbose=False)
    jilqr = jk.build_solver(jk.Config(**kw))
    tilqr = tk.build_solver(tk.Config(**kw), device="cpu")
    assert jilqr.N == tilqr.N == 10
    ref = _solve_pin(jilqr, tilqr)
    got = tilqr._solution
    k = min(int(got.iterations), int(ref.iterations))
    np.testing.assert_allclose(got.stats.percent_derivs[:k],
                               np.asarray(ref.stats.percent_derivs)[:k],
                               atol=1e-4)
