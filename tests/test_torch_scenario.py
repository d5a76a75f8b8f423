"""The port's per-scenario path against the JAX package: the analytic
systems, the per-scenario multibody step and its derivatives, the class
API with its examples, and the per-scenario cheetah solve.

Tolerances: the analytic steps and their Jacobians in float64 to 1e-10
(the same closed forms); the multibody step in float32 to 1e-5, as the
lane step it runs is pinned (tests/test_torch_lanestep.py); its autodiff
Jacobians equal the cold lane Jacobian to 1e-10 in float64 (they are
defined by it); the examples' costs within 1% of the JAX package's
goldens (tests/test_golden.py).

The per-scenario cheetah solve (N 10, contact_iters 2, max_iters 3,
ls_parallel 4) is pinned to the port's batched solve at B = 1 with the
root-seeded Jacobian, which tests/test_torch_mpc.py pins to the JAX
package: compiling the JAX per-scenario cheetah solve would take most of
this file's time on one core."""

import functools

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import (JAX_QUICK_COMPILE,  # noqa: E402
                              port_system_from_jax, small_families)

GOLDEN = {"pendulum": 0.2400494, "cart_pole": 54.18781}   # test_golden.py


@pytest.mark.parametrize("name", ["pendulum", "cart_pole", "acrobot"])
def test_analytic_step_and_linearize_match_jax(name):
    import drake_ddp_tpu.dynamics.analytic as jan
    import drake_ddp_tpu_torch.dynamics.analytic as tan

    jsys = getattr(jan, f"{name}_system")(dt=1e-2)
    tsys = getattr(tan, f"{name}_system")(dt=1e-2)
    rng = np.random.default_rng(0)
    L = 3
    x = rng.standard_normal((tsys.n, L))
    u = rng.standard_normal((tsys.m, L))
    tape = rng.standard_normal((4, tsys.m))
    # the JAX references, one compile each: per lane step and jacfwd, and
    # an open-loop rollout
    ref = jax.jit(lambda xs, us: (jax.vmap(jsys.step)(xs, us),
                                  jax.vmap(jsys.linearize)(xs, us)))
    want, (wfx, wfu) = ref(jnp.asarray(x.T), jnp.asarray(u.T))
    t = lambda a: torch.as_tensor(a)
    lanes_x = tsys.lane_step_fn(t(x), t(u)).numpy()
    lanes_fx, lanes_fu = (a.numpy() for a in tsys.lane_jac_fn(t(x), t(u)))
    for l in range(L):
        got = tsys.step(t(x[:, l]), t(u[:, l])).numpy()
        gfx, gfu = (a.numpy() for a in tsys.linearize(t(x[:, l]),
                                                      t(u[:, l])))
        for g, w in ((got, want[l]), (gfx, wfx[l]), (gfu, wfu[l]),
                     (lanes_x[:, l], want[l]), (lanes_fx[..., l], wfx[l]),
                     (lanes_fu[..., l], wfu[l])):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10,
                                       atol=1e-10)
    # the open-loop rollout is the step applied in turn
    xs = tsys.rollout(t(x[:, 0]), t(tape)).numpy()
    np.testing.assert_allclose(
        xs, np.asarray(jax.jit(jsys.rollout)(jnp.asarray(x[:, 0]),
                                             jnp.asarray(tape))),
        rtol=1e-10, atol=1e-10)


@functools.lru_cache(maxsize=None)
def _cheetah_systems():
    """The JAX cheetah system at contact_iters 2 and the port's on its
    exact constants, built once per process."""
    from drake_ddp_tpu.examples import mini_cheetah as jmc

    jsys, _ = jmc.build_system(jmc.Config(contact_iters=2))
    return jsys, port_system_from_jax(jsys, contact_iters=2)


def _cheetah_states(jmc, B, seed):
    x0, _ = jmc.initial_and_target(jmc.Config())
    rng = np.random.default_rng(seed)
    xb = np.tile(np.asarray(x0, np.float64), (B, 1))
    xb[:, 19:] += 0.2 * rng.standard_normal((B, 18))
    xb[:, 4:7] += 0.01 * rng.standard_normal((B, 3))
    ub = np.tile(np.asarray(jmc.U_STAND, np.float64), (B, 1))
    ub += 0.5 * rng.standard_normal(ub.shape)
    return xb, ub


def _families_states(nq, nv, nu, B, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, nq + nv))
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.15 * rng.standard_normal((B, 4))
    x[:, :4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    x[:, 6] = 0.04 + np.linspace(-0.01, 0.01, B)    # box face at the ground
    x[:, 7] = rng.uniform(-np.pi, np.pi, B)         # hip angle
    x[:, 8] = np.linspace(0.0, 0.2, B)              # slider through the box
    x[:, 9:] = 0.5 * rng.standard_normal((B, nv))
    return x, rng.standard_normal((B, nu))


@pytest.mark.parametrize("model", ["cheetah", "families"])
def test_multibody_step_matches_jax(model):
    """The per-scenario step against the JAX package's ``multibody_step``
    in float64 to 1e-5 (model constants are float32, and the two round
    derived constants at different points), one scenario at a time
    through the port and a vmapped batch through the JAX step (one
    compile).  In float32 the two are not held to 1e-5: through the stiff
    contact solve float32 rounding reaches ~1e-3 on velocities for both,
    each against the float64 truth (tests/test_lanestep.py).  The port's
    float32 step is its lane step at one lane, bit for bit, and that is
    held to the JAX float32 step by tests/test_torch_lanestep.py."""
    if model == "cheetah":
        from drake_ddp_tpu.examples import mini_cheetah as jmc

        jsys, tsys = _cheetah_systems()
        xb, ub = _cheetah_states(jmc, 4, 0)
        jstep, tstep = jsys.bound_step(), tsys.step
        tlane = tsys.lane_step_fn
    else:
        import drake_ddp_tpu.contact.geometry as jgeom
        import drake_ddp_tpu.multibody.model as jmodel
        import drake_ddp_tpu_torch.contact.geometry as tgeom
        import drake_ddp_tpu_torch.multibody.model as tmodel
        from drake_ddp_tpu.contact.forces import ContactForceParams as JFP
        from drake_ddp_tpu.multibody.plant import multibody_step as jms
        from drake_ddp_tpu_torch.contact.forces import (
            ContactForceParams as TFP)
        from drake_ddp_tpu_torch.multibody.lanestep import make_lane_step
        from drake_ddp_tpu_torch.multibody.plant import multibody_step as tms

        jm, jc = small_families(jmodel, jgeom)
        tm, tc = small_families(tmodel, tgeom, device="cpu")
        jstep = lambda x, u: jms(jm, jc, 2e-3, x, u, contact_iters=2,
                                 force_params=JFP(smooth_width=1e-3))
        tstep = lambda x, u: tms(tm, tc, 2e-3, x, u, contact_iters=2,
                                 force_params=TFP(smooth_width=1e-3))
        tlane = make_lane_step(tm, tc, 2e-3, contact_iters=2,
                               force_params=TFP(smooth_width=1e-3))
        xb, ub = _families_states(tm.nq, tm.nv, tm.nu, 4, 5)
    want = np.asarray(jax.jit(jax.vmap(jstep),
                              compiler_options=JAX_QUICK_COMPILE)(
        jnp.asarray(xb), jnp.asarray(ub)))
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt)
    got = np.stack([tstep(t(x), t(u)).numpy() for x, u in zip(xb, ub)])
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for x, u in zip(t(xb, torch.float32), t(ub, torch.float32)):
        got32 = tstep(x, u)
        assert got32.dtype == torch.float32
        assert torch.equal(got32, tlane(x[:, None], u[:, None])[:, 0])


@pytest.mark.parametrize("mode", ["jacfwd", "jacrev", "vmap_jacfwd"])
def test_multibody_step_jacobian_is_the_cold_lane_jac(mode):
    """torch.func through the per-scenario step gives the IFT Jacobian at
    the step's own Newton root: the cold lane Jacobian, float64, 1e-10;
    vmapped, one lane Jacobian over the batch."""
    from torch.func import jacfwd, jacrev, vmap

    from drake_ddp_tpu.examples import mini_cheetah as jmc

    tsys = _cheetah_systems()[1]
    xb, ub = (torch.as_tensor(a) for a in _cheetah_states(jmc, 2, 1))
    f = tsys.bound_step()
    if mode == "vmap_jacfwd":
        fx, fu = vmap(jacfwd(f, argnums=(0, 1)))(xb, ub)
        np.testing.assert_allclose(vmap(f)(xb, ub).numpy(),
                                   tsys.lane_step_fn(xb.T, ub.T).T.numpy(),
                                   rtol=1e-12, atol=1e-12)
    else:
        d = jacfwd if mode == "jacfwd" else jacrev
        fx, fu = (torch.stack(a) for a in zip(*(
            d(f, argnums=(0, 1))(x, u) for x, u in zip(xb, ub))))
    assert fx.dtype == torch.float64
    want = torch.cat(tsys.lane_jac_fn(xb.T, ub.T), dim=1).permute(2, 0, 1)
    got = torch.cat([fx, fu], dim=2)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 1e-10, rel


def _counting_jac(system):
    """``system`` with its lane Jacobian counted: (system, calls)."""
    import dataclasses

    calls = []
    jac = system.lane_jac_fn
    return dataclasses.replace(
        system, lane_jac_fn=lambda x, u: calls.append(1) or jac(x, u)), calls


@pytest.mark.parametrize("task", ["pendulum", "cart_pole"])
def test_examples_meet_the_goldens(task):
    """The class API on the CPU: the cost within 1% of the JAX package's
    golden, the swing-up reached; the derivative call made once per iLQR
    round except on a regularization retry (cached derivatives)."""
    import importlib

    ex = importlib.import_module(f"drake_ddp_tpu_torch.examples.{task}")
    cfg = ex.Config(verbose=False)
    ilqr = ex.build_solver(cfg, device="cpu")
    ilqr.system, calls = _counting_jac(ilqr.system)
    x, u, _, cost = ilqr.Solve()
    assert cost == pytest.approx(GOLDEN[task], rel=0.01)
    angle = x[0 if task == "pendulum" else 1, -1]
    assert abs(angle - np.pi) < (0.01 if task == "pendulum" else 0.05)
    sol = ilqr._solution
    rounds = int(sol.iterations)
    retries = int(np.sum(sol.stats.eps[1:rounds] == 0.0))
    assert len(calls) == rounds - retries


def test_pendulum_solve_matches_jax_solve_ilqr():
    """Equal iterations, linesearch counts and accepted eps (float32,
    eps to 1e-6 relative) against the JAX per-scenario solve."""
    from drake_ddp_tpu.examples import pendulum as jex
    from drake_ddp_tpu.solver.ilqr import solve_ilqr as jsolve
    from drake_ddp_tpu_torch.examples import pendulum as tex

    jilqr = jex.build_solver(jex.Config(verbose=False))
    ref = jax.jit(lambda p: jsolve(jilqr.system, jilqr.config, p),
                  compiler_options=JAX_QUICK_COMPILE)(jilqr._problem())
    tilqr = tex.build_solver(tex.Config(verbose=False), device="cpu")
    tilqr.Solve()
    got = tilqr._solution
    k = int(ref.iterations)
    assert int(got.iterations) == k and not got.diverged
    np.testing.assert_array_equal(got.stats.ls_iters[:k],
                                  np.asarray(ref.stats.ls_iters)[:k])
    np.testing.assert_allclose(got.stats.eps[:k],
                               np.asarray(ref.stats.eps)[:k], rtol=1e-6)
    np.testing.assert_allclose(got.cost, float(ref.cost), rtol=1e-4)


def test_cheetah_scenario_solve_matches_batched():
    """The per-scenario cheetah solve (cold-Newton megajac, on CPU tensors
    its plain lane Jacobian) in float32 against the batched solve at
    B = 1 with the root-seeded lane Jacobian, within the chain pin
    (iterations +-1, cost 15%)."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as tmc
    from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
    from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig, ILQRProblem,
                                                 solve_ilqr)

    dt = torch.float32
    cfg = tmc.Config(contact_iters=2)
    system, _ = tmc.build_system(cfg, device="cpu")
    N = 10
    Q, R, Qf = tmc.costs(cfg)
    x0, x_nom = tmc.initial_and_target(cfg)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt)
    prob = ILQRProblem(x0=t(x0), x_nom=t(x_nom), Q=t(cfg.dt * Q),
                       R=t(cfg.dt * R), Qf=t(Qf),
                       u_init=t(np.tile(tmc.U_STAND, (N - 1, 1))))
    scfg = ILQRConfig(num_steps=N, delta=cfg.delta, beta=cfg.beta,
                      max_iters=3, ls_parallel=4)
    got = solve_ilqr(system, scfg, prob)
    ref = solve_ilqr_batched(system, scfg, ILQRProblem(
        *(a[None] for a in prob[:6])), deriv_kernel="lane", root_seed=True)
    assert got.x.shape == (N, 37) and got.u.shape == (N - 1, 12)
    assert got.stats.cost.shape == (3,) and got.x.dtype == dt
    assert torch.isfinite(got.x).all() and not bool(got.diverged)
    assert abs(int(got.iterations) - int(ref.iterations[0])) <= 1
    np.testing.assert_allclose(float(got.cost), float(ref.cost[0]),
                               rtol=0.15)


def test_save_solution_matches_jax_layout(tmp_path):
    """The JAX class's SaveSolution, handed the port's solution, writes
    the same keys, shapes and values as the port's."""
    from drake_ddp_tpu.dynamics import pendulum_system as jpend
    from drake_ddp_tpu.solver.api import (
        IterativeLinearQuadraticRegulator as JILQR)
    from drake_ddp_tpu_torch import IterativeLinearQuadraticRegulator
    from drake_ddp_tpu_torch.dynamics import pendulum_system

    ilqr = IterativeLinearQuadraticRegulator(pendulum_system(dt=1e-2), 20,
                                             verbose=False, max_iters=5,
                                             device="cpu")
    ilqr.SetTargetState(np.array([np.pi, 0.0]))
    ilqr.SetTerminalCost(100 * np.eye(2))
    ilqr.Solve()
    jilqr = JILQR(jpend(dt=1e-2), 20, verbose=False)
    jilqr._solution = ilqr._solution
    files = {}
    for name, solver in (("port", ilqr), ("jax", jilqr)):
        path = str(tmp_path / f"{name}.npz")
        solver.SaveSolution(path)
        files[name] = np.load(path)
    assert sorted(files["port"].files) == sorted(files["jax"].files)
    for k in files["jax"].files:
        np.testing.assert_array_equal(files["port"][k], files["jax"][k])


@pytest.mark.parametrize("what", ["parallel_backward", "sqp",
                                  "wrong_device", "direct_transcription",
                                  "adaptive_jerk", "mesh_collision"])
def test_unported_options_and_wrong_devices_raise(what, tmp_path):
    """Options without a port raise and name their ROADMAP item; the
    routes that the classic-task slice ported (the associative-scan
    Riccati, ``method="sqp"``, ``SolveDirectTranscription``) run on the
    CPU; a solver on another device than its multibody system, or on a
    missing card, raises."""
    from drake_ddp_tpu_torch import IterativeLinearQuadraticRegulator
    from drake_ddp_tpu_torch.dynamics import pendulum_system
    from drake_ddp_tpu_torch.examples import (cart_pole_with_wall,
                                              mini_cheetah, pendulum)

    def pendulum_solver(N, **kw):
        ilqr = IterativeLinearQuadraticRegulator(
            pendulum_system(dt=1e-2), N, verbose=False, device="cpu", **kw)
        ilqr.SetTargetState(np.array([np.pi, 0.0]))
        ilqr.SetTerminalCost(100 * np.eye(2))
        return ilqr

    if what == "parallel_backward":
        costs = [pendulum_solver(30, max_iters=10,
                                 parallel_backward=pb).Solve()[3]
                 for pb in (True, False)]
        assert costs[0] == pytest.approx(costs[1], rel=1e-4)
    elif what == "sqp":
        x, u, _, cost = pendulum.run(pendulum.Config(T=0.2, method="sqp",
                                                     verbose=False),
                                     device="cpu")
        assert x.shape == (2, 20) and u.shape == (1, 19)
        assert np.isfinite(x).all() and np.isfinite(cost)
    elif what == "direct_transcription":
        from drake_ddp_tpu_torch.solver.transcription import (
            TranscriptionConfig)
        x, u, _, cost = pendulum_solver(10).SolveDirectTranscription(
            TranscriptionConfig(num_steps=10, num_rounds=2, inner_steps=20))
        assert x.shape == (2, 10) and np.isfinite(cost)
    elif what == "adaptive_jerk":
        # the wall example's multi-start with adaptiveJerk at the JAX
        # example's thresholds (short horizon, two starts)
        cfg = cart_pole_with_wall.Config(
            T=0.2, num_starts=2, max_iters=3, verbose=False,
            use_derivative_interpolation=True, keypoint_method="adaptiveJerk")
        assert tuple(cart_pole_with_wall.problem(cfg, "cpu")[0].derivs) == (
            "adaptiveJerk", 1, 100, 0.0007, 5e-5, None, None)
        res, _ = cart_pole_with_wall.solve_multistart(cfg, device="cpu")
        assert np.isfinite(res.costs.numpy()).all()
    elif what == "mesh_collision":
        from drake_ddp_tpu_torch.contact.geometry import (ContactProps,
                                                          GeometrySet)
        from drake_ddp_tpu_torch.io.urdf import UrdfCollision, _add_collision
        (tmp_path / "link.obj").write_text(
            "v 0 0 0\nv 0.4 0 0\nv 0.4 0.05 0\nv 0 0.05 0.05\n")
        mesh = UrdfCollision("mesh", np.zeros(3), np.eye(3), np.ones(3),
                             "link.obj", ContactProps())
        gs = GeometrySet()
        _add_collision(gs, 0, mesh, str(tmp_path))
        assert gs.geoms and all(g.kind == "sphere" for g in gs.geoms)
    else:
        # a multibody system on the CPU, a solver asked for another device
        system, _ = mini_cheetah.build_system(mini_cheetah.Config(),
                                              device="cpu")
        with pytest.raises(ValueError, match="build the system on"):
            IterativeLinearQuadraticRegulator(system, 10, device="meta")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                IterativeLinearQuadraticRegulator(pendulum_system(dt=1e-2),
                                                  10)
