"""The port's parallel/sharding.py against ``drake_ddp_tpu.parallel`` on
the same seeded problems (tests/test_parallel.py's cart-pole batch): the
port shards over ``["cpu", "cpu"]``, JAX over the conftest's 8 CPU
devices.  Costs within rtol 1e-4 (float32 on both sides), iterations and
the summary statistics exactly.

Also the port's own contracts: the per-scenario Jacobian route and its
``root_seed``, the host threads that drive shards on distinct cards, and
the launch counts those threads share."""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")

from test_parallel import _make_probs  # noqa: E402

N_SOLVE, N_MPC = 12, 10
CPU2 = ["cpu", "cpu"]


def _port(probs):
    """A JAX ILQRProblem of numpy-convertible leaves as the port's."""
    from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem
    return ILQRProblem(*(None if a is None else torch.as_tensor(
        np.asarray(a)) for a in probs))


@functools.lru_cache(maxsize=None)
def _solved():
    """(JAX (sols, stats), port (sols, stats)) of the 16-scenario
    cart-pole batch, N 12, max_iters 4."""
    from drake_ddp_tpu.dynamics.analytic import cart_pole_system as jcp
    from drake_ddp_tpu.parallel import batched_solve as jsolve
    from drake_ddp_tpu.solver.ilqr import ILQRConfig as JCfg
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.parallel import batched_solve
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig

    probs = _make_probs(16, N_SOLVE)
    ref = jsolve(jcp(dt=1e-2), JCfg(num_steps=N_SOLVE, max_iters=4,
                                    beta=0.5), probs)
    got = batched_solve(cart_pole_system(dt=1e-2),
                        ILQRConfig(num_steps=N_SOLVE, max_iters=4,
                                   beta=0.5), _port(probs), mesh=CPU2)
    return ref, got


def _assert_stats(stats, cost, diverged, iterations):
    B = cost.shape[0]
    assert float(stats.mean_cost) == pytest.approx(
        float(torch.sum(cost)) / B, rel=1e-6)
    assert int(stats.num_diverged) == int(diverged.sum())
    assert int(stats.total_iterations) == int(iterations.sum())


def test_batched_solve_matches_jax():
    (jsols, jstats), (sols, stats) = _solved()
    assert sols.cost.shape == (16,) and sols.x.shape == (16, N_SOLVE, 4)
    np.testing.assert_allclose(sols.cost.numpy(), np.asarray(jsols.cost),
                               rtol=1e-4)
    np.testing.assert_array_equal(sols.iterations.numpy(),
                                  np.asarray(jsols.iterations))
    _assert_stats(stats, sols.cost, sols.diverged, sols.iterations)
    assert int(stats.total_iterations) == int(jstats.total_iterations)
    assert int(stats.num_diverged) == int(jstats.num_diverged) == 0
    assert float(stats.mean_cost) == pytest.approx(
        float(jstats.mean_cost), rel=1e-4)


def test_batched_solve_scenario_matches_single_solve():
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig, ILQRProblem,
                                                 solve_ilqr)

    _, (sols, _) = _solved()
    probs = _port(_make_probs(16, N_SOLVE))
    one = solve_ilqr(cart_pole_system(dt=1e-2),
                     ILQRConfig(num_steps=N_SOLVE, max_iters=4, beta=0.5),
                     ILQRProblem(*(None if a is None else a[3]
                                   for a in probs)))
    assert float(one.cost) == pytest.approx(float(sols.cost[3]), rel=1e-4)
    assert int(one.iterations) == int(sols.iterations[3])


def test_one_device_mesh_returns_the_direct_solve():
    """A one-entry mesh returns exactly what the batched solver returns;
    the stats are its sums."""
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.parallel import batched_solve
    from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig

    system = cart_pole_system(dt=1e-2)
    cfg = ILQRConfig(num_steps=N_SOLVE, max_iters=4, beta=0.5)
    probs = _port(_make_probs(8, N_SOLVE, seed=3))
    sols, stats = batched_solve(system, cfg, probs, mesh=["cpu"])
    direct = solve_ilqr_batched(system, cfg, probs, rollout_kernel="plain",
                                deriv_kernel="lane")
    for a, b in zip(sols[:7], direct[:7]):
        assert torch.equal(a, b)
    assert float(stats.mean_cost) == float(torch.sum(direct.cost) / 8)
    _assert_stats(stats, direct.cost, direct.diverged, direct.iterations)


def test_batched_solve_rejects_ragged_batch():
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.parallel import batched_solve
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig

    with pytest.raises(ValueError, match="divide"):
        batched_solve(cart_pole_system(dt=1e-2),
                      ILQRConfig(num_steps=8, max_iters=2),
                      _port(_make_probs(9, 8)), mesh=CPU2)


def test_batched_mpc_matches_jax():
    from drake_ddp_tpu.dynamics.analytic import cart_pole_system as jcp
    from drake_ddp_tpu.mpc.driver import MPCConfig as JMPC
    from drake_ddp_tpu.parallel import batched_mpc as jmpc
    from drake_ddp_tpu.solver.ilqr import ILQRConfig as JCfg
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.mpc.driver import MPCConfig
    from drake_ddp_tpu_torch.parallel import batched_mpc
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig

    probs = _make_probs(8, N_MPC)
    jres, jstats = jmpc(jcp(dt=1e-2), JCfg(num_steps=N_MPC, max_iters=3,
                                           beta=0.5), probs,
                        JMPC(num_resolves=2, replan_steps=2))
    res, stats = batched_mpc(
        cart_pole_system(dt=1e-2),
        ILQRConfig(num_steps=N_MPC, max_iters=3, beta=0.5), _port(probs),
        MPCConfig(num_resolves=2, replan_steps=2), mesh=CPU2)
    assert res.states.shape == (8, N_MPC + 4, 4)
    assert res.costs.shape == (8, 3)
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(jres.costs),
                               rtol=1e-4)
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    _assert_stats(stats, res.costs[:, -1], res.diverged, res.iterations)
    assert int(stats.total_iterations) == int(jstats.total_iterations)
    assert int(stats.num_diverged) == int(jstats.num_diverged)
    assert float(stats.mean_cost) == pytest.approx(
        float(jstats.mean_cost), rel=1e-4)


def test_host_device_mesh_single_process():
    """The (process, device) mesh is (1, n) in one process, and
    batched_solve takes it unchanged."""
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.parallel import batched_solve, multihost
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig

    mesh = multihost.host_device_mesh(CPU2)
    assert mesh.shape == (1, 2) and mesh.rank == 0
    assert multihost.host_device_mesh(["cpu"]).shape == (1, 1)
    probs = multihost.process_local_problem(
        mesh, _make_probs(16, N_SOLVE))
    sols, stats = batched_solve(cart_pole_system(dt=1e-2),
                                ILQRConfig(num_steps=N_SOLVE, max_iters=4,
                                           beta=0.5), probs, mesh=mesh)
    (_, _), (ref, ref_stats) = _solved()
    assert torch.equal(sols.cost, ref.cost)
    assert stats == ref_stats


def test_multibody_system_must_live_on_the_shards_device():
    """A multibody system carries device tables: a shard on another
    device raises; a builder is called once per distinct device."""
    import drake_ddp_tpu_torch.contact.geometry as tgeom
    import drake_ddp_tpu_torch.multibody.model as tmodel
    from drake_ddp_tpu_torch.models.small import small_manipulation
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
    from drake_ddp_tpu_torch.parallel import sharding

    model, contact = small_manipulation(tmodel, tgeom, device="cpu")
    system = make_multibody_system(model, contact, 2e-3, contact_iters=2)
    with pytest.raises(ValueError, match="build_system"):
        sharding._systems(system, [torch.device("meta")])
    built = []
    build = lambda d: built.append(d) or system
    got = sharding._systems(build, [torch.device("cpu")] * 3)
    assert got == [system] * 3 and built == [torch.device("cpu")]


def test_shards_on_distinct_cards_run_in_threads_of_their_own():
    """Each shard on its own card gets a host thread: two shards that
    wait for each other finish (in order they would block).  Shards on
    one device, or on a torch.func Jacobian route, run in order."""
    from drake_ddp_tpu_torch.parallel import sharding

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert sharding._threaded(cards, {})
    assert not sharding._threaded(cards, {"deriv_kernel": "lane"})
    assert not sharding._threaded([torch.device("cuda", 0)] * 2, {})
    assert not sharding._threaded([torch.device("cpu")] * 2, {})
    meet = threading.Barrier(2, timeout=20)
    cpu = [torch.device("cpu")] * 2
    out = sharding._run_shards([lambda k=k: (meet.wait(), k)[1]
                                for k in range(2)], cpu, threaded=True)
    assert out == [0, 1]
    with pytest.raises(ZeroDivisionError):
        sharding._run_shards([lambda: 1, lambda: 1 / 0], cpu,
                             threaded=True)


def test_launch_counts_lose_no_update_across_threads():
    """The kernel wrappers' launch counts, bumped from the threads of a
    multi-card mesh, add up."""
    from concurrent.futures import ThreadPoolExecutor

    from drake_ddp_tpu_torch.ops import _cuda

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = [pool.submit(lambda: [_cuda.count_launch(wrapper)
                                         for _ in range(2000)])
                    for _ in range(16)]
            for f in futs:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000


def test_scenario_routes_take_root_seed_to_the_solver(monkeypatch):
    """The per-scenario route is the system's (multibody: megaroll and
    the cold megajac), ``scenario_routes(root_seed=True)`` names the
    root-seeded one, and what scenario_routes returns reaches
    solve_ilqr_batched through solve_ilqr and the class API (the way
    scenario_chaos.py's ``megajac_root`` route takes it)."""
    import drake_ddp_tpu_torch.contact.geometry as tgeom
    import drake_ddp_tpu_torch.multibody.model as tmodel
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.models.small import small_manipulation
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
    from drake_ddp_tpu_torch.solver import batched, ilqr
    from drake_ddp_tpu_torch.solver.api import (
        IterativeLinearQuadraticRegulator)
    from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig, ILQRProblem,
                                                 scenario_routes, solve_ilqr)

    model, contact = small_manipulation(tmodel, tgeom, device="cpu")
    mb = make_multibody_system(model, contact, 2e-3, contact_iters=2)
    assert scenario_routes(mb) == dict(rollout_kernel="fused",
                                       deriv_kernel="megajac",
                                       root_seed=False)
    assert scenario_routes(mb, root_seed=True)["root_seed"] is True
    assert scenario_routes(cart_pole_system(dt=1e-2)) == dict(
        rollout_kernel="plain", deriv_kernel="lane", root_seed=False)
    seen = []

    def spy(system, cfg, prob, **kw):
        seen.append(kw["root_seed"])
        raise StopIteration

    monkeypatch.setattr(batched, "solve_ilqr_batched", spy)
    n, m, N = mb.n, mb.m, 3
    prob = ILQRProblem(x0=torch.zeros(n), x_nom=torch.zeros(n),
                       Q=torch.eye(n), R=torch.eye(m), Qf=torch.eye(n),
                       u_init=torch.zeros(N - 1, m))
    ilqr_api = IterativeLinearQuadraticRegulator(mb, N, device="cpu",
                                                 verbose=False)
    for root in (False, True):
        if root:
            monkeypatch.setattr(ilqr, "scenario_routes",
                                lambda system, deriv_kernel=None:
                                scenario_routes(system, deriv_kernel,
                                                root_seed=True))
        with pytest.raises(StopIteration):
            solve_ilqr(mb, ILQRConfig(num_steps=N), prob)
        with pytest.raises(StopIteration):
            ilqr_api.Solve()
    assert seen == [False, False, True, True]

