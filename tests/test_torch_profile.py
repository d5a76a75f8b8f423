"""The port's phase-timed solve and profiling helpers against the JAX
package: ``solver/profile.py`` (``profiled_solve``,
``profiled_solve_batched``, ``PhaseTimes``, ``format_phase_table``), the
class API's ``SolveProfiled``, ``utils/timing.PhaseTimer``'s host spans
and counters and ``utils/profiling.trace``, on the CPU.

Tolerances: the profiled solves run the port's ordinary solves, so they
give the same bits; against JAX, the pendulum (N 80, 10 iterations, the
JAX package's tests/test_aux.py case) with equal iterations and its cost
within rtol 1e-4 (the pin of tests/test_torch_scenario.py); the
cart-pole wall's four starts (N 40, tests/test_aux.py) at the chain-level
pins, iterations +-1 and costs within 15%.  Inputs are numpy-seeded.
The JAX profiled solves jit their phases themselves; here they compile
at XLA level 0 (``JAX_QUICK_COMPILE``, as the other port files' JAX
references do)."""

import functools
import json

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import JAX_QUICK_COMPILE  # noqa: E402


@pytest.fixture
def quick_jax_jit(monkeypatch):
    """jax.jit at XLA level 0 while the test runs."""
    monkeypatch.setattr(jax, "jit", functools.partial(
        jax.jit, compiler_options=JAX_QUICK_COMPILE))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of tiny tensor ops: one intra-op thread (see
    tests/test_torch_classic.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pendulum(dt=1e-2, N=80):
    """The pendulum swing-up of tests/test_aux.py: (config kwargs, numpy
    problem arrays)."""
    arrays = dict(x0=np.zeros(2), x_nom=np.array([np.pi, 0.0]),
                  Q=dt * 0.01 * np.diag([0, 1.0]), R=dt * 0.01 * np.eye(1),
                  Qf=100 * np.eye(2), u_init=np.zeros((N - 1, 1)))
    return dict(num_steps=N, max_iters=10), {
        k: v.astype(np.float32) for k, v in arrays.items()}


def _assert_same_solution(a, b):
    for name, fa, fb in zip(a._fields, a, b):
        if isinstance(fa, tuple):
            _assert_same_solution(fa, fb)
        elif fa is not None:
            assert torch.equal(fa, fb), name


def test_profiled_solve_is_solve_ilqr_and_matches_jax(quick_jax_jit):
    """The pendulum: the port's own solve_ilqr bit for bit; JAX
    profiled_solve's iterations, its cost to rtol 1e-4; one PhaseTimes
    entry per phase per iteration, all >= 0; the table's columns."""
    from drake_ddp_tpu.dynamics import pendulum_system as jpendulum
    from drake_ddp_tpu.solver.ilqr import ILQRConfig as JConfig
    from drake_ddp_tpu.solver.ilqr import ILQRProblem as JProblem
    from drake_ddp_tpu.solver.profile import profiled_solve as jprofiled
    from drake_ddp_tpu_torch.dynamics import pendulum_system
    from drake_ddp_tpu_torch.solver import (ILQRConfig, ILQRProblem,
                                            PhaseTimes, format_phase_table,
                                            profiled_solve, solve_ilqr)

    kw, arrays = _pendulum()
    system = pendulum_system(dt=1e-2)
    cfg = ILQRConfig(**kw)
    prob = ILQRProblem(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    sol, times = profiled_solve(system, cfg, prob)
    _assert_same_solution(sol, solve_ilqr(system, cfg, prob))

    ref, _ = jprofiled(jpendulum(dt=1e-2), JConfig(**kw),
                       JProblem(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()}))
    k = int(ref.iterations)
    assert int(sol.iterations) == k
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-4)

    assert isinstance(times, PhaseTimes)
    assert len(times.forward) == len(times.derivs) == len(times.backward) == k
    assert all(t >= 0 for t in times.forward + times.derivs + times.backward)
    assert min(times.forward) > 0 and min(times.backward) > 0
    assert set(times.totals()) == {"forward", "derivs", "backward"}
    assert sum(times.fractions().values()) == pytest.approx(1.0)
    table = format_phase_table(sol, times)
    for col in ("time_fp", "time_derivs", "time_bp", "phase totals"):
        assert col in table
    assert len(table.splitlines()) == k + 5

    # device= moves numpy leaves to the solve's device
    sol_np, _ = profiled_solve(system, cfg, ILQRProblem(**arrays),
                               device="cpu")
    _assert_same_solution(sol_np, sol)


def _wall_problem(B=4, N=40, dt=1e-2):
    """tests/test_aux.py's four wall starts: numpy problem arrays."""
    rng = np.random.default_rng(0)
    x0b = np.tile([0.0, np.pi + 0.5, 0.0, 0.0], (B, 1)).astype(np.float32)
    x0b += 0.01 * rng.standard_normal(x0b.shape).astype(np.float32)
    tile = lambda a: np.tile(np.asarray(a, np.float32)[None], (B, 1, 1))
    return dict(
        x0=x0b,
        x_nom=np.tile(np.asarray([0.0, np.pi, 0.0, 0.0], np.float32),
                      (B, 1)),
        Q=tile(dt * np.diag([0.1, 1.0, 0.01, 0.01])),
        R=tile(dt * 0.001 * np.eye(1)),
        Qf=tile(np.diag([200.0, 200.0, 10.0, 10.0])),
        u_init=np.zeros((B, N - 1, 1), np.float32))


def test_profiled_solve_batched_is_solve_ilqr_batched_and_matches_jax(
        quick_jax_jit):
    """The wall's four starts (N 40): the port's solve_ilqr_batched bit
    for bit, one record per round of the batch loop; JAX
    profiled_solve_batched at the chain-level pins."""
    from drake_ddp_tpu.examples import cart_pole_with_wall as jw
    from drake_ddp_tpu.solver.ilqr import ILQRConfig as JConfig
    from drake_ddp_tpu.solver.ilqr import ILQRProblem as JProblem
    from drake_ddp_tpu.solver.profile import \
        profiled_solve_batched as jprofiled
    from drake_ddp_tpu_torch.examples import cart_pole_with_wall as tw
    from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig, ILQRProblem
    from drake_ddp_tpu_torch.solver.profile import profiled_solve_batched
    from drake_ddp_tpu_torch.utils.timing import phase

    arrays = _wall_problem()
    kw = dict(num_steps=40, beta=0.5, max_iters=8)
    system = tw.build_system(tw.Config(), device="cpu")
    cfg = ILQRConfig(**kw)
    prob = ILQRProblem(**{k: torch.as_tensor(v) for k, v in arrays.items()})

    class Rounds:
        """Counts the solver's Riccati phases: one a round."""
        n = 0

        def phase(self, name):
            self.n += name == "riccati"
            return phase(None, name)

    rounds = Rounds()
    sol, times = profiled_solve_batched(system, cfg, prob)
    _assert_same_solution(sol, solve_ilqr_batched(system, cfg, prob,
                                                  timer=rounds))
    assert len(times.forward) == len(times.derivs) == rounds.n
    assert rounds.n == int(sol.iterations.max())
    assert min(times.derivs) > 0

    ref, _ = jprofiled(jw.build_system(jw.Config()), JConfig(**kw),
                       JProblem(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()}))
    np.testing.assert_allclose(sol.iterations.numpy(),
                               np.asarray(ref.iterations), atol=1)
    np.testing.assert_allclose(sol.cost.numpy(), np.asarray(ref.cost),
                               rtol=0.15)


def test_solve_profiled_returns_the_five_tuple(capsys):
    """SolveProfiled on the CPU: Solve()'s contract, the same bits, and
    PhaseTimes as the fifth; with verbose the phase table is printed."""
    from drake_ddp_tpu_torch.examples import pendulum as tex
    from drake_ddp_tpu_torch.solver.profile import PhaseTimes

    ilqr = tex.build_solver(tex.Config(verbose=False), device="cpu")
    x, u, _, cost = ilqr.Solve()
    ilqr.verbose = True
    out = ilqr.SolveProfiled()
    assert len(out) == 5 and isinstance(out[4], PhaseTimes)
    np.testing.assert_array_equal(out[0], x)
    np.testing.assert_array_equal(out[1], u)
    assert out[3] == cost and out[2] > 0
    assert len(out[4].forward) == int(ilqr._solution.iterations)
    printed = capsys.readouterr().out
    assert "time_fp" in printed and "phase totals" in printed


def test_phase_timer_and_trace(tmp_path):
    """PhaseTimer sums named host spans (phases and host-only spans alike)
    under ``host:<name>``, the phases' events (where it records them, on
    a host with a card) under their names, and counts spans and counters
    in ``counts``; trace writes a Chrome trace of the block that names
    its operators."""
    from drake_ddp_tpu_torch.utils.profiling import trace
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer, span

    t = PhaseTimer()
    assert t.cuda == torch.cuda.is_available()
    for _ in range(2):
        with t.phase("a"):
            pass
    with span(t, "b"):
        torch.ones(3).sum()
    t.count("lanes", 3)
    t.count("lanes", 2)
    assert t.counts == {"a": 2, "b": 1, "lanes": 5}
    totals = t.totals_ms()
    assert set(totals) == {"host:a", "host:b"} | ({"a"} if t.cuda else set())
    assert min(totals.values()) >= 0

    with trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path / "tr")
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any("mm" in n for n in names)
