"""The port's tracing on the CPU: ``utils/timing.PhaseTimer``'s spans and
lane counters inside the batched solve and the MPC driver, the solver's
profiler annotations, and ``utils/profiling.idle_by_span``.

A batch of four pendulum swing-ups (N 10) whose lanes stop at different
rounds: the counters meet exact identities with the solution, and the
solution is the same bits without a timer, with one, and under an active
profiler."""

import json

import numpy as np
import pytest
import torch

B, N, DT = 4, 10, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pendulum():
    """(system, cfg, prob, routes) of four swing-ups from spread
    starts."""
    from drake_ddp_tpu_torch.dynamics import pendulum_system
    from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig, ILQRProblem,
                                                 scenario_routes)

    system = pendulum_system(dt=DT)
    tile = lambda a: a[None].repeat(B, *([1] * a.dim()))
    prob = ILQRProblem(
        x0=torch.tensor([[0.0, 0.0], [0.5, 0.0], [2.5, 0.3], [-1.0, 1.0]]),
        x_nom=tile(torch.tensor([np.pi, 0.0])),
        Q=tile(torch.diag(torch.tensor([0.0, DT * 0.01]))),
        R=tile(DT * 0.01 * torch.eye(1)), Qf=tile(100.0 * torch.eye(2)),
        u_init=torch.zeros(B, N - 1, 1))
    cfg = ILQRConfig(num_steps=N, max_iters=10)
    return system, cfg, prob, scenario_routes(system)


def _solve(pendulum, timer=None):
    from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
    system, cfg, prob, routes = pendulum
    return solve_ilqr_batched(system, cfg, prob, timer=timer, **routes)


def _assert_same_solution(a, b):
    for name, fa, fb in zip(a._fields, a, b):
        if isinstance(fa, tuple):
            _assert_same_solution(fa, fb)
        elif fa is not None:
            assert torch.equal(fa, fb), name


def test_lane_counters_meet_the_solution(pendulum):
    """Each round counts its lanes still iterating and B; each linesearch
    chunk the lanes it keeps and B; spans are counted and timed on the
    host."""
    from drake_ddp_tpu_torch.solver.batched import any_lane
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer

    timer = PhaseTimer()
    syncs = any_lane.syncs
    sol = _solve(pendulum, timer)
    c = timer.counts
    iters = sol.iterations
    assert len(set(iters.tolist())) > 1, "the lanes stop at other rounds"
    assert c["lanes_active"] == int(iters.sum())
    assert c["lane_slots"] == B * c["riccati"]
    assert c["riccati"] == int(iters.max())
    assert c["ls_lanes_kept"] <= c["ls_lane_slots"]
    assert c["ls_lane_slots"] == B * c["rollout"]
    # every flag read is one synchronisation and one wait span
    assert any_lane.syncs - syncs == c["wait.round"] + c["wait.ls"]
    assert c["wait.round"] == c["riccati"] + 1 and c["solve"] == 1
    totals = timer.totals_ms()
    # events for the phases exactly where the timer records them (a host
    # with a card); host-only spans never
    phases = {k[5:] for k in totals if k.startswith("host:")} - {
        "solve", "wait.round", "wait.ls"}
    assert ({k for k in totals if ":" not in k}
            == (phases if timer.cuda else set()))
    assert totals["host:solve"] >= (totals["host:linesearch"]
                                    + totals["host:riccati"]) > 0


def test_solution_is_the_same_bits_under_a_timer_and_a_profiler(
        pendulum, tmp_path):
    """Without a timer, with one, and with a RoundTimer forwarding to one
    under an active profiler: the same bits, and the trace holds the
    solver's ``ddp/`` ranges."""
    from drake_ddp_tpu_torch.solver.profile import RoundTimer
    from drake_ddp_tpu_torch.utils.profiling import trace
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer

    plain = _solve(pendulum)
    timer = PhaseTimer()
    _assert_same_solution(_solve(pendulum, timer), plain)
    inner = PhaseTimer()
    with trace(str(tmp_path)):
        traced = _solve(pendulum, RoundTimer("cpu", inner=inner))
    _assert_same_solution(traced, plain)
    assert inner.counts == timer.counts
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert {"ddp/solve", "ddp/riccati", "ddp/wait.round",
            "ddp/wait.ls"} <= names


def test_profiled_solve_under_a_timer_of_phases_alone(pendulum):
    """SolveProfiled's solve with an inner timer that brackets phases and
    has neither ``span`` nor ``count``: the solve runs, its bits are the
    plain solve's, and the timer sees every round's phases."""
    import contextlib

    from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem, solve_ilqr
    from drake_ddp_tpu_torch.solver.profile import profiled_solve

    class Phases:
        def __init__(self):
            self.counts = {}

        @contextlib.contextmanager
        def phase(self, name):
            self.counts[name] = self.counts.get(name, 0) + 1
            yield

    system, cfg, prob, _ = pendulum
    one = ILQRProblem(*(None if a is None else a[2] for a in prob))
    phases = Phases()
    sol, times = profiled_solve(system, cfg, one, timer=phases)
    _assert_same_solution(sol, solve_ilqr(system, cfg, one))
    assert phases.counts["riccati"] == len(times.backward) == int(
        sol.iterations)


def test_mpc_span_holds_its_solves(pendulum):
    """mpc_solve_batched is the host-only span ``mpc`` around its
    solves, each the span ``solve``."""
    from drake_ddp_tpu_torch.mpc.driver import MPCConfig, mpc_solve_batched
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer

    system, cfg, prob, routes = pendulum
    timer = PhaseTimer()
    res = mpc_solve_batched(system, cfg, prob,
                            MPCConfig(num_resolves=1, replan_steps=2),
                            timer=timer, **routes)
    assert timer.counts["mpc"] == 1 and timer.counts["solve"] == 2
    assert timer.counts["lanes_active"] == int(res.iterations.sum())
    totals = timer.totals_ms()
    assert totals["host:mpc"] >= totals["host:solve"] > 0


def test_idle_by_span_puts_each_gap_under_its_innermost_span(tmp_path):
    """A synthetic trace (us): kernels at [0, 10], [20, 30], [50, 60],
    [100, 110], [112, 120]; ``ddp/solve`` over [0, 95] holds
    ``ddp/riccati`` over [12, 40]; the device's own annotation ranges and
    other host events name no gap."""
    from drake_ddp_tpu_torch.utils.profiling import idle_by_span

    kern = lambda s, e: {"ph": "X", "cat": "kernel", "name": "k",
                         "ts": s, "dur": e - s}
    host = lambda s, e, name, cat="user_annotation": {
        "ph": "X", "cat": cat, "name": name, "ts": s, "dur": e - s}
    events = [kern(0, 10), kern(20, 30), kern(50, 60), kern(100, 110),
              kern(105, 108), kern(112, 120),
              host(0, 95, "ddp/solve"), host(12, 40, "ddp/riccati"),
              host(30, 60, "aten::bmm", "cpu_op"),
              host(60, 120, "ddp/riccati", "gpu_user_annotation"),
              host(96, 121, "other"), {"ph": "i", "name": "ddp/x", "ts": 5}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    idle = idle_by_span(str(path))
    # gaps: (10, 20) mid 15 riccati; (30, 50) mid 40 riccati (closed
    # ends hold); (60, 100) mid 80 solve; (110, 112) mid 111 outside
    assert idle == pytest.approx({"ddp/riccati": 30e-6, "ddp/solve": 40e-6,
                                  "outside": 2e-6})
    assert list(idle) == ["ddp/solve", "ddp/riccati", "outside"]
    assert idle_by_span({"traceEvents": events[6:]}) == {}
