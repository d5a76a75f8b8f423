"""A tiny cell through the whole harness on the CPU: a well-formed result
line, no JAX loaded, and ``correct`` false when the timed path is broken
underneath (an answer altered where it is produced, a resolve that
returns its state unchanged, half of the batch left out)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.tests.tiny import run_tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("cheetah_mpc_b256", "panda_side_k128")


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_prints_a_result_line_and_loads_no_jax(workload):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.tests.tiny", workload, "0.3"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    err = proc.stderr.strip().splitlines()
    assert json.loads(err[-1]) == {"forbidden": []}
    assert err[-2].startswith("check ")


def test_the_harness_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _scale_output(fn, index, factor):
    def wrapped(*a, **k):
        out = list(fn(*a, **k))
        out[index] = out[index] * factor
        return tuple(out)
    return wrapped


def _altered_rollout(make, off=0.1):
    """A rollout whose states come out ``off`` off where they are made."""
    def wrapped(system):
        roll = make(system)

        def f(*a):
            xs, us = roll(*a)
            return xs + off, us
        return f
    return wrapped


def _scaled_jac(make):
    def wrapped(system, root_seed):
        jac = make(system, root_seed)
        return lambda *a: _scale_output(jac, 0, 1.01)(*a)
    return wrapped


def _unchanged_resolve(fn):
    """A resolve that returns its incoming policy unchanged, as healthy."""
    def wrapped(system, cfg, prob, mpc, *a, **k):
        res = fn(system, cfg, prob, mpc, *a, **k)
        return res._replace(final_x=prob.x_ref_init, final_u=prob.u_init,
                            final_K=prob.K_init,
                            diverged=torch.zeros_like(res.diverged))
    return wrapped


def _half_batch(fn):
    """A resolve that solves the first half of the batch and hands the
    second half its inputs back, as healthy."""
    def wrapped(system, cfg, prob, mpc, *a, **k):
        res = fn(system, cfg, prob, mpc, *a, **k)
        h = prob.x0.shape[0] // 2
        cut = lambda new, old: torch.cat([new[:h], old[h:]])
        return res._replace(
            final_x=cut(res.final_x, prob.x_ref_init),
            final_u=cut(res.final_u, prob.u_init),
            final_K=cut(res.final_K, prob.K_init),
            diverged=torch.zeros_like(res.diverged))
    return wrapped


def _half_the_starts(fn):
    """A batched solve that solves the first half of its starts and
    returns the rest untouched: the initial tape, its rollout and its
    cost, no gains, as not diverged."""
    from portbench.reference.solver import trajectory_cost

    def wrapped(system, cfg, prob, *a, **k):
        sols = fn(system, cfg, prob, *a, **k)
        B, N = prob.x0.shape[0], cfg.num_steps
        h = B // 2
        u = prob.u_init
        x = [prob.x0]
        for t in range(N - 1):
            x.append(system.lane_step_fn(x[-1].T.contiguous(),
                                         u[:, t].T.contiguous()).T)
        x = torch.stack(x, dim=1)
        cost = trajectory_cost(x, u, prob.x_nom, prob.Q, prob.R, prob.Qf)
        cut = lambda new, old: torch.cat([new[:h], old[h:]])
        return sols._replace(
            x=cut(sols.x, x), u=cut(sols.u, u),
            K=cut(sols.K, torch.zeros_like(sols.K)),
            kappa=cut(sols.kappa, torch.zeros_like(sols.kappa)),
            cost=cut(sols.cost, cost.to(sols.cost.dtype)),
            diverged=torch.zeros_like(sols.diverged))
    return wrapped


# each cell's compared gain number (a widest gap of the Panda's 88 starts
# swings on sound runs)
GAIN = {"cheetah_mpc_b256": "gain_gap_max", "panda_side_k128": "gain_gap_q90"}

FAULTS = {
    "rollout_states_altered": ("drake_ddp_tpu_torch.solver.batched",
                               "megaroll_for_system", _altered_rollout,
                               "step_gap_q90", CELLS),
    "jacobian_altered": ("drake_ddp_tpu_torch.solver.batched",
                         "megajac_for_system", _scaled_jac, GAIN, CELLS),
    "gains_altered": ("drake_ddp_tpu_torch.solver.batched", "_backward_pass",
                      lambda f: _scale_output(f, 1, 1.01), GAIN, CELLS),
    "resolve_returns_its_state": ("drake_ddp_tpu_torch.mpc.driver",
                                  "mpc_solve_batched", _unchanged_resolve,
                                  "step_gap_q90", CELLS[:1]),
    "half_the_batch_left_out": ("drake_ddp_tpu_torch.mpc.driver",
                                "mpc_solve_batched", _half_batch,
                                "step_gap_q90", CELLS[:1]),
    "half_the_starts_left_out": ("drake_ddp_tpu_torch.solver.batched",
                                 "solve_ilqr_batched", _half_the_starts,
                                 GAIN, CELLS[1:]),
    "rollout_states_off_at_every_step": (
        "drake_ddp_tpu_torch.solver.batched", "megaroll_for_system",
        lambda f: _altered_rollout(f, 0.05), "lane_step_gap_median_max",
        CELLS),
}


@pytest.fixture(scope="module")
def sound():
    return {w: run_tiny(w)["checks"] for w in CELLS}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for f, spec in FAULTS.items() for w in spec[4]])
def test_a_broken_timed_path_is_not_correct(workload, fault, sound,
                                            monkeypatch):
    import importlib
    mod_name, attr, wrap, number, _ = FAULTS[fault]
    number = number if isinstance(number, str) else number[workload]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    out = run_tiny(workload)
    got = out["checks"][number]
    assert out["correct"] is False
    assert got["value"] > got["limit"]
    assert got["value"] > 10 * sound[workload][number]["value"] or \
        sound[workload][number]["value"] == 0
