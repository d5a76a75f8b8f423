"""The harness finds every cell, configuration, traffic mix, metric
reader and limit from data, and ``BENCHMARK.json`` keeps to its
contract's shape."""

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_loads_from_data(workload):
    bench, cell, cfg, traffic, limits = run.load_cell(workload)
    assert cfg["name"] == cell["config"]
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    assert hasattr(driver, "Driver")
    assert limits["numbers"], "a cell compares at least one number"
    for trace in (False, True):
        metrics = run.cell_metrics(bench, workload, trace)
        assert metrics
        for m in metrics:
            assert callable(run.load_reader(m["name"])), m["name"]
    e2e = {m["name"] for m in run.cell_metrics(bench, workload, False)}
    assert "setup_s" in e2e and len(e2e) >= 2


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics_keep_to_the_contract(group):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if group == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25
            assert m["source"] in ("host_clock", "device_trace")
        else:
            moved = e2e[m["moves"]]
            # every cell that reports a per-layer metric reports the
            # end-to-end metric it moves
            assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
            assert (ROOT / "portbench" / "metrics"
                    / f"{m['name']}.py").exists()


def test_configs_and_cells_are_named_once():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)) and all(map(NAME.match, names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        assert c["file"].startswith("portbench/")
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
