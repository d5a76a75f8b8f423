"""The readers of the program's host spans and lane counters: each reads
its number from a hand-built run, and reads nothing from a run of a
program whose timer has no host spans or lane counters, or from the other
cell's kind of run."""

from types import SimpleNamespace

import pytest

from portbench import run as harness

# the event phases and counts of a timer without host spans or counters
PARENT_MS = {"linesearch": 600.0, "rollout": 500.0, "derivs": 90.0,
             "jac": 80.0, "riccati": 550.0}
PARENT_COUNTS = {"linesearch": 10, "rollout": 20, "derivs": 10, "jac": 10,
                 "riccati": 10}
HOST_MS = {"host:solve": 2000.0, "host:linesearch": 300.0,
           "host:derivs": 40.0, "host:riccati": 500.0,
           "host:wait.round": 1100.0, "host:wait.ls": 200.0,
           "host:rollout": 100.0, "host:jac": 30.0, "host:mpc": 2025.0}
HOST_COUNTS = {"solve": 1, "mpc": 1, "wait.round": 11, "wait.ls": 20,
               "lanes_active": 30, "lane_slots": 40, "ls_lanes_kept": 25,
               "ls_lane_slots": 80}

# rounds 10: (host:wait.round + host:wait.ls) / 10 = 130; the loop's
# own host time (2000 - 300 - 40 - 500 - 1100) / 10 = 6; the driver's
# (2025 - 2000) / 1 resolve = 25
EXPECTED = {"riccati_host_ms_per_round": 50.0,
            "host_wait_ms_per_round": 130.0,
            "loop_host_ms_per_round": 6.0,
            "active_lane_share": 75.0,
            "ls_active_lane_share": 31.25,
            "mpc_host_ms_per_resolve": 25.0}
READERS = [(f"{base}.{kind}", kind, value)
           for base, value in EXPECTED.items()
           for kind in ("mpc", "solve")
           if not (base == "mpc_host_ms_per_resolve" and kind == "solve")]


def _run(kind, host=True):
    ms, counts = dict(PARENT_MS), dict(PARENT_COUNTS)
    if host:
        ms.update(HOST_MS)
        counts.update(HOST_COUNTS)
    return SimpleNamespace(kind=kind, phases_ms=ms, counts=counts)


def test_every_reader_is_in_the_benchmark():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cells = {"mpc": "cheetah_mpc_b256", "solve": "panda_side_k128"}
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert len(READERS) == 11
    for name, kind, _ in READERS:
        assert entries[name]["workloads"] == [cells[kind]], name


@pytest.mark.parametrize("name,kind,value", READERS,
                         ids=[r[0] for r in READERS])
def test_reader_reads_the_spans_and_counters(name, kind, value):
    read = harness.load_reader(name)
    assert read(_run(kind)) == pytest.approx(value)
    other = "solve" if kind == "mpc" else "mpc"
    assert read(_run(other)) is None
    # a program whose timer keeps events and phase counts alone
    assert read(_run(kind, host=False)) is None
    # a window with no round in it
    empty = _run(kind)
    empty.phases_ms, empty.counts = {}, {}
    assert read(empty) is None
