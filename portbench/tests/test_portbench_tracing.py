"""The trace reduction: device busy time as the union of device
intervals, operations by device time, and each idle gap named by the
innermost host event of the busiest thread around its middle."""

from portbench import tracing


def test_reduce_events():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 40, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 80,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::bmm", "ts": 20,
         "dur": 15, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "other thread", "ts": 0,
         "dur": 80, "tid": 2},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    st = tracing.reduce_events(ev, tracing.Stretch())
    assert st.kernels == 4
    assert abs(st.busy_s - 30e-6) < 1e-12
    assert st.device_ops[0][0] == "k1"
    assert abs(st.device_ops[0][1] - 20e-6) < 1e-12
    names = dict(st.idle_gaps)
    assert abs(names["aten::bmm"] - 25e-6) < 1e-12     # gap 15..40
    assert abs(names["outer"] - 15e-6) < 1e-12         # gap 45..60
