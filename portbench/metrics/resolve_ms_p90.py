"""resolve_ms_p90: the 90th percentile of the wall time of one batched
resolve and its handoff (host clock, ending in a synchronise), over every
resolve of the window."""

from portbench.layers import p90_ms


def read(run):
    if run.kind != "mpc":
        return None
    return p90_ms(run.step_s)
