"""rounds_per_resolve.mpc (batched iLQR): iLQR rounds of the batch per
resolve; the batch runs while any lane is active."""

from portbench.layers import rounds


def read(run):
    if run.kind != "mpc" or not rounds(run):
        return None
    return rounds(run) / run.summary["resolves"]
