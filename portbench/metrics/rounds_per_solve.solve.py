"""rounds_per_solve.solve (batched iLQR): iLQR rounds per multi-start
batch; the batch runs until its slowest start ends."""

from portbench.layers import rounds


def read(run):
    if run.kind != "solve" or not rounds(run):
        return None
    return rounds(run) / run.summary["batches"]
