"""riccati_ms_per_round.solve (Riccati): ms per iLQR round of the Riccati
sweep, between CUDA events around it (host-bound: the events span the
host's enqueue too)."""

from portbench.layers import ms_per_round


def read(run):
    return ms_per_round(run, "riccati") if run.kind == "solve" else None
