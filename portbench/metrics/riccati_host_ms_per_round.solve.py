"""riccati_host_ms_per_round.solve (Riccati): host ms per iLQR round
spent in the Riccati sweep (the port's ``host:riccati`` span): the host's
enqueue of the sweep.  Beside ``riccati_ms_per_round.solve`` (CUDA events
around the same sweep): host time near the event time is a host-bound
sweep."""

from portbench.layers import ms_per_round


def read(run):
    return ms_per_round(run, "host:riccati") if run.kind == "solve" else None
