"""riccati_host_ms_per_round.mpc (Riccati): host ms per iLQR round
spent in the Riccati sweep (the port's ``host:riccati`` span): the host's
enqueue of the sweep.  Beside ``riccati_ms_per_round.mpc`` (CUDA events
around the same sweep): host time near the event time is a host-bound
sweep."""

from portbench.layers import ms_per_round


def read(run):
    return ms_per_round(run, "host:riccati") if run.kind == "mpc" else None
