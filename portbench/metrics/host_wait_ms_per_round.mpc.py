"""host_wait_ms_per_round.mpc (batched iLQR): host ms per iLQR round
blocked on the card, reading whether any lane is still active (the
port's ``host:wait.round`` and ``host:wait.ls`` spans)."""

from portbench.layers import rounds


def read(run):
    ms = run.phases_ms
    if (run.kind != "mpc" or not rounds(run) or "host:wait.round" not in ms
            or "host:wait.ls" not in ms):
        return None
    return (ms["host:wait.round"] + ms["host:wait.ls"]) / rounds(run)
