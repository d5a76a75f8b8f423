"""device_idle_share.solve (device): the share of the traced stretch in
which no operation ran on the card, in %."""

from portbench.layers import idle_share


def read(run):
    return idle_share(run) if run.kind == "solve" else None
