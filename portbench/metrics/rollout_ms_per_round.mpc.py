"""rollout_ms_per_round.mpc (rollout kernel): device ms of the linesearch
rollouts per iLQR round."""

from portbench.layers import ms_per_round


def read(run):
    return ms_per_round(run, "rollout") if run.kind == "mpc" else None
