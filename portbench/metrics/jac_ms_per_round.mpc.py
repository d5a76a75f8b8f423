"""jac_ms_per_round.mpc (step Jacobian): device ms of the step-Jacobian
calls per iLQR round."""

from portbench.layers import ms_per_round


def read(run):
    return ms_per_round(run, "jac") if run.kind == "mpc" else None
