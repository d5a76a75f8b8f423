"""resolve_mfu.mpc (device): the window's rollout, Jacobian and Riccati
operations, counted from the problem's sizes, over the window at the
card's float32 peak, in %."""

from portbench.layers import step_mfu


def read(run):
    return step_mfu(run) if run.kind == "mpc" else None
