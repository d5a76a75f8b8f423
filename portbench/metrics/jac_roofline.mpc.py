"""jac_roofline.mpc (step Jacobian): the least time of the window's
Jacobian work, counted from the problem's sizes, over the Jacobian
phase's measured device time, in %."""

from portbench.layers import jac_work, roofline


def read(run):
    return roofline(run, jac_work, "jac") if run.kind == "mpc" else None
