"""rollout_roofline.solve (rollout kernel): the least time of the window's
rollout work, counted from the problem's sizes (every rolled-out lane
step), over the rollout phase's measured device time, in %."""

from portbench.layers import rollout_work, roofline


def read(run):
    return roofline(run, rollout_work, "rollout") if run.kind == "solve" else None
