"""healthy_resolves_per_s: lane-resolves of the window that neither
diverged, nor ended above the resolve-cost ceiling, nor ran on a
latched-dead lane, over the window's seconds."""


def read(run):
    if run.kind != "mpc":
        return None
    return run.summary["healthy"] / run.window_s
