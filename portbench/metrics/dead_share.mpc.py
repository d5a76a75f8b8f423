"""dead_share.mpc (MPC driver): the share of lanes latched dead when the
window closed, in %."""


def read(run):
    if run.kind != "mpc":
        return None
    return 100.0 * run.summary["dead_per_resolve"][-1]
