"""solves_per_s: trajectory solves (starts of a multi-start batch, run to
convergence or max_iters) completed in the window, over its seconds."""


def read(run):
    if run.kind != "solve":
        return None
    return run.summary["attempted"] / run.window_s
