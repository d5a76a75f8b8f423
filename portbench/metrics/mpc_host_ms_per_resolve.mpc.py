"""mpc_host_ms_per_resolve.mpc (MPC driver): host ms per resolve of the
MPC driver's own bookkeeping around its solves: the port's ``host:mpc``
span less its ``host:solve`` spans."""


def read(run):
    ms, calls = run.phases_ms, run.counts.get("mpc")
    if (run.kind != "mpc" or not calls or "host:mpc" not in ms
            or "host:solve" not in ms):
        return None
    return (ms["host:mpc"] - ms["host:solve"]) / calls
