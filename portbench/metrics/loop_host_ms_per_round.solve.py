"""loop_host_ms_per_round.solve (batched iLQR): host ms per iLQR round
of the batched loop's own bookkeeping between its phases: the port's
``host:solve`` span less its linesearch, derivative, Riccati and
round-wait spans."""

from portbench.layers import rounds

PARTS = ("host:linesearch", "host:derivs", "host:riccati", "host:wait.round")


def read(run):
    ms = run.phases_ms
    if (run.kind != "solve" or not rounds(run)
            or not all(k in ms for k in ("host:solve",) + PARTS)):
        return None
    return (ms["host:solve"] - sum(ms[k] for k in PARTS)) / rounds(run)
