"""ls_active_lane_share.solve (rollout kernel): the share of the lanes
the linesearch rolls out, over the window's chunks, whose result the
round keeps: active in the round and still searching (the port's
``ls_lanes_kept`` and ``ls_lane_slots`` counters), in %."""


def read(run):
    slots = run.counts.get("ls_lane_slots")
    if (run.kind != "solve" or not slots
            or "ls_lanes_kept" not in run.counts):
        return None
    return 100.0 * run.counts["ls_lanes_kept"] / slots
