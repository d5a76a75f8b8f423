"""active_lane_share.mpc (batched iLQR): the share of the batch's lane
slots, over the window's rounds, whose lane was still iterating (the
port's ``lanes_active`` and ``lane_slots`` counters), in %."""


def read(run):
    slots = run.counts.get("lane_slots")
    if run.kind != "mpc" or not slots or "lanes_active" not in run.counts:
        return None
    return 100.0 * run.counts["lanes_active"] / slots
