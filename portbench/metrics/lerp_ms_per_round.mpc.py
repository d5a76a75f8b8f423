"""lerp_ms_per_round.mpc (keypoints): device ms per round of the
derivative phase outside its Jacobian calls (the keypoint interpolation)."""

from portbench.layers import ms_per_round


def read(run):
    d, j = ms_per_round(run, "derivs"), ms_per_round(run, "jac")
    if run.kind != "mpc" or d is None or j is None:
        return None
    return d - j
