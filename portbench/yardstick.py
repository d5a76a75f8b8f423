"""The benchmark's frozen yardstick: the card's peaks, the operations and
bytes of the work one iLQR round asks for, and the chain-health
arithmetic.

Every count is computed from the sizes written in a configuration's file
(``sizes``: bodies, dofs, each body's ancestor dofs, each contact row's
kind and nonzero Jacobian columns, the Newton iterations), never from the
program's own tables, so a count reads the same work whatever implements
it.  The counts are keyed by the work: one lane step, one lane's step
Jacobian (root-seeded or cold), one lane's Riccati step.  They are what
the algorithm needs at these sizes (each body's ancestor dofs only, the
symmetric half of the mass matrix, the unpivoted solves the step runs on
the columns not yet eliminated), not what a kernel happens to execute.
"""

from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, at the 700 W power limit: float32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# narrowphase operations of one contact row by kind: sphere-halfspace 15
# (distance, penetration, point); sphere-box 90 (box frame, clamp, gaps,
# normal, point); sphere-sphere and sphere-world 24 (distance, normal,
# penetration, point); a box-face corner 24 (corner, penetration) and its
# pair's projected area (25, and for a body sphere the direction to it,
# 13) once per 8 corners, with 12 more for the corner's distance and
# normal against a sphere
ROW_OPS = {0: 15, 1: 90, 2: 24 + 25 / 8, 3: 24, 4: 24, 5: 36 + 38 / 8}
PJC = 15          # one point-Jacobian column: lever, cross product, blend


def step_parts(sizes: Dict) -> Dict[str, float]:
    """Operations that one lane needs for each part of the contact step.

    ``sizes``: nb, nq, nv, nu, ``ancestors`` (each body's ancestor dof
    count), ns and nbox (body spheres and boxes), contact_iters,
    has_contact, and ``contacts``: per contact row [kind, ancestor dofs
    of body a, of body b, shared by both]."""
    nb, nv, nu = sizes["nb"], sizes["nv"], sizes["nu"]
    na = sizes["ancestors"]
    c = dict(fk=nb * (63 + 45))
    # mass matrix: com and world inertia per body, each ancestor column
    # once (angular 3, linear PJC, I a 15), the symmetric half of the
    # column products (13 each)
    c["mass"] = sum(108 + a * (3 + PJC + 15) + a * (a + 1) // 2 * 13
                    for a in na)
    c["bias"] = (sum(a * 6 + a * 3 + 90 + a * (PJC + 12) for a in na)
                 + nv * 13 + nb * 40 + nu)
    # Crout Cholesky (the dot products of the lower triangle), its square
    # roots and divisions, then two triangular solves
    c["chol"] = (sum(2 * j * (nv - j) for j in range(nv))
                 + nv * (nv + 3) // 2 + 2 * nv * nv + 2 * nv)
    # the Gauss-Jordan inverse of G: each row's factor and the pivot row's
    # remaining left columns and right half, then the diagonal
    c["inv"] = ((nv - 1) * sum(1 + 2 * (nv - k - 1) + 2 * nv
                               for k in range(nv)) + nv * nv)
    c["integ"] = 40
    c["res"] = nv + 2 * nv * nv + 4 * nv                  # M (vp - v) - dt ..
    c["geom"] = c["tau"] = c["with_g"] = c["newton"] = 0
    if sizes["has_contact"]:
        c["geom"] = sizes["ns"] * 18 + sizes["nbox"] * 63
        for kind, ca, cb, shared in sizes["contacts"]:
            cols = ca + cb - shared                       # nonzero Jc columns
            c["geom"] += ROW_OPS[kind] + (ca + cb) * PJC + shared * 3
            c["tau"] += 6 * cols + 60 + 6 * cols          # Jc v, f, Jc' f
            c["with_g"] += 40 + 15 * cols + 6 * cols * cols   # D, D Jc, Jc' E
        gj = (nv - 1) * sum(1 + 2 * (nv - k) for k in range(nv)) + nv
        c["newton"] = sizes["contact_iters"] * (
            2 * c["tau"] + c["with_g"] + 2 * c["res"] + 2 * nv * nv + gj
            + 3 * nv)
    return c


def step_ops(sizes: Dict) -> float:
    """Operations of one lane step."""
    c = step_parts(sizes)
    return (c["fk"] + c["mass"] + c["bias"] + c["chol"] + c["geom"]
            + c["newton"] + c["integ"])


def jac_ops(sizes: Dict, root: bool) -> float:
    """Operations of one lane's step Jacobian: the primal once (cold: with
    the step's predictor and Newton), G at the root and its inverse; a
    forward-mode tangent at 2 operations per primal operation for each of
    the nq q-directions through kinematics, mass matrix, bias,
    narrowphase and the residual, and each of the nv v-directions through
    the bias and the residual; dv' = -G^-1 dres for the n x-directions;
    and the integrator's tangent for all n + m directions."""
    c = step_parts(sizes)
    nq, nv, nu = sizes["nq"], sizes["nv"], sizes["nu"]
    n = nq + nv
    kin = c["fk"] + c["mass"] + c["bias"]
    at_root = c["tau"] + c["with_g"] + c["res"] if c["geom"] else 0
    primal = (kin + c["geom"] + at_root + c["inv"]
              + (0 if root else c["chol"] + c["newton"]))
    q_dirs = nq * 2 * (kin + c["geom"] + c["tau"] + c["res"])
    v_dirs = nv * 2 * (c["bias"] + c["res"])
    return (primal + q_dirs + v_dirs + 2 * n * nv * nv + nu * nv
            + (n + nu) * 2 * c["integ"])


def rollout_lane_step_ops(sizes: Dict) -> float:
    """One closed-loop rollout lane-step: the policy u = u_bar + eps kappa
    + K (x - x_bar) and the contact step."""
    n, m = sizes["nq"] + sizes["nv"], sizes["nu"]
    return step_ops(sizes) + 2 * m * n + n + 3 * m


def rollout_call_bytes(sizes: Dict, lanes: int, steps: int) -> float:
    """Bytes one rollout call over ``lanes`` lanes and ``steps`` steps
    must move in float32: x0 and eps in; the tapes u_bar, kappa, K and
    x_bar read once; the states and inputs written once."""
    n, m = sizes["nq"] + sizes["nv"], sizes["nu"]
    return (n + 1 + steps * (3 * m + m * n + 2 * n)) * lanes * 4


def jac_call_bytes(sizes: Dict, lanes: int, root: bool) -> float:
    """Bytes one Jacobian call must move in float32: x, u (and x_next when
    root-seeded) in, fx and fu out."""
    n, m = sizes["nq"] + sizes["nv"], sizes["nu"]
    return ((n + m + (n if root else 0)) + n * (n + m)) * lanes * 4


def riccati_step_ops(n: int, m: int) -> float:
    """Operations of one lane's Riccati step: lx, lu; fx' Vxx and fu'
    Vxx; Qx, Qu; Qxx, Quu, Qux; the Cholesky solve of Quu for the m + 1
    right-hand sides; dV; Vx, Vxx and its symmetrization."""
    return (2 * n * n + 2 * m * m                      # lx, lu
            + 2 * n * n * n + 2 * m * n * n            # fx' Vxx, fu' Vxx
            + 2 * n * n + 2 * m * n                    # Qx, Qu
            + 2 * n * n * n + 2 * m * m * n + 2 * m * n * n   # Qxx Quu Qux
            + m * m * m / 3 + 2 * m * m * (m + n + 1)  # Cholesky, solves
            + 2 * m                                    # dV
            + 2 * m * n + 2 * m * n * n + 2 * n * n)   # Vx, Vxx, sym


def bound_s(ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the bandwidth."""
    return max(ops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_PER_S)


def keypoint_count(N: int, minN: int) -> int:
    """Exact Jacobians per trajectory of the setInterval schedule:
    ``arange(0, N - 1, minN)`` with its last element moved to N - 2."""
    return len(range(0, N - 1, minN))


# ---------------------------------------------------------------------------
# chain health (the arithmetic of tests/test_divergence_guard.py's
# long-chain bounds, copied)
# ---------------------------------------------------------------------------

DEAD_LIMIT = 0.02
TAIL_EXCESS_LIMIT = 0.005


def chain_health(div: Sequence[float], dead: Sequence[float]) -> Dict:
    """The reference's chain-health criterion over one chain, from the
    diverged and latched-dead fractions of each resolve: dead at the end
    at most 2%; over the last quarter the mean diverged fraction exceeds
    the mean dead fraction by under 0.5% absolute (a flat tail); and the
    last quarter's mean diverged fraction is under 0.5% above that of the
    quarter that starts the second half (no upward trend)."""
    mean = lambda a: sum(a) / len(a)
    q = max(1, len(div) // 4)
    half = len(div) // 2
    late_excess = mean(div[-q:]) - mean(dead[-q:])
    trend = mean(div[-q:]) - mean(div[half:half + q])
    return {"resolves": len(div), "dead_final": dead[-1],
            "late_excess": late_excess, "trend": trend,
            "healthy": (dead[-1] <= DEAD_LIMIT
                        and late_excess < TAIL_EXCESS_LIMIT
                        and trend < TAIL_EXCESS_LIMIT)}
