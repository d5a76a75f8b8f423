"""The reference's iLQR pieces, written plainly and apart from the
program: the quadratic cost of a trajectory, the setInterval keypoint
schedule and its linear interpolation, and the Riccati sweep's gains.

Every function takes batch-first tensors (B, ...) and computes in the
dtype it is given; the check runs them in float64, the control in a
lower precision.
"""

from __future__ import annotations

import torch


def trajectory_cost(x, u, x_nom, Q, R, Qf):
    """sum_t (x_t - x_nom)' Q (x_t - x_nom) + u_t' R u_t over t < N - 1,
    plus the terminal (x_{N-1} - x_nom)' Qf (x_{N-1} - x_nom).
    x (B, N, n), u (B, N-1, m), x_nom (B, n), Q (B, n, n), R (B, m, m),
    Qf (B, n, n) -> (B,)."""
    dx = x - x_nom[:, None]
    run = torch.einsum("bti,bij,btj->b", dx[:, :-1], Q, dx[:, :-1])
    run = run + torch.einsum("bti,bij,btj->b", u, R, u)
    return run + torch.einsum("bi,bij,bj->b", dx[:, -1], Qf, dx[:, -1])


def set_interval_steps(N: int, minN: int):
    """The keypoint steps of the setInterval schedule over steps 0..N-2:
    every minN-th step from 0, the last of them moved to N - 2."""
    pts = list(range(0, N - 1, minN))
    pts[-1] = N - 2
    return pts


def interpolate(N: int, keypoints, vals_k):
    """(B, T, ...) per-step values from (B, K, ...) values at the sorted
    ``keypoints`` (with keypoint 0 and N - 2): exact at a keypoint, the
    straight line between the two keypoints around a step elsewhere."""
    out = []
    for t in range(N - 1):
        j = max(i for i, k in enumerate(keypoints) if k <= t)
        if keypoints[j] == t:
            out.append(vals_k[:, j])
            continue
        s, e = keypoints[j], keypoints[j + 1]
        w = (t - s) / (e - s)
        out.append(vals_k[:, j] * (1.0 - w) + vals_k[:, j + 1] * w)
    return torch.stack(out, dim=1)


def tf32(a):
    """float32 ``a`` rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the card's TF32 products read their operands."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a, b):
    """a @ b as TF32 computes it: each operand rounded to TF32, the
    products exact and summed in float32 (with the card's own TF32 off,
    so that the rounding does not hang on which kernel cuBLAS picks)."""
    return torch.matmul(tf32(a), tf32(b))


def riccati_gains(x, u, fx, fu, x_nom, Q, R, Qf, reg, mm=torch.matmul):
    """Feedback gains K (B, N-1, m, n) of the Gauss-Newton Riccati sweep
    around (x, u) with dynamics Jacobians fx (B, N-1, n, n), fu (B, N-1,
    n, m) and a Tikhonov term reg (B,) on Quu, the gain solved through a
    Cholesky factor of Quu; Vxx symmetrized at every step.  ``mm`` takes
    every matrix product (the control's: :func:`tf32_matmul`)."""
    B, N, n = x.shape
    m = u.shape[-1]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    mT = lambda a: a.transpose(-1, -2)
    mv = lambda a, v: mm(a, v[..., None])[..., 0]
    Vx = 2.0 * mv(Qf, x[:, -1] - x_nom)
    Vxx = 2.0 * Qf
    Ks = [None] * (N - 1)
    for t in reversed(range(N - 1)):
        A, Bm = fx[:, t], fu[:, t]
        lx = 2.0 * mv(Q, x[:, t] - x_nom)
        lu = 2.0 * mv(R, u[:, t])
        Qx = lx + mv(mT(A), Vx)
        Qu = lu + mv(mT(Bm), Vx)
        AV, BV = mm(mT(A), Vxx), mm(mT(Bm), Vxx)
        Qxx = 2.0 * Q + mm(AV, A)
        Quu = 2.0 * R + mm(BV, Bm) + reg[:, None, None] * eye
        Qux = mm(BV, A)
        L, info = torch.linalg.cholesky_ex(Quu)
        L = torch.where((info == 0)[:, None, None], L,
                        torch.full_like(L, float("nan")))
        sol = torch.cholesky_solve(torch.cat([Qu[..., None], Qux], -1), L)
        kappa, K = sol[..., 0], sol[..., 1:]
        Vx = Qx - mv(mT(Qux), kappa)
        Vxx = Qxx - mm(mT(Qux), K)
        Vxx = 0.5 * (Vxx + mT(Vxx))
        Ks[t] = K
    return torch.stack(Ks, dim=1)
