"""Parallel-in-time Riccati backward pass by associative scan.

Port of ``drake_ddp_tpu/solver/parscan.py``, over an explicit leading
batch axis B as :func:`~drake_ddp_tpu_torch.solver.ilqr._backward_pass`.

The sequential sweep is N-1 dependent steps of small products.  The
value-function recursion is an associative composition of
linear-fractional (Riccati) maps, so the whole sweep runs in
ceil(log2 N) levels of batched products.  A value function
V(z) = 1/2 z' S z + v' z propagates through one iLQR step (fx, fu, lx,
lu, lxx = 2Q, luu = 2R + reg) as

    S' = lxx + fx' S (I + C S)^{-1} fx
    v' = lx  + fx' (I + S C)^{-1} (v - S b)

with C = fu luu^{-1} fu' and b = fu luu^{-1} lu.  Maps of the 5-tuple
(A = fx, b, C, J = lxx, eta = lx) are closed under composition
(:func:`combine`).  The suffix composition over [t, N] applied to the
zero value gives (S_t, v_t) = (J, eta); the gains then come from
(S_{t+1}, v_{t+1}) in one batched solve over all t.

torch has no associative scan, so :func:`suffix_scan` writes the
reverse scan out: level k combines every element with the one 2^k steps
later (Hillis-Steele), and an element with nothing that far on combines
with the identity element (A = I, b = 0, C = 0, J = 0, eta = 0), which
pads the horizon at every level whatever N is.  The sequence is
ceil(log2 N) levels, each one batched combine over (B, N) elements.

Full float32 on the card: the package turns TF32 off at import, as the
JAX package forces full-precision matmuls here (reduced-precision passes
through the deep composition tree turn to NaN at n ~ 37).
"""

from __future__ import annotations

import torch

from drake_ddp_tpu_torch.utils.linalg import inv_i_plus_psd, solve_spd


def _tr(a):
    return a.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def combine(late, early):
    """The composition of two adjacent spans, ``early`` = [s, t) and
    ``late`` = [t, u), into [s, u); each a 5-tuple (A, b, C, J, eta) of
    (..., n, n) / (..., n) tensors.  The argument order is the JAX
    package's ``_combine(late, early)``, fixed there and here by the
    equivalence test against the sequential pass (float64)."""
    A_l, b_l, C_l, J_l, eta_l = late
    A_e, b_e, C_e, J_e, eta_e = early
    eye = torch.eye(A_l.shape[-1], dtype=A_l.dtype, device=A_l.device)
    M1 = inv_i_plus_psd(eye + C_e @ J_l)
    M2 = inv_i_plus_psd(eye + J_l @ C_e)
    AlM1 = A_l @ M1
    AeT_M2 = _tr(A_e) @ M2
    A = AlM1 @ A_e
    b = _mv(AlM1, b_e + _mv(C_e, eta_l)) + b_l
    C = AlM1 @ C_e @ _tr(A_l) + C_l
    eta = _mv(AeT_M2, eta_l - _mv(J_l, b_e)) + eta_e
    J = AeT_M2 @ J_l @ A_e + J_e
    return A, b, C, J, eta


def identity_element(lead, n, dtype, device):
    """The identity of :func:`combine` with leading shape ``lead``:
    A = I, b = 0, C = 0, J = 0, eta = 0."""
    z = lambda *s: torch.zeros(*lead, *s, dtype=dtype, device=device)
    eye = torch.eye(n, dtype=dtype, device=device).expand(*lead, n, n)
    return eye, z(n), z(n, n), z(n, n), z(n)


def suffix_scan(elems):
    """Reverse inclusive scan along axis 1: ``elems`` (A, b, C, J, eta)
    with leading axes (B, T) -> out with out[:, t] the composition of
    elements t .. T-1 (element t earliest)."""
    A = elems[0]
    B, T, n = A.shape[0], A.shape[1], A.shape[-1]
    cur = tuple(elems)
    d = 1
    while d < T:
        pad = identity_element((B, d), n, A.dtype, A.device)
        late = tuple(torch.cat([c[:, d:], p], dim=1)
                     for c, p in zip(cur, pad))
        cur = combine(late, cur)
        d *= 2
    return cur


def parallel_backward_pass(cfg, prob, x_bar, u_bar, fx, fu, reg):
    """The Riccati sweep in ceil(log2 N) levels, with the sequential
    pass's contract: x_bar (B, N, n), u_bar (B, N-1, m), fx (B, N-1, n,
    n), fu (B, N-1, n, m), reg (B,) -> kappa (B, N-1, m), K (B, N-1, m,
    n), dV (B, N-1), equal to it to rounding."""
    B, N1, n = fx.shape[0], fx.shape[1], fx.shape[-1]
    m = fu.shape[-1]
    dtype, dev = x_bar.dtype, x_bar.device
    x_nom, Q, R, Qf = prob.x_nom, prob.Q, prob.R, prob.Qf

    lx = 2.0 * _mv(Q[:, None], x_bar[:, :-1] - x_nom[:, None])  # (B, N-1, n)
    lu = 2.0 * _mv(R[:, None], u_bar)                         # (B, N-1, m)
    luu = 2.0 * R + reg[:, None, None] * torch.eye(m, dtype=dtype,
                                                   device=dev)
    # luu^{-1} [fu' | lu] for every step in one solve
    sol = solve_spd(luu[:, None], torch.cat([_tr(fu), lu[..., None]],
                                            dim=-1))
    C = fu @ sol[..., :n]                                     # (B, N-1, n, n)
    b = _mv(fu, sol[..., n])                                  # (B, N-1, n)

    # the terminal element: the value at the final state
    dxf = x_bar[:, -1] - x_nom
    zero_nn = torch.zeros(B, 1, n, n, dtype=dtype, device=dev)
    elems = (torch.cat([fx, zero_nn], dim=1),
             torch.cat([b, torch.zeros(B, 1, n, dtype=dtype, device=dev)],
                       dim=1),
             torch.cat([C, zero_nn], dim=1),
             torch.cat([(2.0 * Q)[:, None].expand(B, N1, n, n),
                        (2.0 * Qf)[:, None]], dim=1),
             torch.cat([lx, (2.0 * _mv(Qf, dxf))[:, None]], dim=1))
    suff = suffix_scan(elems)
    S_next, v_next = suff[3][:, 1:], suff[4][:, 1:]           # V at t + 1

    # the gains from V_{t+1}, batched over t
    fuT_S = _tr(fu) @ S_next                                  # (B, N-1, m, n)
    Qu = lu + _mv(_tr(fu), v_next)
    Quu = luu[:, None] + fuT_S @ fu
    Qux = fuT_S @ fx
    sol = solve_spd(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
    kappa, K = sol[..., 0], sol[..., 1:]
    dV = torch.sum(Qu * kappa, dim=-1)
    return kappa, K, dV
