"""Frozen copy of the port's ``contact/forces.py`` (the plain PyTorch version of the step), for the benchmark's reference: later changes to the program do not move it.

Smooth hydroelastic-style contact force law.

Port of ``drake_ddp_tpu/contact/forces.py``: a closed-form, everywhere
smooth force on each candidate contact,

- normal force fn = force_scale * K * phi_s^2 (+ K1 * phi_s on box
  faces), phi_s the softplus-smoothed penetration;
- Hunt-Crossley dissipation factor smooth_relu(1 - d * vn);
- regularized Coulomb friction -mu * fn * vt / sqrt(|vt|^2 + vs^2).

The law is written once, lane-major (every per-contact scalar a ``(NC,
B)`` lane tensor, vectors ``(NC, 3, B)``): the ``_T`` functions here,
which the plain lane step and lane Jacobian of
:mod:`drake_ddp_tpu_torch.multibody` call and ``csrc/lanestep.cuh``
mirrors on the card.  The parameter
record and the static stiction continuation schedule are host floats.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ContactForceParams(NamedTuple):
    """smooth_width: softplus width of the penetration [m] (wider = more
    force-at-a-distance signal for the optimizer, narrower = crisper
    contact); stiction_vel: friction regularization [m/s]; force_scale:
    O(1) patch-shape constant, fn = force_scale * K * phi^2."""

    smooth_width: float = 3e-3
    stiction_vel: float = 1e-3
    force_scale: float = 2.0


def softplus(z):
    """Stable softplus, log(1 + exp(z)) = max(z, 0) + log1p(exp(-|z|))
    (the form of jax.nn.softplus; the CUDA step uses the same)."""
    return torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z)))


def smooth_penetration(phi, width: float):
    """softplus(phi / width) * width: ~phi when deep, smooth near 0."""
    return softplus(phi / width) * width


def smooth_relu(x, eps: float = 1e-3):
    """0.5 (x + sqrt(x^2 + eps^2)): a smooth max(x, 0)."""
    return 0.5 * (x + torch.sqrt(x * x + eps * eps))


def stiction_schedule(stiction_vel: float, contact_iters: int,
                      anneal: float = 4.0, vs_max: float = 5e-2):
    """Per-iteration friction-regularization widths of the implicit
    contact Newton solve: a continuation from a softened friction curve
    down to the true ``stiction_vel`` —
    [min(vs_max, vs * anneal^(n-1)), ..., vs * anneal, vs].

    The schedule is static, so the step map stays a fixed composition of
    smooth functions with no state-dependent gates; the last iteration
    solves the true model, so the root (and the implicit-function
    derivatives taken there) is unchanged."""
    vs = float(stiction_vel)
    return [min(max(vs, vs_max), vs * anneal ** (contact_iters - 1 - it))
            for it in range(contact_iters)]


# ---------------------------------------------------------------------------
# lane-major force law: phi (NC, B), normal and v_rel (NC, 3, B), K, d, mu
# (NC,) constants, K1 None or (NC, B)
# ---------------------------------------------------------------------------


def _contact_forces_T(phi, normal, v_rel, K, d, mu, params, K1=None):
    """Explicit contact force (contact_iters == 0 step): force on body A
    (NC, 3, B) at the current penetration."""
    phi_s = smooth_penetration(phi, params.smooth_width)
    vn = torch.sum(v_rel * normal, 1)                    # (NC, B)
    fn = params.force_scale * K[:, None] * phi_s * phi_s
    if K1 is not None:
        fn = fn + K1 * phi_s
    fn = fn * smooth_relu(1.0 - d[:, None] * vn)
    vt = v_rel - vn[:, None] * normal
    vt_norm = torch.sqrt(torch.sum(vt * vt, 1) + params.stiction_vel ** 2)
    ft = -(mu[:, None] * fn / vt_norm)[:, None] * vt
    return fn[:, None] * normal + ft


def _contact_force_pred_T(phi, normal, v_rel, K, d, mu, dt, params,
                          K1=None):
    """Force-only twin of :func:`_contact_forces_implicit_T` (no D)."""
    vs = params.stiction_vel
    vn = torch.sum(v_rel * normal, 1)                    # (NC, B)
    phi_s = smooth_penetration(phi - dt * vn, params.smooth_width)
    fn0 = params.force_scale * K[:, None] * phi_s * phi_s
    if K1 is not None:
        fn0 = fn0 + K1 * phi_s
    fn = fn0 * smooth_relu(1.0 - d[:, None] * vn)
    vt = v_rel - vn[:, None] * normal
    sigma = torch.sqrt(torch.sum(vt * vt, 1) + vs * vs)
    mu_over = mu[:, None] * fn / sigma
    return fn[:, None] * normal - mu_over[:, None] * vt


def _contact_forces_implicit_T(phi, normal, v_rel, K, d, mu, dt, params,
                               K1=None):
    """Force at the implicitly predicted penetration phi - dt * vn, and
    its exact Jacobian D = df/dv_rel: f (NC,3,B), D (NC,3,3,B)."""
    w = params.smooth_width
    vs = params.stiction_vel
    s = params.force_scale
    Kc, dc, muc = K[:, None], d[:, None], mu[:, None]
    vn = torch.sum(v_rel * normal, 1)                    # (NC, B)
    z = (phi - dt * vn) / w
    phi_s = softplus(z) * w
    sig = torch.sigmoid(z)
    fn0 = s * Kc * phi_s * phi_s
    dfn0 = 2.0 * s * Kc * phi_s
    if K1 is not None:
        fn0 = fn0 + K1 * phi_s
        dfn0 = dfn0 + K1
    eps = 1e-3
    xx = 1.0 - dc * vn
    rt = torch.sqrt(xx * xx + eps * eps)
    hc = 0.5 * (xx + rt)                                 # smooth_relu(xx)
    dhc = 0.5 * (1.0 + xx / rt)
    fn = fn0 * hc
    vt = v_rel - vn[:, None] * normal
    sigma = torch.sqrt(torch.sum(vt * vt, 1) + vs * vs)
    mu_over = muc * fn / sigma
    f = fn[:, None] * normal - mu_over[:, None] * vt

    b = -(dfn0 * sig * dt * hc + fn0 * dhc * dc)         # (NC, B)
    vt_unit = vt / sigma[:, None]
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    P = eye[None, :, :, None] - normal[:, :, None] * normal[:, None]
    D = ((normal - muc[:, None] * vt_unit)[:, :, None]
         * (b[:, None] * normal)[:, None]
         - mu_over[:, None, None] * P
         + (mu_over / (sigma * sigma))[:, None, None]
         * (vt[:, :, None] * vt[:, None]))
    return f, D
