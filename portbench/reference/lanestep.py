"""Frozen copy of the port's ``multibody/lanestep.py`` (the plain PyTorch version of the step), for the benchmark's reference: later changes to the program do not move it.

Lane-major (batch-last) multibody contact step, plain PyTorch.

Port of ``drake_ddp_tpu/multibody/lanestep.py``: every scalar of the
per-scenario step is a ``(B,)`` lane vector, vectors are ``(3, B)``,
matrices ``(n, n, B)``.  This is the plain version of the device step
that the CUDA kernels run (``csrc/lanestep.cuh``, wrapped by
:mod:`drake_ddp_tpu_torch.ops.megastep` and
:mod:`drake_ddp_tpu_torch.ops.megaroll`): the wrappers run it for CPU
tensors, the tests pin it to the JAX step, and ``chip_smoke.py`` holds
the kernels against it on the card.

The step (forward kinematics, mass matrix, bias forces, narrowphase,
contact Jacobians, a stiction-continuation damped Newton solve of the
implicit contact velocity, position integration) follows the JAX code
line for line, including its unpivoted Cholesky and Gauss-Jordan solves
(a pivoting library solve lands on other f32 roots through the stiff
contact).  Model constants live in a per-dtype :class:`LaneConsts`
bundle built once per step function, so no host-to-device copy happens
inside a step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from portbench.reference.forces import (  # noqa: F401
    ContactForceParams,
    _contact_force_pred_T,
    _contact_forces_implicit_T,
    _contact_forces_T,
    softplus,
    stiction_schedule,
)
from portbench.reference.geometry import ContactModel
from portbench.reference.model import (
    FIXED,
    FREE,
    PRISMATIC,
    REVOLUTE,
    MultibodyModel,
    _NV,
    ancestor_dof_mask,
)

_CORNER_SIGNS = np.array([(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1)
                          for sz in (-1, 1)], np.float64)


class LaneConsts:
    """Model and contact constants of one step function, as tensors of
    one dtype on the model's device (the JAX code's trace-time numpy
    constants).  Derived constants are computed in float64 from the
    float32 tables and then cast, as the JAX code does in numpy."""

    def __init__(self, model: MultibodyModel,
                 contact: Optional[ContactModel], dtype):
        dev = model.device
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=dev)
        c = lambda a: a.to(dtype)
        self.dtype = dtype
        self.X_rot = c(model.X_PJ_rot)
        self.X_pos = c(model.X_PJ_pos)
        self.axis = c(model.axis)
        self.mass = c(model.mass)
        self.com = c(model.com)
        self.inertia = c(model.inertia)
        self.damping = c(model.damping)
        self.gravity = c(model.gravity)
        self.armature_diag = torch.diag(c(model.armature))
        self.mass3 = torch.repeat_interleave(self.mass, 3)
        self.eye3 = torch.eye(3, dtype=dtype, device=dev)
        self.B_act = t(model.actuation_matrix())            # (nv, nu)
        self.anc = t(ancestor_dof_mask(model))               # (nb, nv)
        is_ang = np.zeros(model.nv)
        is_lin = np.zeros(model.nv)
        for b, jt in enumerate(model.joint_type):
            vs = model.v_start[b]
            if jt == FREE:
                is_ang[vs:vs + 3] = 1.0
                is_lin[vs + 3:vs + 6] = 1.0
            elif jt == REVOLUTE:
                is_ang[vs] = 1.0
            elif jt == PRISMATIC:
                is_lin[vs] = 1.0
        self.is_ang = t(is_ang)
        self.is_lin = t(is_lin)
        # Rodrigues cross-product matrices of each joint axis (f64 -> dtype)
        ax = model.axis.double()
        z = torch.zeros_like(ax[:, 0])
        K = torch.stack([
            torch.stack([z, -ax[:, 2], ax[:, 1]], -1),
            torch.stack([ax[:, 2], z, -ax[:, 0]], -1),
            torch.stack([-ax[:, 1], ax[:, 0], z], -1)], 1)  # (nb, 3, 3)
        self.rot_K = K.to(dtype)
        self.rot_K2 = (K @ K).to(dtype)
        self.has_contact = contact is not None and contact.num_contacts > 0
        if self.has_contact:
            self._contact_consts(model, contact, c, t)

    def _contact_consts(self, model, cm, c, t):
        narrowphase_consts(self, cm, self.dtype, model.device)
        li = lambda seq: torch.as_tensor(list(seq), dtype=torch.long,
                                         device=model.device)
        # per-contact ancestor-dof masks of the two bodies (zero rows for
        # the world) for the contact Jacobians
        anc = self.anc
        side = lambda bodies: (anc[li(max(b, 0) for b in bodies)]
                               * t([float(b >= 0) for b in bodies])[:, None])
        self.anc_a = side(self.body_a)
        self.anc_b = (side(self.body_b) if any(b >= 0 for b in self.body_b)
                      else None)


def narrowphase_consts(C, cm: ContactModel, dtype, device):
    """Set on ``C`` the contact tables that :func:`_narrowphase_T` reads,
    as tensors of ``dtype`` on ``device``, and the static body index
    tuples of the rows.  Returns ``C``."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    c = lambda a: a.to(dtype)
    li = lambda seq: torch.as_tensor(list(seq), dtype=torch.long,
                                     device=device)
    C.sph_offset = c(cm.sph_offset)
    C.sph_radius = c(cm.sph_radius)
    C.sph_body = li(cm.sph_body)
    C.hs_normal = c(cm.hs_normal)
    C.hs_offset = c(cm.hs_offset)
    C.box_rot = c(cm.box_rot)
    C.box_pos = c(cm.box_pos)
    C.box_half = c(cm.box_half)
    C.ws_pos = c(cm.ws_pos)
    C.ws_radius = c(cm.ws_radius)
    C.corner_signs = t(_CORNER_SIGNS)                    # (8, 3)
    C.sh_s, C.sh_h = li(cm.pair_sh_s), li(cm.pair_sh_h)
    C.ss_a, C.ss_b = li(cm.pair_ss_a), li(cm.pair_ss_b)
    C.sw_s, C.sw_w = li(cm.pair_sw_s), li(cm.pair_sw_w)
    # a sphere pair's contact distance ra + rb, summed in the tables'
    # float32 and then cast, as the JAX package sums it: in float64 an
    # exact sum moves phi by ~1e-9, which flips the Newton's half-step
    # test on some Panda states and lands on another root
    at = lambda tab, seq: tab[torch.as_tensor(list(seq), dtype=torch.long,
                                              device=tab.device)]
    C.ss_rsum = c(at(cm.sph_radius, cm.pair_ss_a)
                  + at(cm.sph_radius, cm.pair_ss_b))
    C.sw_rsum = c(at(cm.sph_radius, cm.pair_sw_s)
                  + at(cm.ws_radius, cm.pair_sw_w))
    C.body_a, C.body_b = _contact_bodies(cm)
    Ks, ds, mus = [], [], []
    if cm.pair_sh_s:
        Ks.append(cm.sh_K); ds.append(cm.sh_d); mus.append(cm.sh_mu)
    if cm.pair_sb_s:
        Ks.append(cm.sb_K); ds.append(cm.sb_d); mus.append(cm.sb_mu)
    if cm.pair_ss_a:
        Ks.append(cm.ss_K); ds.append(cm.ss_d); mus.append(cm.ss_mu)
    if cm.pair_sw_s:
        Ks.append(cm.sw_K); ds.append(cm.sw_d); mus.append(cm.sw_mu)
    for n_pairs, g_d, g_mu in ((len(cm.pair_bh_b), cm.bh_d, cm.bh_mu),
                               (len(cm.pair_bs_b), cm.bs_d, cm.bs_mu)):
        if n_pairs:
            Ks.append(torch.zeros(8 * n_pairs, dtype=torch.float32,
                                  device=device))
            ds.append(torch.repeat_interleave(g_d, 8))
            mus.append(torch.repeat_interleave(g_mu, 8))
    C.K = c(torch.cat(Ks))
    C.d = c(torch.cat(ds))
    C.mu = c(torch.cat(mus))
    C.bh_g = c(cm.bh_g)
    C.bs_g = None if cm.bs_g is None else c(cm.bs_g)
    return C


def _contact_bodies(cm: ContactModel):
    """Static (body_a, body_b) of every contact row, in narrowphase row
    order: sh, sb, ss, sw pairs, then 8 rows per bh and bs pair."""
    sph, box = cm.sph_body, cm.box_body
    body_a = ([sph[i] for i in cm.pair_sh_s] + [sph[i] for i in cm.pair_sb_s]
              + [sph[i] for i in cm.pair_ss_a] + [sph[i] for i in cm.pair_sw_s]
              + [box[i] for i in cm.pair_bh_b for _ in range(8)]
              + [box[i] for i in cm.pair_bs_b for _ in range(8)])
    body_b = ([-1] * len(cm.pair_sh_s) + [box[i] for i in cm.pair_sb_b]
              + [sph[i] for i in cm.pair_ss_b] + [-1] * len(cm.pair_sw_s)
              + [-1] * (8 * len(cm.pair_bh_b))
              + [sph[i] for i in cm.pair_bs_s for _ in range(8)])
    return tuple(body_a), tuple(body_b)


def _consts_cache(model, contact):
    """Per-dtype LaneConsts, built on first use."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = LaneConsts(model, contact, dtype)
        return cache[dtype]

    return get


# ---------------------------------------------------------------------------
# lane-major helpers.  Trailing dim is the batch B; every contraction is
# an unrolled sum of elementwise products, as in the JAX code.
# ---------------------------------------------------------------------------


def _cross_T(a, b):
    """Cross product of (3, B) lane vectors."""
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _cross_mid_T(a, b):
    """Cross product along axis 1 of (K, 3, B) stacks."""
    return torch.stack([
        a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
    ], dim=1)


def quat_to_rot_T(q):
    """(4, B) wxyz quaternion -> (3, 3, B) rotation."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)]),
        torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)]),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz]),
    ])


def quat_mul_T(a, b):
    """(4, B) x (4, B) quaternion product."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _mm_T(A, B):
    """(3,3,B) @ (3,3,B)."""
    return sum(A[:, j][:, None] * B[j][None] for j in range(3))


def _mc_T(A, C):
    """(3,3,B) @ constant (3,3)."""
    return sum(A[:, j][:, None] * C[j][None, :, None] for j in range(3))


def _mv_T(A, v):
    """(3,3,B) @ (3,B)."""
    return sum(A[:, j] * v[j][None] for j in range(3))


def _outer_sum(a, b, chunk=8):
    """sum_k outer(a[k], b[k]): a (K, n, B), b (K, m, B) -> (n, m, B)."""
    out = None
    for k0 in range(0, a.shape[0], chunk):
        aa, bb = a[k0:k0 + chunk], b[k0:k0 + chunk]
        t = torch.sum(aa[:, :, None] * bb[:, None], dim=0)
        out = t if out is None else out + t
    return out


def solve_spd_T(A, b):
    """Unpivoted Cholesky solve, lane-major: A (n, n, B) SPD, b (n, B).
    The factor is a list of column lane vectors, as in the JAX code."""
    n = A.shape[0]
    idx = torch.arange(n, device=A.device)
    cols = []  # cols[j] (n, B): column j of L (zero above the diagonal)
    for j in range(n):
        if j:
            s = A[:, j] - sum(cols[k] * cols[k][j][None] for k in range(j))
        else:
            s = A[:, j]
        d = torch.sqrt(s[j])
        cols.append(torch.where((idx >= j)[:, None], s / d,
                                torch.zeros_like(s)))
    ys = []
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - cols[k][i] * ys[k]     # L[i, k]
        ys.append(s / cols[i][i])          # / L[i, i]
    xs = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for k in range(i + 1, n):
            s = s - cols[i][k] * xs[k]     # L[k, i]
        xs[i] = s / cols[i][i]
    return torch.stack(xs)


def solve_small_T(A, b):
    """Unpivoted Gauss-Jordan solve, lane-major: A (n, n, B), b (n, B),
    for the diagonally dominant contact Newton matrix."""
    n = A.shape[0]
    Ab = torch.cat([A, b[:, None]], dim=1)              # (n, n+1, B)
    not_k = 1.0 - torch.eye(n, dtype=A.dtype, device=A.device)
    for k in range(n):
        pivot_row = Ab[k]                               # (n+1, B)
        factor = Ab[:, k] / Ab[k][k]                    # (n, B)
        factor = factor * not_k[k][:, None]             # zero at the pivot
        Ab = Ab - factor[:, None, :] * pivot_row[None]
    diag = torch.stack([Ab[i][i] for i in range(n)])    # (n, B)
    return Ab[:, n] / diag


# ---------------------------------------------------------------------------
# kinematics / dynamics terms
# ---------------------------------------------------------------------------


def _fk_T(model: MultibodyModel, C: LaneConsts, q):
    """q (nq, B) -> per-body R (nb,3,3,B), p (nb,3,B) and per-dof data."""
    nb, nv = model.nb, model.nv
    B = q.shape[-1]
    Rs, ps = [], []
    dof_axis = [None] * nv
    dof_origin = [None] * nv
    eye_T = C.eye3[:, :, None].expand(3, 3, B)
    zero3 = q.new_zeros((3, B))
    for b in range(nb):
        par = model.parent[b]
        Rp = eye_T if par < 0 else Rs[par]
        pp = zero3 if par < 0 else ps[par]
        jt = model.joint_type[b]
        qs, vs = model.q_start[b], model.v_start[b]
        R_J = _mc_T(Rp, C.X_rot[b])
        p_J = pp + _mv_T(Rp, C.X_pos[b][:, None].expand(3, B))
        if jt == FREE:
            R_b = _mm_T(R_J, quat_to_rot_T(q[qs:qs + 4]))
            p_b = p_J + _mv_T(Rp, q[qs + 4:qs + 7])
            for k in range(3):
                ek = C.eye3[k][:, None].expand(3, B)
                dof_axis[vs + k] = ek
                dof_origin[vs + k] = p_b
                dof_axis[vs + 3 + k] = ek
                dof_origin[vs + 3 + k] = p_b
        elif jt == REVOLUTE:
            s, c = torch.sin(q[qs]), torch.cos(q[qs])
            rot = (C.eye3[:, :, None] + s[None, None] * C.rot_K[b][:, :, None]
                   + (1.0 - c)[None, None] * C.rot_K2[b][:, :, None])
            R_b = _mm_T(R_J, rot)
            p_b = p_J
            dof_axis[vs] = _mv_T(R_b, C.axis[b][:, None].expand(3, B))
            dof_origin[vs] = p_b
        elif jt == PRISMATIC:
            R_b = R_J
            ax_w = _mv_T(R_J, C.axis[b][:, None].expand(3, B))
            p_b = p_J + ax_w * q[qs][None, :]
            dof_axis[vs] = ax_w
            dof_origin[vs] = p_b
        else:  # FIXED
            R_b = R_J
            p_b = p_J
        Rs.append(R_b)
        ps.append(p_b)

    R = torch.stack(Rs)                                  # (nb, 3, 3, B)
    p = torch.stack(ps)                                  # (nb, 3, B)
    dof_axis_w = (torch.stack(dof_axis) if nv
                  else q.new_zeros((0, 3, B)))           # (nv, 3, B)
    dof_origin_w = (torch.stack(dof_origin) if nv
                    else q.new_zeros((0, 3, B)))
    return R, p, dof_axis_w, dof_origin_w, C.is_ang, C.is_lin


def _body_jacobians_T(kinT, anc, points):
    """J_ang, J_lin at per-body points: (nb, 3, nv, B)."""
    R, p, dof_axis_w, dof_origin_w, is_ang, is_lin = kinT
    ang = is_ang[:, None, None] * dof_axis_w             # (nv, 3, B)
    lever = points[:, None] - dof_origin_w[None]         # (nb, nv, 3, B)
    ax = dof_axis_w[None]                                # (1, nv, 3, B)
    crs = torch.stack([
        ax[:, :, 1] * lever[:, :, 2] - ax[:, :, 2] * lever[:, :, 1],
        ax[:, :, 2] * lever[:, :, 0] - ax[:, :, 0] * lever[:, :, 2],
        ax[:, :, 0] * lever[:, :, 1] - ax[:, :, 1] * lever[:, :, 0],
    ], dim=2)                                            # (nb, nv, 3, B)
    lin = (is_ang[None, :, None, None] * crs
           + is_lin[None, :, None, None] * dof_axis_w[None])
    J_ang = (ang[None] * anc[:, :, None, None]).transpose(1, 2)
    J_lin = (lin * anc[:, :, None, None]).transpose(1, 2)
    return J_ang, J_lin


def _kin_mass_T(model: MultibodyModel, C: LaneConsts, q):
    """q-only terms: kinematics, world inertias, mass matrix (split out
    so the derivative path can push v-tangents through _bias_T alone)."""
    kinT = _fk_T(model, C, q)
    R, p = kinT[0], kinT[1]
    B = q.shape[-1]
    com_w = p + sum(R[:, :, j] * C.com[:, j][:, None, None]
                    for j in range(3))
    J_ang, J_com = _body_jacobians_T(kinT, C.anc, com_w)
    # I_w = R I R': two unrolled 3x3 stages
    RI = sum(R[:, :, j][:, :, None] * C.inertia[:, j][:, None, :, None]
             for j in range(3))                          # (nb, 3, 3, B)
    I_w = sum(RI[:, :, k][:, :, None] * R[:, :, k][:, None]
              for k in range(3))
    # M = sum_b J_ang' I_w J_ang + m J_com' J_com + diag(armature)
    W = sum(I_w[:, :, j][:, :, None] * J_ang[:, j][:, None]
            for j in range(3))
    nbv = model.nb * 3
    Ja_f = J_ang.reshape(nbv, model.nv, B)
    W_f = W.reshape(nbv, model.nv, B)
    Jc_f = J_com.reshape(nbv, model.nv, B)
    M = (_outer_sum(Ja_f, W_f)
         + _outer_sum(Jc_f, C.mass3[:, None, None] * Jc_f)
         + C.armature_diag[:, :, None])
    return kinT, M, (J_ang, J_com, I_w, com_w), C.anc


def _bias_T(model: MultibodyModel, C: LaneConsts, kinT, J_ang, J_com, I_w,
            com_w, v):
    """v-dependent bias forces given precomputed q-only terms."""
    nb = model.nb
    R, p, dof_axis_w, dof_origin_w, is_ang, is_lin = kinT
    B = v.shape[-1]
    zero3 = v.new_zeros((3, B))

    w = torch.sum(J_ang * v[None, None], dim=2)          # (nb, 3, B)

    # velocity-product accelerations with qddot = 0 (world frame)
    wp_dof = []
    for b in range(nb):
        par = model.parent[b]
        wp = zero3 if par < 0 else w[par]
        wp_dof += [wp] * _NV[model.joint_type[b]]
    wp_dof = (torch.stack(wp_dof) if model.nv
              else v.new_zeros((0, 3, B)))               # (nv, 3, B)
    crs = _cross_mid_T(wp_dof, dof_axis_w)               # (nv, 3, B)
    alpha_term = v[:, None, :] * is_ang[:, None, None] * crs
    alpha = torch.sum(C.anc[:, :, None, None] * alpha_term[None], dim=1)

    a_o = [None] * nb
    for b in range(nb):
        par = model.parent[b]
        if par < 0:
            a_o[b] = zero3
        else:
            r = p[b] - p[par]
            a = (a_o[par] + _cross_T(alpha[par], r)
                 + _cross_T(w[par], _cross_T(w[par], r)))
            if model.joint_type[b] == PRISMATIC:
                vs = model.v_start[b]
                a = a + 2.0 * _cross_T(w[par], dof_axis_w[vs] * v[vs][None])
            a_o[b] = a
    a_o = torch.stack(a_o)                               # (nb, 3, B)

    c_w = com_w - p
    a_com = (a_o + _cross_mid_T(alpha, c_w)
             + _cross_mid_T(w, _cross_mid_T(w, c_w)))
    F = C.mass[:, None, None] * (a_com - C.gravity[None, :, None])
    Iw_w = sum(I_w[:, :, j] * w[:, j][:, None] for j in range(3))
    T = (sum(I_w[:, :, j] * alpha[:, j][:, None] for j in range(3))
         + _cross_mid_T(w, Iw_w))
    bias = (torch.sum(J_ang * T[:, :, None], dim=(0, 1))
            + torch.sum(J_com * F[:, :, None], dim=(0, 1)))
    return bias + C.damping[:, None] * v


def _dynamics_terms_T(model, C, q, v):
    kinT, M, (J_ang, J_com, I_w, com_w), anc = _kin_mass_T(model, C, q)
    bias = _bias_T(model, C, kinT, J_ang, J_com, I_w, com_w, v)
    return kinT, M, bias, anc


def _integrate_positions_T(model: MultibodyModel, q, v_next, dt):
    parts = []
    for b in range(model.nb):
        jt = model.joint_type[b]
        qs, vs = model.q_start[b], model.v_start[b]
        if jt == FREE:
            quat = q[qs:qs + 4]                          # (4, B)
            w_w = v_next[vs:vs + 3]
            wq = torch.cat([torch.zeros_like(w_w[:1]), w_w])
            q_new = quat + dt * (0.5 * quat_mul_T(wq, quat))
            q_new = q_new / torch.sqrt(torch.sum(q_new * q_new, 0))[None]
            parts.append(q_new)
            parts.append(q[qs + 4:qs + 7] + dt * v_next[vs + 3:vs + 6])
        elif jt in (REVOLUTE, PRISMATIC):
            parts.append(q[qs:qs + 1] + dt * v_next[vs:vs + 1])
    return torch.cat(parts) if parts else q


# ---------------------------------------------------------------------------
# contact
# ---------------------------------------------------------------------------


def _box_face_corners(C, Rw, pw, bi):
    """World corners (8, 3, B) of box bi at pose (Rw (3,3,B), pw (3,B))."""
    loc = C.corner_signs * C.box_half[bi][None]          # (8, 3)
    return pw[None] + sum(Rw[:, k][None] * loc[:, k][:, None, None]
                          for k in range(3))


def _projected_area(half, nvec, Rw):
    """Box silhouette area projected along nvec ((3,) or (3, B))."""
    nb_ax = [torch.abs(sum(nvec[a] * Rw[a, j] for a in range(3)))
             for j in range(3)]
    hx, hy, hz = half[0], half[1], half[2]
    return 4.0 * (hy * hz * nb_ax[0] + hx * hz * nb_ax[1]
                  + hx * hy * nb_ax[2])


def _narrowphase_T(cm: ContactModel, C: LaneConsts, centers, box_R_w,
                   box_p_w):
    """centers (ns, 3, B) -> phi (NC,B), normal (NC,3,B), point (NC,3,B),
    static body index tuples, K/d/mu (NC,) constants, and K1 — None, or
    the (NC, B) linear stiffnesses of box-face rows.

    ``box_R_w``/``box_p_w``: per-box world poses, (3,3)/(3,) constants
    for world boxes and (3,3,B)/(3,B) lane tensors for body boxes."""
    phis, normals, points = [], [], []
    B = centers.shape[-1]

    if cm.pair_sh_s:
        c = centers[C.sh_s]                              # (c, 3, B)
        n = C.hs_normal[C.sh_h]                          # (c, 3)
        r = C.sph_radius[C.sh_s]
        off = C.hs_offset[C.sh_h]
        dist = torch.sum(c * n[:, :, None], dim=1) - off[:, None]
        phi = r[:, None] - dist
        n_T = n[:, :, None].expand(c.shape)
        phis.append(phi)
        normals.append(n_T)
        points.append(c - (dist - 0.5 * phi)[:, None] * n_T)

    for si, bi in zip(cm.pair_sb_s, cm.pair_sb_b):
        # per pair: the box pose is a constant (world box) or a lane
        # tensor (body box)
        c = centers[si]                                  # (3, B)
        Rw, pw = box_R_w[bi], box_p_w[bi]
        d0 = c - (pw[:, None] if pw.dim() == 1 else pw)
        local = torch.stack([sum(Rw[k, j] * d0[k] for k in range(3))
                             for j in range(3)])         # R^T d0, (3, B)
        half = C.box_half[bi][:, None]                   # (3, 1)
        clamped = torch.minimum(torch.maximum(local, -half), half)
        delta = local - clamped
        dist_out = torch.sqrt(torch.sum(delta * delta, 0))
        inside_gap = half - torch.abs(local)
        # amin, not min(dim=...): on the CPU the index-returning reduction
        # takes ~10 ms a call under intra-op threads at these sizes
        min_gap = torch.amin(inside_gap, dim=0)
        inside = dist_out < 1e-9
        # inner-face normal: one-hot of the min gap, ties broken toward
        # the first axis (x, y, z); sign(0) = 0
        is_min = (inside_gap <= min_gap[None]).to(local.dtype)
        w0 = is_min[0]
        w1 = is_min[1] * (1.0 - w0)
        w2 = is_min[2] * (1.0 - w0) * (1.0 - w1)
        one_hot = torch.stack([w0, w1, w2])
        sign = torch.sign(torch.sum(one_hot * local, dim=0))
        n_local_in = one_hot * sign[None]
        n_local_out = delta / torch.clamp(dist_out, min=1e-9)[None]
        n_local = torch.where(inside[None], n_local_in, n_local_out)
        sd = torch.where(inside, -min_gap, dist_out)
        phi = C.sph_radius[si] - sd
        n_w = torch.stack([sum(Rw[a, j] * n_local[j] for j in range(3))
                           for a in range(3)])
        p_w = c - (sd - 0.5 * phi)[None] * n_w
        phis.append(phi[None]); normals.append(n_w[None])
        points.append(p_w[None])

    if cm.pair_ss_a:
        ca, cb = centers[C.ss_a], centers[C.ss_b]
        rb = C.sph_radius[C.ss_b]
        dvec = ca - cb
        dist = torch.sqrt(torch.sum(dvec * dvec, 1))
        n = dvec / torch.clamp(dist, min=1e-9)[:, None]
        phi = C.ss_rsum[:, None] - dist
        pnt = cb + (rb[:, None] - 0.5 * phi)[:, None] * n
        phis.append(phi); normals.append(n); points.append(pnt)

    if cm.pair_sw_s:
        ca = centers[C.sw_s]                             # (c, 3, B)
        cw = C.ws_pos[C.sw_w]                            # (c, 3)
        rw = C.ws_radius[C.sw_w]
        dvec = ca - cw[:, :, None]
        dist = torch.sqrt(torch.sum(dvec * dvec, 1))
        n = dvec / torch.clamp(dist, min=1e-9)[:, None]
        phi = C.sw_rsum[:, None] - dist
        pnt = cw[:, :, None] + (rw[:, None] - 0.5 * phi)[:, None] * n
        phis.append(phi); normals.append(n); points.append(pnt)

    n_quad = sum(p.shape[0] for p in phis)              # quadratic-law rows
    K1_rows = []
    for pi, (bi, hi) in enumerate(zip(cm.pair_bh_b, cm.pair_bh_h)):
        # box face vs halfspace: 8 corner point contacts with a LINEAR
        # foundation stiffness K1 = g * A_proj(R) / 4
        Rw, pw = box_R_w[bi], box_p_w[bi]                # (3,3,B)/(3,B)
        n_h = C.hs_normal[hi]                            # (3,)
        K1_pair = C.bh_g[pi] * _projected_area(C.box_half[bi], n_h, Rw) / 4.0
        corner = _box_face_corners(C, Rw, pw, bi)        # (8, 3, B)
        phi = C.hs_offset[hi] - sum(n_h[a] * corner[:, a] for a in range(3))
        phis.append(phi)
        normals.append(n_h[None, :, None].expand(8, 3, B))
        points.append(corner)
        K1_rows.append(K1_pair[None].expand(8, B))

    for pi, (bi, si) in enumerate(zip(cm.pair_bs_b, cm.pair_bs_s)):
        # box face vs body sphere: the bh corner quadrature on a spherical
        # "ground"
        Rw, pw = box_R_w[bi], box_p_w[bi]
        c = centers[si]                                  # (3, B)
        dirv = [c[a] - pw[a] for a in range(3)]
        dn = torch.sqrt(sum(v * v for v in dirv) + 1e-18)
        nbar = [v / dn for v in dirv]
        K1_pair = C.bs_g[pi] * _projected_area(C.box_half[bi], nbar, Rw) / 4.0
        corner = _box_face_corners(C, Rw, pw, bi)        # (8, 3, B)
        delta = corner - c[None]
        dist = torch.sqrt(torch.sum(delta * delta, dim=1) + 1e-18)
        phis.append(C.sph_radius[si] - dist)
        normals.append(delta / dist[:, None])
        points.append(corner)
        K1_rows.append(K1_pair[None].expand(8, B))

    phi_all = torch.cat(phis)
    K1 = None
    if K1_rows:
        K1 = torch.cat([phi_all.new_zeros((n_quad, B))] + K1_rows)
    return (phi_all, torch.cat(normals), torch.cat(points),
            C.body_a, C.body_b, C.K, C.d, C.mu, K1)


def _contact_jacobians_T(model, C: LaneConsts, kinT, points):
    """Relative contact-point Jacobians (NC, 3, nv, B): body A's point
    Jacobian minus body B's (world = zero)."""
    R, p, dof_axis_w, dof_origin_w, is_ang, is_lin = kinT

    def side(anc):                                       # anc (NC, nv)
        lever = points[:, None] - dof_origin_w[None]     # (NC, nv, 3, B)
        ax = dof_axis_w[None].expand_as(lever)
        crs = torch.stack([
            ax[:, :, 1] * lever[:, :, 2] - ax[:, :, 2] * lever[:, :, 1],
            ax[:, :, 2] * lever[:, :, 0] - ax[:, :, 0] * lever[:, :, 2],
            ax[:, :, 0] * lever[:, :, 1] - ax[:, :, 1] * lever[:, :, 0],
        ], dim=2)
        lin = (is_ang[None, :, None, None] * crs
               + is_lin[None, :, None, None] * dof_axis_w[None])
        return (lin * anc[:, :, None, None]).transpose(1, 2)

    Jc = side(C.anc_a)
    if C.anc_b is not None:
        Jc = Jc - side(C.anc_b)
    return Jc                                            # (NC, 3, nv, B)


def sphere_centers_T(R, p, sph_body, sph_offset):
    """World centers (ns, 3, B) of body-attached spheres from the body
    poses R (nb, 3, 3, B), p (nb, 3, B): sph_body (ns,) long, sph_offset
    (ns, 3) in the body frame."""
    Rb, pb = R[sph_body], p[sph_body]                    # (ns, 3, 3, B)
    return pb + sum(Rb[:, :, j] * sph_offset[:, j][:, None, None]
                    for j in range(3))


def box_poses_T(contact: ContactModel, C, R, p):
    """World poses of the scene's boxes: lists of rotations and positions,
    (3, 3) / (3,) constants for world boxes and (3, 3, B) / (3, B) lane
    tensors for body boxes, from the body poses R (nb, 3, 3, B), p (nb,
    3, B)."""
    box_R_w, box_p_w = [], []
    for i, bb in enumerate(contact.box_body):
        if bb < 0:
            box_R_w.append(C.box_rot[i])
            box_p_w.append(C.box_pos[i])
        else:
            Rb = R[bb]                                   # (3, 3, B)
            box_R_w.append(sum(Rb[:, k][:, None]
                               * C.box_rot[i][k][None, :, None]
                               for k in range(3)))
            box_p_w.append(p[bb] + sum(Rb[:, k] * C.box_pos[i][k]
                                       for k in range(3)))
    return box_R_w, box_p_w


def _contact_primal_T(model, C: LaneConsts, contact: ContactModel, kinT):
    """Sphere centers -> narrowphase -> contact Jacobians.  Returns
    (phi, normal, point, body_a, body_b, K, d, mu, K1, Jc)."""
    R, p = kinT[0], kinT[1]
    B = p.shape[-1]
    if contact.sph_body:
        centers = sphere_centers_T(R, p, C.sph_body, C.sph_offset)
    else:
        centers = p.new_zeros((0, 3, B))
    phi, normal, point, body_a, body_b, K, d, mu, K1 = _narrowphase_T(
        contact, C, centers, *box_poses_T(contact, C, R, p))
    Jc = _contact_jacobians_T(model, C, kinT, point)
    return phi, normal, point, body_a, body_b, K, d, mu, K1, Jc


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def make_lane_step(
    model: MultibodyModel,
    contact: Optional[ContactModel],
    dt: float,
    contact_iters: int = 2,
    force_params: ContactForceParams = ContactForceParams(),
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build step_T(x_T, u_T) -> x_next_T with x_T (n, B), u_T (m, B).

    The returned function records its build options (``contact_iters``,
    ``force_params``) so the CUDA kernels can be built for exactly the
    same step."""
    nq, nv = model.nq, model.nv
    consts = _consts_cache(model, contact)
    has_contact = contact is not None and contact.num_contacts > 0

    def step_T(x, u):
        C = consts(x.dtype)
        q, v = x[:nq], x[nq:]
        kinT, M, bias, anc = _dynamics_terms_T(model, C, q, v)
        tau = (torch.sum(C.B_act[:, :, None] * u[None], dim=1)
               if model.nu else torch.zeros_like(bias)) - bias

        if not has_contact:
            v_next = v + dt * solve_spd_T(M, tau)
        else:
            (phi, normal, point, body_a, body_b, K, d, mu, K1,
             Jc) = _contact_primal_T(model, C, contact, kinT)
            nc = Jc.shape[0]
            Jf = Jc.reshape(3 * nc, nv, -1)

            if contact_iters == 0:
                v_rel = torch.sum(Jc * v[None, None], dim=2)
                f = _contact_forces_T(phi, normal, v_rel, K, d, mu,
                                      force_params, K1=K1)
                tau_c = torch.sum(Jc * f[:, :, None], dim=(0, 1))
                v_next = v + dt * solve_spd_T(M, tau + tau_c)
            else:
                def residual_T(vp, params):
                    v_rel = torch.sum(Jc * vp[None, None], dim=2)
                    f, D = _contact_forces_implicit_T(
                        phi, normal, v_rel, K, d, mu, dt, params, K1=K1)
                    tau_c = torch.sum(Jc * f[:, :, None], dim=(0, 1))
                    res = torch.sum(M * (vp - v)[None], dim=1) - dt * (
                        tau + tau_c)
                    return res, D

                vp = v + dt * solve_spd_T(M, tau)        # contact-free predictor
                # stiction continuation + damped Newton: per lane, a half
                # step when the full step's residual grew (impact overshoot)
                for vs_eff in stiction_schedule(force_params.stiction_vel,
                                                contact_iters):
                    p_it = force_params._replace(stiction_vel=vs_eff)
                    res, D = residual_T(vp, p_it)
                    # G = M - dt Jc' D Jc via E = D Jc
                    E = sum(D[:, :, j][:, :, None] * Jc[:, j][:, None]
                            for j in range(3))
                    G = M - dt * _outer_sum(Jf, E.reshape(3 * nc, nv, -1))
                    dv = solve_small_T(G, res)
                    vp1 = vp - dv
                    r1, _ = residual_T(vp1, p_it)
                    grew = (torch.sum(r1 * r1, dim=0)
                            > 4.0 * torch.sum(res * res, dim=0))
                    vp = torch.where(grew[None], vp - 0.5 * dv, vp1)
                v_next = vp

        q_next = _integrate_positions_T(model, q, v_next, dt)
        return torch.cat([q_next, v_next])

    step_T.contact_iters = contact_iters
    step_T.force_params = force_params
    return step_T
