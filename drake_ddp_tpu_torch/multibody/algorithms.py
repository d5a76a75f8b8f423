"""Articulated rigid-body algorithms, world-frame Jacobian formulation.

Port of ``drake_ddp_tpu/multibody/algorithms.py``: plain functions of a
:class:`~drake_ddp_tpu_torch.multibody.model.MultibodyModel` and one
configuration ``q (nq,)`` (and velocity ``v (nv,)``), computed on the
device and in the dtype of ``q``; the model's float32 tables are cast to
it.  Loops run over bodies (static topology); the mass matrix is
sum_b J_b' I_b J_b from body Jacobians, and the velocity-product and
gravity bias comes from world-frame Newton-Euler with qddot = 0.  The
solver's hot path does not use these (it runs the lane-major step of
:mod:`~drake_ddp_tpu_torch.multibody.lanestep` and the CUDA kernels);
the examples seed their guess with :func:`gravity_compensation`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from drake_ddp_tpu_torch.multibody.model import (
    FREE,
    PRISMATIC,
    REVOLUTE,
    MultibodyModel,
    _NV,
    ancestor_dof_mask,
)
from drake_ddp_tpu_torch.utils.spatial import (axis_angle_rot, quat_integrate,
                                               quat_to_rot)


class Kinematics(NamedTuple):
    """World-frame kinematics of every body."""

    R: torch.Tensor            # (nb, 3, 3) body orientation
    p: torch.Tensor            # (nb, 3)    body-frame origin position
    dof_axis_w: torch.Tensor   # (nv, 3) world axis of each velocity dof
    dof_origin_w: torch.Tensor  # (nv, 3) world point the dof rotates about
    dof_is_ang: torch.Tensor   # (nv,) 1 for angular dofs
    dof_is_lin: torch.Tensor   # (nv,) 1 for linear dofs


def _tables(model: MultibodyModel, like: torch.Tensor):
    """The model's tables in the dtype and on the device of ``like``."""
    c = lambda a: a.to(dtype=like.dtype, device=like.device)
    return (c(model.X_PJ_rot), c(model.X_PJ_pos), c(model.axis),
            c(model.mass), c(model.com), c(model.inertia), c(model.damping),
            c(model.armature), c(model.gravity))


def forward_kinematics(model: MultibodyModel, q: torch.Tensor) -> Kinematics:
    """World poses of all bodies and per-dof Jacobian data."""
    nb, nv = model.nb, model.nv
    X_rot, X_pos, axis = _tables(model, q)[:3]
    kw = dict(dtype=q.dtype, device=q.device)
    eye = torch.eye(3, **kw)
    Rs, ps = [], []
    dof_axis = [None] * nv
    dof_origin = [None] * nv
    is_ang, is_lin = np.zeros(nv), np.zeros(nv)
    for b in range(nb):
        par = model.parent[b]
        Rp = eye if par < 0 else Rs[par]
        pp = torch.zeros(3, **kw) if par < 0 else ps[par]
        jt = model.joint_type[b]
        qs, vs = model.q_start[b], model.v_start[b]
        R_J = Rp @ X_rot[b]
        p_J = pp + Rp @ X_pos[b]
        if jt == FREE:
            R_b = R_J @ quat_to_rot(q[qs:qs + 4])
            p_b = p_J + Rp @ q[qs + 4:qs + 7]
            for k in range(3):
                dof_axis[vs + k] = dof_axis[vs + 3 + k] = eye[k]
                dof_origin[vs + k] = dof_origin[vs + 3 + k] = p_b
                is_ang[vs + k] = is_lin[vs + 3 + k] = 1.0
        elif jt == REVOLUTE:
            R_b = R_J @ axis_angle_rot(axis[b], q[qs])
            p_b = p_J
            dof_axis[vs] = R_b @ axis[b]
            dof_origin[vs] = p_b
            is_ang[vs] = 1.0
        elif jt == PRISMATIC:
            R_b = R_J
            p_b = p_J + R_J @ (axis[b] * q[qs])
            dof_axis[vs] = R_b @ axis[b]
            dof_origin[vs] = p_b
            is_lin[vs] = 1.0
        else:  # FIXED
            R_b, p_b = R_J, p_J
        Rs.append(R_b)
        ps.append(p_b)
    empty = torch.zeros((0, 3), **kw)
    return Kinematics(
        R=torch.stack(Rs), p=torch.stack(ps),
        dof_axis_w=torch.stack(dof_axis) if nv else empty,
        dof_origin_w=torch.stack(dof_origin) if nv else empty,
        dof_is_ang=torch.as_tensor(is_ang, **kw),
        dof_is_lin=torch.as_tensor(is_lin, **kw))


def point_jacobian(model: MultibodyModel, kin: Kinematics, body: int,
                   p_w: torch.Tensor, anc_mask: torch.Tensor) -> torch.Tensor:
    """Translational Jacobian (3, nv) of a world point attached to a body;
    ``anc_mask`` is the body's (nv,) row of :func:`ancestor_dof_mask`."""
    lever = p_w[None, :] - kin.dof_origin_w                  # (nv, 3)
    lin = (kin.dof_is_ang[:, None]
           * torch.linalg.cross(kin.dof_axis_w, lever, dim=-1)
           + kin.dof_is_lin[:, None] * kin.dof_axis_w)
    return (lin * anc_mask[:, None]).T


def _body_jacobians(kin: Kinematics, anc: torch.Tensor, points):
    """J_ang (nb, 3, nv) and J_lin (nb, 3, nv) at per-body points."""
    ang = kin.dof_is_ang[:, None] * kin.dof_axis_w           # (nv, 3)
    lever = points[:, None, :] - kin.dof_origin_w[None]      # (nb, nv, 3)
    ax = kin.dof_axis_w[None].expand_as(lever)
    lin = (kin.dof_is_ang[None, :, None] * torch.linalg.cross(ax, lever,
                                                              dim=-1)
           + kin.dof_is_lin[None, :, None] * kin.dof_axis_w[None])
    J_ang = (ang[None] * anc[:, :, None]).transpose(-1, -2)
    J_lin = (lin * anc[:, :, None]).transpose(-1, -2)
    return J_ang, J_lin


def _inertia_terms(model, kin, tables):
    mass, com, inertia = tables[3], tables[4], tables[5]
    anc = torch.as_tensor(ancestor_dof_mask(model), dtype=kin.p.dtype,
                          device=kin.p.device)
    com_w = kin.p + torch.einsum("bij,bj->bi", kin.R, com)
    J_ang, J_com = _body_jacobians(kin, anc, com_w)
    I_w = torch.einsum("bij,bjk,blk->bil", kin.R, inertia, kin.R)
    M = (torch.einsum("bim,bij,bjn->mn", J_ang, I_w, J_ang)
         + torch.einsum("bim,b,bin->mn", J_com, mass, J_com)
         + torch.diag(tables[7]))
    return anc, com_w, J_ang, J_com, I_w, M


def mass_matrix(model: MultibodyModel, kin: Kinematics) -> torch.Tensor:
    """M(q) (nv, nv): sum over bodies of J' I J (kinetic-energy form)."""
    return _inertia_terms(model, kin, _tables(model, kin.p))[-1]


class Dynamics(NamedTuple):
    kin: Kinematics
    M: torch.Tensor         # (nv, nv)
    bias: torch.Tensor      # (nv,) C(q, v) v - tau_g(q) + damping v
    w: torch.Tensor         # (nb, 3) body angular velocities (world)
    v_origin: torch.Tensor  # (nb, 3) body-origin velocities (world)


def dynamics_terms(model: MultibodyModel, q: torch.Tensor,
                   v: torch.Tensor) -> Dynamics:
    """Everything the integrator needs: M, bias, body velocities."""
    tables = _tables(model, q)
    mass, damping, gravity = tables[3], tables[6], tables[8]
    kin = forward_kinematics(model, q)
    nb = model.nb
    anc, com_w, J_ang, J_com, I_w, M = _inertia_terms(model, kin, tables)
    w = J_ang @ v                                             # (nb, 3)
    v_origin = _body_jacobians(kin, anc, kin.p)[1] @ v
    zero3 = torch.zeros(3, dtype=q.dtype, device=q.device)
    # velocity-product accelerations with qddot = 0 (world frame):
    # alpha_b = sum over the angular ancestor dofs k of v_k (w_parent(k) x a_k)
    wp_dof = [zero3 if model.parent[b] < 0 else w[model.parent[b]]
              for b in range(nb) for _ in range(_NV[model.joint_type[b]])]
    wp_dof = (torch.stack(wp_dof) if model.nv
              else torch.zeros((0, 3), dtype=q.dtype, device=q.device))
    alpha_term = (v[:, None] * kin.dof_is_ang[:, None]
                  * torch.linalg.cross(wp_dof, kin.dof_axis_w, dim=-1))
    alpha = torch.einsum("bk,ki->bi", anc, alpha_term)        # (nb, 3)
    a_o = [None] * nb
    for b in range(nb):
        par = model.parent[b]
        if par < 0:
            a_o[b] = zero3
            continue
        r = kin.p[b] - kin.p[par]
        a = (a_o[par] + torch.linalg.cross(alpha[par], r, dim=-1)
             + torch.linalg.cross(w[par], torch.linalg.cross(w[par], r,
                                                             dim=-1), dim=-1))
        if model.joint_type[b] == PRISMATIC:
            vs = model.v_start[b]
            a = a + 2.0 * torch.linalg.cross(w[par], kin.dof_axis_w[vs]
                                             * v[vs], dim=-1)
        a_o[b] = a
    a_o = torch.stack(a_o)
    c_w = com_w - kin.p
    a_com = (a_o + torch.linalg.cross(alpha, c_w, dim=-1)
             + torch.linalg.cross(w, torch.linalg.cross(w, c_w, dim=-1),
                                  dim=-1))
    # Newton-Euler wrenches (world, at the com) projected on the dofs
    F = mass[:, None] * (a_com - gravity[None, :])
    T = (torch.einsum("bij,bj->bi", I_w, alpha)
         + torch.linalg.cross(w, torch.einsum("bij,bj->bi", I_w, w), dim=-1))
    bias = (torch.einsum("bim,bi->m", J_ang, T)
            + torch.einsum("bim,bi->m", J_com, F) + damping * v)
    return Dynamics(kin=kin, M=M, bias=bias, w=w, v_origin=v_origin)


def gravity_compensation(model: MultibodyModel,
                         q: torch.Tensor) -> torch.Tensor:
    """Actuator torques that hold the configuration statically (the
    examples' initial guess): bias(q, 0) at the actuated v-dofs."""
    v0 = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
    bias = dynamics_terms(model, q, v0).bias
    return bias[list(model.actuated_vdof)]


def integrate_positions(model: MultibodyModel, q: torch.Tensor,
                        v_next: torch.Tensor, dt) -> torch.Tensor:
    """Semi-implicit position update q' = q (+) dt N(q) v' (positions
    advance with the new velocities, Drake's discrete update)."""
    parts = []
    for b in range(model.nb):
        jt = model.joint_type[b]
        qs, vs = model.q_start[b], model.v_start[b]
        if jt == FREE:
            parts.append(quat_integrate(q[qs:qs + 4], v_next[vs:vs + 3], dt))
            parts.append(q[qs + 4:qs + 7] + dt * v_next[vs + 3:vs + 6])
        elif jt in (REVOLUTE, PRISMATIC):
            parts.append(q[qs:qs + 1] + dt * v_next[vs:vs + 1])
    return torch.cat(parts) if parts else q
