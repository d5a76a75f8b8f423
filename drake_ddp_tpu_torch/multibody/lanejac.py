"""Lane-major structured-IFT step Jacobians (fx, fu), plain PyTorch.

Port of ``drake_ddp_tpu/multibody/lanejac.py``.  The step solves,
implicitly in v',

    res(v'; q, v, u) = M(q)(v' - v) - dt (B u - bias(q, v) + Jc(q)' f(v')) = 0
    q' = q (+) dt N(q) v'

so by the implicit function theorem dv' = -G^{-1} (dres/dq dq + dres/dv dv
+ dres/du du) with G = dres/dv' = M - dt Jc' D Jc:

- u-directions are free: dres/du = -dt B, so fu's velocity block is
  dt G^{-1} B;
- v-directions only move the velocity-product bias;
- q-directions are pushed through kinematics, mass matrix, narrowphase,
  contact Jacobians and one force evaluation, not through the Newton
  iterations.

The tangent groups run as ``torch.func.vmap`` over ``torch.func.jvp`` so
the primal is computed once per group.  On the card this is the main
path's derivative stage for this slice (the JAX package's
``deriv_kernel="lane"`` configuration); its hand kernel (megajac) is the
next slice.  The JAX code's ablation and q-loop probe hooks are not
ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jvp, vmap

from drake_ddp_tpu_torch.contact.forces import (ContactForceParams,
                                                stiction_schedule)
from drake_ddp_tpu_torch.contact.geometry import ContactModel
from drake_ddp_tpu_torch.multibody.lanestep import (
    _bias_T,
    _consts_cache,
    _contact_force_pred_T,
    _contact_forces_implicit_T,
    _contact_primal_T,
    _integrate_positions_T,
    _kin_mass_T,
    _outer_sum,
    solve_small_T,
    solve_spd_T,
)
from drake_ddp_tpu_torch.multibody.model import MultibodyModel


def inv_small_T(A):
    """Unpivoted Gauss-Jordan inverse, lane-major: (n, n, B) -> same.
    For the diagonally dominant contact Newton matrix G."""
    n = A.shape[0]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Ab = torch.cat([A, eye[:, :, None].expand(A.shape)], dim=1)  # (n, 2n, B)
    not_k = 1.0 - eye
    for k in range(n):
        pivot_row = Ab[k]                                # (2n, B)
        factor = Ab[:, k] / Ab[k][k]                     # (n, B)
        factor = factor * not_k[k][:, None]              # zero at the pivot
        Ab = Ab - factor[:, None, :] * pivot_row[None]
    diag = torch.stack([Ab[i][i] for i in range(n)])     # (n, B)
    return Ab[:, n:] / diag[:, None]


def make_lane_jac(
    model: MultibodyModel,
    contact: Optional[ContactModel],
    dt: float,
    contact_iters: int = 2,
    force_params: ContactForceParams = ContactForceParams(),
    root_seed: bool = False,
    refine_iters: int = 0,
) -> Callable:
    """Build ``jac_T(x (n, L), u (m, L)) -> (fx (n, n, L), fu (n, m, L))``,
    the per-lane Jacobians d x'/d x and d x'/d u of the lane step.

    ``root_seed``: the returned function takes a third argument
    ``x_next (n, L)``, the rollout's converged next state, and linearizes
    there instead of re-running the contact Newton (``refine_iters``
    extra damped steps at the final stiction width, default 0: the step
    map's output is the schedule's last iterate, and the linearization
    point must match it)."""
    nq, nv, nu = model.nq, model.nv, model.nu
    n = nq + nv
    has_contact = contact is not None and contact.num_contacts > 0
    if has_contact and contact_iters < 1:
        raise ValueError(
            "lane_jac needs the implicit contact step (contact_iters >= 1)")
    consts = _consts_cache(model, contact)

    def jac_T(x, u, x_next=None):
        C = consts(x.dtype)
        L = x.shape[-1]
        q, v = x[:nq], x[nq:]
        vp_seed = None if x_next is None else x_next[nq:]

        # ---------------- primal (shared by every tangent group) -------
        kinT, M, (J_ang, J_com, I_w, com_w), _ = _kin_mass_T(model, C, q)
        bias = _bias_T(model, C, kinT, J_ang, J_com, I_w, com_w, v)
        tau = (torch.sum(C.B_act[:, :, None] * u[None], dim=1)
               if nu else torch.zeros_like(bias)) - bias

        if has_contact:
            (phi, normal, point, body_a, body_b, Kp, dp, mup, K1p,
             Jc) = _contact_primal_T(model, C, contact, kinT)
            nc = Jc.shape[0]
            Jf = Jc.reshape(3 * nc, nv, L)

            def residual_T(vp, params=force_params):
                v_rel = torch.sum(Jc * vp[None, None], dim=2)
                f, D = _contact_forces_implicit_T(
                    phi, normal, v_rel, Kp, dp, mup, dt, params, K1=K1p)
                tau_c = torch.sum(Jc * f[:, :, None], dim=(0, 1))
                res = torch.sum(M * (vp - v)[None], dim=1) - dt * (
                    tau + tau_c)
                return res, D

            def newton_mat(D):
                E = sum(D[:, :, j][:, :, None] * Jc[:, j][:, None]
                        for j in range(3))
                return M - dt * _outer_sum(Jf, E.reshape(3 * nc, nv, L))

            # the lane step's continuation Newton (primal only); root_seed
            # starts from the rollout's root and polishes at the final
            # width only
            if vp_seed is not None:
                vp = vp_seed
                schedule = [force_params.stiction_vel] * refine_iters
            else:
                vp = v + dt * solve_spd_T(M, tau)
                schedule = stiction_schedule(force_params.stiction_vel,
                                             contact_iters)
            for vs_eff in schedule:
                p_it = force_params._replace(stiction_vel=vs_eff)
                res, D = residual_T(vp, p_it)
                dv = solve_small_T(newton_mat(D), res)
                vp1 = vp - dv
                r1, _ = residual_T(vp1, p_it)
                grew = (torch.sum(r1 * r1, dim=0)
                        > 4.0 * torch.sum(res * res, dim=0))
                vp = torch.where(grew[None], vp - 0.5 * dv, vp1)
            # G at the root: the IFT linearization point
            _, D = residual_T(vp)
            Ginv = inv_small_T(newton_mat(D))
        else:
            vp = (vp_seed if vp_seed is not None
                  else v + dt * solve_spd_T(M, tau))
            Ginv = inv_small_T(M)

        # ---------------- q-tangents (nq full directions) ---------------
        # d res/dq with (v, u, vp) fixed; terms constant in q are dropped
        def res_of_q(qq):
            kin2, M2, (Ja2, Jo2, Iw2, cw2), _ = _kin_mass_T(model, C, qq)
            bias2 = _bias_T(model, C, kin2, Ja2, Jo2, Iw2, cw2, v)
            out = torch.sum(M2 * (vp - v)[None], dim=1) + dt * bias2
            if has_contact:
                # K1 depends on the box orientation, so the q-tangent
                # flows through the recomputed K1_2
                (phi2, normal2, _pt2, _ba, _bb, _K2, _d2, _m2, K1_2,
                 Jc2) = _contact_primal_T(model, C, contact, kin2)
                v_rel2 = torch.sum(Jc2 * vp[None, None], dim=2)
                f2 = _contact_force_pred_T(phi2, normal2, v_rel2, Kp, dp,
                                           mup, dt, force_params, K1=K1_2)
                out = out - dt * torch.sum(Jc2 * f2[:, :, None],
                                           dim=(0, 1))
            return out

        eye_q = torch.eye(nq, dtype=x.dtype, device=x.device)
        dres_q = vmap(lambda e: jvp(res_of_q, (q,),
                                    (e[:, None].expand(nq, L),))[1])(eye_q)

        # ---------------- v-tangents (nv cheap directions) --------------
        def res_of_v(vv):
            bias2 = _bias_T(model, C, kinT, J_ang, J_com, I_w, com_w, vv)
            return dt * bias2 - torch.sum(M * vv[None], dim=1)

        eye_v = torch.eye(nv, dtype=x.dtype, device=x.device)
        dres_v = vmap(lambda e: jvp(res_of_v, (v,),
                                    (e[:, None].expand(nv, L),))[1])(eye_v)

        # ---------------- assemble dv' = -G^{-1} dres -------------------
        dres_x = torch.cat([dres_q, dres_v], dim=0)              # (n, nv, L)
        dvp_x = -sum(Ginv[:, j][None] * dres_x[:, j][:, None]
                     for j in range(nv))                         # (n, nv, L)
        if nu:
            # u-directions: dres/du = -dt B  =>  dv' = dt G^{-1} B
            dvp_u = dt * sum(Ginv[:, j][None] * C.B_act[j][:, None, None]
                             for j in range(nv))                 # (nu, nv, L)
            dvp_all = torch.cat([dvp_x, dvp_u], dim=0)
        else:
            dvp_all = dvp_x                                      # (n+m, nv, L)

        # ---------------- q' tangents through the integrator ------------
        def int_fn(qq, vv):
            return _integrate_positions_T(model, qq, vv, dt)

        ndir = n + nu
        dq_in = torch.cat([
            eye_q[:, :, None].expand(nq, nq, L),
            x.new_zeros((ndir - nq, nq, L)),
        ], dim=0)
        dqn_all = vmap(lambda dq_e, dv_e: jvp(int_fn, (q, vp),
                                              (dq_e, dv_e))[1])(
            dq_in, dvp_all)                                      # (ndir, nq, L)

        dx_all = torch.cat([dqn_all, dvp_all], dim=1)            # (ndir, n, L)
        fx = dx_all[:n].transpose(0, 1)                          # (n, n, L)
        fu = dx_all[n:].transpose(0, 1)                          # (n, nu, L)
        return fx, fu

    if root_seed:
        return lambda x, u, x_next: jac_T(x, u, x_next)
    return lambda x, u: jac_T(x, u)
