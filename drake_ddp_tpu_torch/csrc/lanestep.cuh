// One lane of the multibody contact step, as a CUDA device function.
//
// The device step that megastep.cu and megaroll.cu run: the counterpart
// of the step body that the JAX package's Pallas kernels trace from
// drake_ddp_tpu/multibody/lanestep.py (make_lane_step), and of the plain
// PyTorch step drake_ddp_tpu_torch/multibody/lanestep.py, which it
// follows operation for operation: forward kinematics, world inertias
// and mass matrix, velocity-product bias forces, narrowphase (sphere-
// halfspace, sphere-box, box-face-halfspace), contact Jacobians, the
// stiction-continuation damped Newton solve of the implicit contact
// velocity with its unpivoted Cholesky predictor and unpivoted
// Gauss-Jordan steps, and the position integration with quaternion
// renormalization.
//
// Design.  One thread is one lane (one scenario x candidate).  The model
// and contact constants are one packed StepTable in global memory that
// every thread reads (broadcast through L1).  The lane's working set
// (body poses, mass matrix, Cholesky factor, Newton matrix, contact
// Jacobians, ...) lives in a lane-strided global scratch buffer,
// element i of lane l at scratch[i * L + l], so the 32 threads of a warp
// touch 32 consecutive words.  What bounds this on an H100 is latency:
// the step is a long chain of dependent scalar operations per lane
// (about 10^5 flops per Newton iteration at the flagship sizes) with
// far fewer lanes than the card has thread slots, so most of the card
// idles.  The simple layout is the right first version; shared-memory
// tiles and several threads per lane are later work.
//
// The step is a template over the scalar type S so that the Jacobian
// kernel can run the same code on a forward-mode dual number: S needs
// + - * /, the s_* math functions below and val() for comparisons.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DDP_MAX_BODIES 32
#define DDP_MAX_Q 40
#define DDP_MAX_V 32
#define DDP_MAX_U 32
#define DDP_MAX_CONTACTS 64
#define DDP_MAX_SPHERES 32
#define DDP_MAX_BOXES 8
#define DDP_MAX_HALFSPACES 4
#define DDP_MAX_ITERS 16

enum { J_FREE = 0, J_REVOLUTE = 1, J_PRISMATIC = 2, J_FIXED = 3 };
// contact row kinds: sphere-halfspace, sphere-box, box face corner vs
// halfspace
enum { C_SH = 0, C_SB = 1, C_BH = 2 };

// The packed model + contact + solver table.  Only 4-byte fields, ints
// first, so the layout has no padding; ops/_table.py mirrors it with a
// ctypes.Structure and checks sizeof against ddp_table_bytes().
struct StepTable {
  int32_t nb, nq, nv, nu, nc, ns, nbox, nh, contact_iters, has_contact;
  int32_t parent[DDP_MAX_BODIES];
  int32_t jtype[DDP_MAX_BODIES];
  int32_t q_start[DDP_MAX_BODIES];
  int32_t v_start[DDP_MAX_BODIES];
  int32_t act_vdof[DDP_MAX_U];
  int32_t dof_parent[DDP_MAX_V];   // parent body of the dof's body, -1 world
  int32_t sph_body[DDP_MAX_SPHERES];
  int32_t box_body[DDP_MAX_BOXES];
  int32_t c_kind[DDP_MAX_CONTACTS];
  int32_t c_i0[DDP_MAX_CONTACTS];    // sphere (SH, SB) or box (BH)
  int32_t c_i1[DDP_MAX_CONTACTS];    // halfspace (SH, BH) or box (SB)
  int32_t c_corner[DDP_MAX_CONTACTS];
  int32_t c_body_a[DDP_MAX_CONTACTS];
  int32_t c_body_b[DDP_MAX_CONTACTS];
  float dt, smooth_width, stiction_vel, force_scale;
  float sched[DDP_MAX_ITERS];        // stiction continuation widths
  float X_rot[DDP_MAX_BODIES][9];
  float X_pos[DDP_MAX_BODIES][3];
  float axis[DDP_MAX_BODIES][3];
  float rot_K[DDP_MAX_BODIES][9];    // cross-product matrix of the axis
  float rot_K2[DDP_MAX_BODIES][9];   // its square
  float mass[DDP_MAX_BODIES];
  float com[DDP_MAX_BODIES][3];
  float inertia[DDP_MAX_BODIES][9];
  float damping[DDP_MAX_V];
  float armature[DDP_MAX_V];
  float gravity[3];
  float is_ang[DDP_MAX_V];
  float is_lin[DDP_MAX_V];
  float anc[DDP_MAX_BODIES][DDP_MAX_V];
  float sph_off[DDP_MAX_SPHERES][3];
  float sph_r[DDP_MAX_SPHERES];
  float hs_n[DDP_MAX_HALFSPACES][3];
  float hs_off[DDP_MAX_HALFSPACES];
  float box_rot[DDP_MAX_BOXES][9];
  float box_pos[DDP_MAX_BOXES][3];
  float box_half[DDP_MAX_BOXES][3];
  float c_K[DDP_MAX_CONTACTS];
  float c_d[DDP_MAX_CONTACTS];
  float c_mu[DDP_MAX_CONTACTS];
  float c_g[DDP_MAX_CONTACTS];       // box-face pressure gradient (BH)
};

// Offsets of the per-lane scratch fields, in scalars.
struct Layout {
  int R, P, AX, OR, COMW, IW, W, AL, ALT, AO, M, LC, X, U, XN, TAU, TMP,
      VP, DV, RES, R1, VP1, TC, G, JC, PHI, NRM, PNT, K1, CEN, BR, BP, EC,
      total;
};

__host__ __device__ inline Layout make_layout(int nb, int nq, int nv, int nu,
                                              int nc, int ns, int nbox) {
  Layout y;
  int o = 0;
  y.R = o; o += 9 * nb;
  y.P = o; o += 3 * nb;
  y.AX = o; o += 3 * nv;
  y.OR = o; o += 3 * nv;
  y.COMW = o; o += 3 * nb;
  y.IW = o; o += 9 * nb;
  y.W = o; o += 3 * nb;
  y.AL = o; o += 3 * nb;
  y.ALT = o; o += 3 * nv;
  y.AO = o; o += 3 * nb;
  y.M = o; o += nv * nv;
  y.LC = o; o += nv * nv;
  y.X = o; o += nq + nv;
  y.U = o; o += nu;
  y.XN = o; o += nq + nv;
  y.TAU = o; o += nv;
  y.TMP = o; o += nv;
  y.VP = o; o += nv;
  y.DV = o; o += nv;
  y.RES = o; o += nv;
  y.R1 = o; o += nv;
  y.VP1 = o; o += nv;
  y.TC = o; o += nv;
  y.G = o; o += nv * (nv + 1);
  y.JC = o; o += nc * 3 * nv;
  y.PHI = o; o += nc;
  y.NRM = o; o += 3 * nc;
  y.PNT = o; o += 3 * nc;
  y.K1 = o; o += nc;
  y.CEN = o; o += 3 * ns;
  y.BR = o; o += 9 * nbox;
  y.BP = o; o += 3 * nbox;
  y.EC = o; o += 3 * nv;
  y.total = o;
  return y;
}

__host__ __device__ inline Layout make_layout(const StepTable& T) {
  return make_layout(T.nb, T.nq, T.nv, T.nu, T.nc, T.ns, T.nbox);
}

// Lane-strided view of the scratch buffer: element i at p[i * L].
template <typename S>
struct Lane {
  S* p;
  int L;
  __device__ S& operator[](int i) const { return p[(size_t)i * L]; }
};

// Scalar math for S = float.  A dual type provides the same overloads.
// Accurate libdevice versions: the kernels are built without fast math,
// because stiff contact amplifies rounding.
__device__ inline float val(float x) { return x; }
__device__ inline float s_sqrt(float x) { return sqrtf(x); }
__device__ inline float s_exp(float x) { return expf(x); }
__device__ inline float s_log1p(float x) { return log1pf(x); }
__device__ inline float s_sin(float x) { return sinf(x); }
__device__ inline float s_cos(float x) { return cosf(x); }
__device__ inline float s_abs(float x) { return fabsf(x); }
// jnp.sign: sign(0) == 0 (copysign would give +-1)
__device__ inline float s_sign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// log(1 + exp(z)) = max(z, 0) + log1p(exp(-|z|)): the form of
// jax.nn.softplus, stable for either sign of z
template <typename S>
__device__ inline S softplus(S z) {
  S m = val(z) > 0.f ? z : S(0.f);
  return m + s_log1p(s_exp(-s_abs(z)));
}

template <typename S>
__device__ inline S sigmoid(S z) {
  return S(1.f) / (S(1.f) + s_exp(-z));
}

template <typename S>
__device__ inline void cross3(const S a[3], const S b[3], S out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename S>
__device__ inline void load3(const Lane<S>& s, int off, S v[3]) {
  v[0] = s[off]; v[1] = s[off + 1]; v[2] = s[off + 2];
}

template <typename S>
__device__ inline void load9(const Lane<S>& s, int off, S v[9]) {
  for (int k = 0; k < 9; ++k) v[k] = s[off + k];
}

// ---------------------------------------------------------------------------
// kinematics and dynamics terms
// ---------------------------------------------------------------------------

// Body poses R (nb x 3x3), p (nb x 3), and the world axis / origin of
// every velocity dof.  Bodies are in topological order.
template <typename S>
__device__ void fk(const StepTable& T, const Layout& Y, const Lane<S>& s) {
  for (int b = 0; b < T.nb; ++b) {
    const int par = T.parent[b];
    S Rp[9], pp[3];
    if (par < 0) {
      for (int k = 0; k < 9; ++k) Rp[k] = S((k % 4 == 0) ? 1.f : 0.f);
      pp[0] = pp[1] = pp[2] = S(0.f);
    } else {
      load9(s, Y.R + 9 * par, Rp);
      load3(s, Y.P + 3 * par, pp);
    }
    const float* Xr = T.X_rot[b];
    const float* Xp = T.X_pos[b];
    S RJ[9], pJ[3];
    for (int a = 0; a < 3; ++a) {
      for (int c = 0; c < 3; ++c)
        RJ[3 * a + c] = Rp[3 * a] * Xr[c] + Rp[3 * a + 1] * Xr[3 + c] +
                        Rp[3 * a + 2] * Xr[6 + c];
      pJ[a] = pp[a] + (Rp[3 * a] * Xp[0] + Rp[3 * a + 1] * Xp[1] +
                       Rp[3 * a + 2] * Xp[2]);
    }
    S Rb[9], pb[3];
    const int qs = T.q_start[b], vs = T.v_start[b];
    const int jt = T.jtype[b];
    if (jt == J_FREE) {
      const S w = s[Y.X + qs], x = s[Y.X + qs + 1], y = s[Y.X + qs + 2],
              z = s[Y.X + qs + 3];
      const S ww = w * w, xx = x * x, yy = y * y, zz = z * z;
      const S wx = w * x, wy = w * y, wz = w * z;
      const S xy = x * y, xz = x * z, yz = y * z;
      S Q[9];
      Q[0] = ww + xx - yy - zz; Q[1] = S(2.f) * (xy - wz);
      Q[2] = S(2.f) * (xz + wy);
      Q[3] = S(2.f) * (xy + wz); Q[4] = ww - xx + yy - zz;
      Q[5] = S(2.f) * (yz - wx);
      Q[6] = S(2.f) * (xz - wy); Q[7] = S(2.f) * (yz + wx);
      Q[8] = ww - xx - yy + zz;
      S t[3] = {s[Y.X + qs + 4], s[Y.X + qs + 5], s[Y.X + qs + 6]};
      for (int a = 0; a < 3; ++a) {
        for (int c = 0; c < 3; ++c)
          Rb[3 * a + c] = RJ[3 * a] * Q[c] + RJ[3 * a + 1] * Q[3 + c] +
                          RJ[3 * a + 2] * Q[6 + c];
        pb[a] = pJ[a] + (Rp[3 * a] * t[0] + Rp[3 * a + 1] * t[1] +
                         Rp[3 * a + 2] * t[2]);
      }
      for (int k = 0; k < 3; ++k)
        for (int a = 0; a < 3; ++a) {
          const S e = S(a == k ? 1.f : 0.f);
          s[Y.AX + 3 * (vs + k) + a] = e;
          s[Y.OR + 3 * (vs + k) + a] = pb[a];
          s[Y.AX + 3 * (vs + 3 + k) + a] = e;
          s[Y.OR + 3 * (vs + 3 + k) + a] = pb[a];
        }
    } else if (jt == J_REVOLUTE) {
      const S qa = s[Y.X + qs];
      const S sn = s_sin(qa), cs = s_cos(qa);
      const float* K = T.rot_K[b];
      const float* K2 = T.rot_K2[b];
      S rot[9];
      for (int k = 0; k < 9; ++k)
        rot[k] = S((k % 4 == 0) ? 1.f : 0.f) + sn * K[k] +
                 (S(1.f) - cs) * K2[k];
      for (int a = 0; a < 3; ++a) {
        for (int c = 0; c < 3; ++c)
          Rb[3 * a + c] = RJ[3 * a] * rot[c] + RJ[3 * a + 1] * rot[3 + c] +
                          RJ[3 * a + 2] * rot[6 + c];
        pb[a] = pJ[a];
      }
      const float* ax = T.axis[b];
      for (int a = 0; a < 3; ++a) {
        s[Y.AX + 3 * vs + a] =
            Rb[3 * a] * ax[0] + Rb[3 * a + 1] * ax[1] + Rb[3 * a + 2] * ax[2];
        s[Y.OR + 3 * vs + a] = pb[a];
      }
    } else if (jt == J_PRISMATIC) {
      const float* ax = T.axis[b];
      const S qa = s[Y.X + qs];
      for (int k = 0; k < 9; ++k) Rb[k] = RJ[k];
      for (int a = 0; a < 3; ++a) {
        const S axw =
            RJ[3 * a] * ax[0] + RJ[3 * a + 1] * ax[1] + RJ[3 * a + 2] * ax[2];
        pb[a] = pJ[a] + axw * qa;
        s[Y.AX + 3 * vs + a] = axw;
      }
      for (int a = 0; a < 3; ++a) s[Y.OR + 3 * vs + a] = pb[a];
    } else {  // J_FIXED
      for (int k = 0; k < 9; ++k) Rb[k] = RJ[k];
      for (int a = 0; a < 3; ++a) pb[a] = pJ[a];
    }
    for (int k = 0; k < 9; ++k) s[Y.R + 9 * b + k] = Rb[k];
    for (int a = 0; a < 3; ++a) s[Y.P + 3 * b + a] = pb[a];
  }
}

// Linear Jacobian column of dof k at world point pt:
// is_ang * axis x (pt - origin) + is_lin * axis (without the ancestor
// mask).
template <typename S>
__device__ inline void point_jac_col(const StepTable& T, const Layout& Y,
                                     const Lane<S>& s, int k, const S pt[3],
                                     S out[3]) {
  S ax[3], lev[3], c[3];
  load3(s, Y.AX + 3 * k, ax);
  for (int a = 0; a < 3; ++a) lev[a] = pt[a] - s[Y.OR + 3 * k + a];
  cross3(ax, lev, c);
  for (int a = 0; a < 3; ++a)
    out[a] = T.is_ang[k] * c[a] + T.is_lin[k] * ax[a];
}

// World com positions, world inertias I_w = R I R', and the mass matrix
// M = sum_b J_ang' I_w J_ang + m J_com' J_com + diag(armature).
template <typename S>
__device__ void mass_matrix(const StepTable& T, const Layout& Y,
                            const Lane<S>& s) {
  const int nv = T.nv;
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < nv; ++j)
      s[Y.M + i * nv + j] = S(i == j ? T.armature[i] : 0.f);
  for (int b = 0; b < T.nb; ++b) {
    S R[9], p[3];
    load9(s, Y.R + 9 * b, R);
    load3(s, Y.P + 3 * b, p);
    const float* cm = T.com[b];
    const float* I = T.inertia[b];
    S cw[3];
    for (int a = 0; a < 3; ++a)
      cw[a] = p[a] + (R[3 * a] * cm[0] + R[3 * a + 1] * cm[1] +
                      R[3 * a + 2] * cm[2]);
    S RI[9], Iw[9];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        RI[3 * a + c] = R[3 * a] * I[c] + R[3 * a + 1] * I[3 + c] +
                        R[3 * a + 2] * I[6 + c];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        Iw[3 * a + c] = RI[3 * a] * R[3 * c] + RI[3 * a + 1] * R[3 * c + 1] +
                        RI[3 * a + 2] * R[3 * c + 2];
    for (int a = 0; a < 3; ++a) s[Y.COMW + 3 * b + a] = cw[a];
    for (int k = 0; k < 9; ++k) s[Y.IW + 9 * b + k] = Iw[k];
    const float m = T.mass[b];
    for (int i = 0; i < nv; ++i) {
      if (T.anc[b][i] == 0.f) continue;
      S ai[3], li[3], Iai[3];
      load3(s, Y.AX + 3 * i, ai);
      for (int a = 0; a < 3; ++a) ai[a] = T.is_ang[i] * ai[a];
      point_jac_col(T, Y, s, i, cw, li);
      for (int a = 0; a < 3; ++a)
        Iai[a] = Iw[3 * a] * ai[0] + Iw[3 * a + 1] * ai[1] + Iw[3 * a + 2] * ai[2];
      for (int j = 0; j < nv; ++j) {
        if (T.anc[b][j] == 0.f) continue;
        S aj[3], lj[3];
        load3(s, Y.AX + 3 * j, aj);
        for (int a = 0; a < 3; ++a) aj[a] = T.is_ang[j] * aj[a];
        point_jac_col(T, Y, s, j, cw, lj);
        s[Y.M + j * nv + i] += (aj[0] * Iai[0] + aj[1] * Iai[1] + aj[2] * Iai[2]) +
                               m * (li[0] * lj[0] + li[1] * lj[1] + li[2] * lj[2]);
      }
    }
  }
}

// Velocity-product bias forces (qddot = 0) + damping, into TAU as
// tau = B u - bias.
template <typename S>
__device__ void bias_and_tau(const StepTable& T, const Layout& Y,
                             const Lane<S>& s) {
  const int nb = T.nb, nv = T.nv, nq = T.nq;
  const int V = Y.X + nq;
  // body angular velocities w_b = sum_k anc[b][k] is_ang_k axis_k v_k
  for (int b = 0; b < nb; ++b) {
    S w[3] = {S(0.f), S(0.f), S(0.f)};
    for (int k = 0; k < nv; ++k) {
      if (T.anc[b][k] == 0.f || T.is_ang[k] == 0.f) continue;
      const S vk = s[V + k];
      for (int a = 0; a < 3; ++a) w[a] += s[Y.AX + 3 * k + a] * vk;
    }
    for (int a = 0; a < 3; ++a) s[Y.W + 3 * b + a] = w[a];
  }
  // alpha terms v_k is_ang_k (w_parent x axis_k)
  for (int k = 0; k < nv; ++k) {
    S wp[3] = {S(0.f), S(0.f), S(0.f)};
    const int pb = T.dof_parent[k];
    if (pb >= 0) load3(s, Y.W + 3 * pb, wp);
    S ax[3], c[3];
    load3(s, Y.AX + 3 * k, ax);
    cross3(wp, ax, c);
    const S f = s[V + k] * T.is_ang[k];
    for (int a = 0; a < 3; ++a) s[Y.ALT + 3 * k + a] = f * c[a];
  }
  for (int b = 0; b < nb; ++b) {
    S al[3] = {S(0.f), S(0.f), S(0.f)};
    for (int k = 0; k < nv; ++k) {
      if (T.anc[b][k] == 0.f) continue;
      for (int a = 0; a < 3; ++a) al[a] += s[Y.ALT + 3 * k + a];
    }
    for (int a = 0; a < 3; ++a) s[Y.AL + 3 * b + a] = al[a];
  }
  // origin accelerations down the tree
  for (int b = 0; b < nb; ++b) {
    const int par = T.parent[b];
    S ao[3] = {S(0.f), S(0.f), S(0.f)};
    if (par >= 0) {
      S r[3], alp[3], wpar[3], c1[3], c2[3], c3[3];
      for (int a = 0; a < 3; ++a) r[a] = s[Y.P + 3 * b + a] - s[Y.P + 3 * par + a];
      load3(s, Y.AL + 3 * par, alp);
      load3(s, Y.W + 3 * par, wpar);
      cross3(alp, r, c1);
      cross3(wpar, r, c2);
      cross3(wpar, c2, c3);
      for (int a = 0; a < 3; ++a)
        ao[a] = s[Y.AO + 3 * par + a] + c1[a] + c3[a];
      if (T.jtype[b] == J_PRISMATIC) {
        const int vs = T.v_start[b];
        S axv[3], c4[3];
        for (int a = 0; a < 3; ++a) axv[a] = s[Y.AX + 3 * vs + a] * s[V + vs];
        cross3(wpar, axv, c4);
        for (int a = 0; a < 3; ++a) ao[a] = ao[a] + S(2.f) * c4[a];
      }
    }
    for (int a = 0; a < 3; ++a) s[Y.AO + 3 * b + a] = ao[a];
  }
  for (int k = 0; k < nv; ++k) s[Y.TMP + k] = T.damping[k] * s[V + k];
  // per-body force F and torque T, projected on the dofs
  for (int b = 0; b < nb; ++b) {
    S cw[3], p[3], w[3], al[3], Iw[9], c_w[3];
    load3(s, Y.COMW + 3 * b, cw);
    load3(s, Y.P + 3 * b, p);
    load3(s, Y.W + 3 * b, w);
    load3(s, Y.AL + 3 * b, al);
    load9(s, Y.IW + 9 * b, Iw);
    for (int a = 0; a < 3; ++a) c_w[a] = cw[a] - p[a];
    S c1[3], c2[3], c3[3], F[3], Tq[3], Iww[3], Ial[3], c4[3];
    cross3(al, c_w, c1);
    cross3(w, c_w, c2);
    cross3(w, c2, c3);
    const float m = T.mass[b];
    for (int a = 0; a < 3; ++a)
      F[a] = m * ((s[Y.AO + 3 * b + a] + c1[a] + c3[a]) - T.gravity[a]);
    for (int a = 0; a < 3; ++a) {
      Iww[a] = Iw[3 * a] * w[0] + Iw[3 * a + 1] * w[1] + Iw[3 * a + 2] * w[2];
      Ial[a] = Iw[3 * a] * al[0] + Iw[3 * a + 1] * al[1] + Iw[3 * a + 2] * al[2];
    }
    cross3(w, Iww, c4);
    for (int a = 0; a < 3; ++a) Tq[a] = Ial[a] + c4[a];
    for (int k = 0; k < nv; ++k) {
      if (T.anc[b][k] == 0.f) continue;
      S ax[3], lk[3];
      load3(s, Y.AX + 3 * k, ax);
      point_jac_col(T, Y, s, k, cw, lk);
      s[Y.TMP + k] += T.is_ang[k] * (ax[0] * Tq[0] + ax[1] * Tq[1] + ax[2] * Tq[2]) +
                      (lk[0] * F[0] + lk[1] * F[1] + lk[2] * F[2]);
    }
  }
  for (int k = 0; k < nv; ++k) s[Y.TAU + k] = -s[Y.TMP + k];
  for (int i = 0; i < T.nu; ++i)
    s[Y.TAU + T.act_vdof[i]] += s[Y.U + i];
}

// Unpivoted Cholesky solve M x = rhs (M at Y.M, factor into Y.LC):
// column-by-column Crout factor as the JAX solve_spd_T, then forward
// and back substitution.  rhs and x may alias.
template <typename S>
__device__ void chol_solve(const Layout& Y, const Lane<S>& s, int nv,
                           int rhs, int x) {
  for (int j = 0; j < nv; ++j) {
    for (int i = 0; i < nv; ++i) {
      S acc = S(0.f);
      for (int k = 0; k < j; ++k)
        acc += s[Y.LC + i * nv + k] * s[Y.LC + j * nv + k];
      s[Y.TMP + i] = s[Y.M + i * nv + j] - acc;
    }
    const S d = s_sqrt(s[Y.TMP + j]);
    for (int i = 0; i < nv; ++i)
      s[Y.LC + i * nv + j] = i >= j ? s[Y.TMP + i] / d : S(0.f);
  }
  for (int i = 0; i < nv; ++i) {
    S acc = s[rhs + i];
    for (int k = 0; k < i; ++k) acc = acc - s[Y.LC + i * nv + k] * s[Y.TMP + k];
    s[Y.TMP + i] = acc / s[Y.LC + i * nv + i];
  }
  for (int i = nv - 1; i >= 0; --i) {
    S acc = s[Y.TMP + i];
    for (int k = i + 1; k < nv; ++k) acc = acc - s[Y.LC + k * nv + i] * s[x + k];
    s[x + i] = acc / s[Y.LC + i * nv + i];
  }
}

// Unpivoted Gauss-Jordan on the augmented nv x (nv+1) matrix at Y.G;
// the solution goes to x.
template <typename S>
__device__ void gauss_jordan(const Layout& Y, const Lane<S>& s, int nv,
                             int x) {
  const int w = nv + 1;
  for (int k = 0; k < nv; ++k) {
    const S pivot = s[Y.G + k * w + k];
    for (int i = 0; i < nv; ++i) {
      if (i == k) continue;
      const S f = s[Y.G + i * w + k] / pivot;
      for (int j = 0; j < w; ++j)
        s[Y.G + i * w + j] = s[Y.G + i * w + j] - f * s[Y.G + k * w + j];
    }
  }
  for (int i = 0; i < nv; ++i)
    s[x + i] = s[Y.G + i * w + nv] / s[Y.G + i * w + i];
}

// ---------------------------------------------------------------------------
// contact
// ---------------------------------------------------------------------------

// World pose of box i (constant for a world box).
template <typename S>
__device__ void box_pose(const StepTable& T, const Layout& Y,
                         const Lane<S>& s, int i, S Rw[9], S pw[3]) {
  for (int k = 0; k < 9; ++k) Rw[k] = s[Y.BR + 9 * i + k];
  for (int a = 0; a < 3; ++a) pw[a] = s[Y.BP + 3 * i + a];
}

// Narrowphase and contact Jacobians: PHI, NRM, PNT, K1 and JC for every
// contact row, in the JAX row order (table c_* arrays).
template <typename S>
__device__ void contact_primal(const StepTable& T, const Layout& Y,
                               const Lane<S>& s) {
  const int nv = T.nv;
  for (int ci = 0; ci < T.ns; ++ci) {
    const int b = T.sph_body[ci];
    const float* off = T.sph_off[ci];
    for (int a = 0; a < 3; ++a)
      s[Y.CEN + 3 * ci + a] =
          s[Y.P + 3 * b + a] + (s[Y.R + 9 * b + 3 * a] * off[0] +
                                s[Y.R + 9 * b + 3 * a + 1] * off[1] +
                                s[Y.R + 9 * b + 3 * a + 2] * off[2]);
  }
  for (int i = 0; i < T.nbox; ++i) {
    const int bb = T.box_body[i];
    const float* br = T.box_rot[i];
    const float* bp = T.box_pos[i];
    if (bb < 0) {
      for (int k = 0; k < 9; ++k) s[Y.BR + 9 * i + k] = S(br[k]);
      for (int a = 0; a < 3; ++a) s[Y.BP + 3 * i + a] = S(bp[a]);
    } else {
      S Rb[9];
      load9(s, Y.R + 9 * bb, Rb);
      for (int a = 0; a < 3; ++a) {
        for (int c = 0; c < 3; ++c)
          s[Y.BR + 9 * i + 3 * a + c] = Rb[3 * a] * br[c] +
                                        Rb[3 * a + 1] * br[3 + c] +
                                        Rb[3 * a + 2] * br[6 + c];
        s[Y.BP + 3 * i + a] = s[Y.P + 3 * bb + a] +
                              (Rb[3 * a] * bp[0] + Rb[3 * a + 1] * bp[1] +
                               Rb[3 * a + 2] * bp[2]);
      }
    }
  }
  for (int c = 0; c < T.nc; ++c) {
    S phi, n[3], pt[3], k1 = S(0.f);
    const int kind = T.c_kind[c];
    if (kind == C_SH) {
      const int si = T.c_i0[c], hi = T.c_i1[c];
      S cen[3];
      load3(s, Y.CEN + 3 * si, cen);
      const float* nh = T.hs_n[hi];
      const S dist = (cen[0] * nh[0] + cen[1] * nh[1] + cen[2] * nh[2]) -
                     T.hs_off[hi];
      phi = T.sph_r[si] - dist;
      for (int a = 0; a < 3; ++a) {
        n[a] = S(nh[a]);
        pt[a] = cen[a] - (dist - 0.5f * phi) * nh[a];
      }
    } else if (kind == C_SB) {
      const int si = T.c_i0[c], bi = T.c_i1[c];
      S cen[3], Rw[9], pw[3];
      load3(s, Y.CEN + 3 * si, cen);
      box_pose(T, Y, s, bi, Rw, pw);
      S d0[3], loc[3], delta[3], gap[3];
      for (int a = 0; a < 3; ++a) d0[a] = cen[a] - pw[a];
      for (int j = 0; j < 3; ++j)
        loc[j] = Rw[j] * d0[0] + Rw[3 + j] * d0[1] + Rw[6 + j] * d0[2];
      const float* half = T.box_half[bi];
      for (int j = 0; j < 3; ++j) {
        // clip(x, -h, h) = min(max(x, -h), h)
        S cl = val(loc[j]) > -half[j] ? loc[j] : S(-half[j]);
        cl = val(cl) < half[j] ? cl : S(half[j]);
        delta[j] = loc[j] - cl;
        gap[j] = half[j] - s_abs(loc[j]);
      }
      const S dist_out =
          s_sqrt(delta[0] * delta[0] + delta[1] * delta[1] + delta[2] * delta[2]);
      S min_gap = gap[0];
      if (val(gap[1]) < val(min_gap)) min_gap = gap[1];
      if (val(gap[2]) < val(min_gap)) min_gap = gap[2];
      const bool inside = val(dist_out) < 1e-9f;
      // inner-face normal: one-hot of the minimum gap, ties broken
      // toward x, then y, then z
      const float m0 = val(gap[0]) <= val(min_gap) ? 1.f : 0.f;
      const float m1 = val(gap[1]) <= val(min_gap) ? 1.f : 0.f;
      const float m2 = val(gap[2]) <= val(min_gap) ? 1.f : 0.f;
      const float w0 = m0, w1 = m1 * (1.f - w0), w2 = m2 * (1.f - w0) * (1.f - w1);
      const float oh[3] = {w0, w1, w2};
      const S sgn = s_sign(val(oh[0] * loc[0] + oh[1] * loc[1] + oh[2] * loc[2]));
      const S dmax = val(dist_out) > 1e-9f ? dist_out : S(1e-9f);
      S nl[3];
      for (int j = 0; j < 3; ++j) nl[j] = inside ? oh[j] * sgn : delta[j] / dmax;
      const S sd = inside ? -min_gap : dist_out;
      phi = T.sph_r[si] - sd;
      for (int a = 0; a < 3; ++a) {
        n[a] = Rw[3 * a] * nl[0] + Rw[3 * a + 1] * nl[1] + Rw[3 * a + 2] * nl[2];
        pt[a] = cen[a] - (sd - 0.5f * phi) * n[a];
      }
    } else {  // C_BH: box face corner vs halfspace, linear law K1
      const int bi = T.c_i0[c], hi = T.c_i1[c], corner = T.c_corner[c];
      S Rw[9], pw[3];
      box_pose(T, Y, s, bi, Rw, pw);
      const float* nh = T.hs_n[hi];
      const float* half = T.box_half[bi];
      S nb_ax[3];
      for (int j = 0; j < 3; ++j)
        nb_ax[j] = s_abs(nh[0] * Rw[j] + nh[1] * Rw[3 + j] + nh[2] * Rw[6 + j]);
      const S a_proj = 4.f * (half[1] * half[2] * nb_ax[0] +
                              half[0] * half[2] * nb_ax[1] +
                              half[0] * half[1] * nb_ax[2]);
      k1 = T.c_g[c] * a_proj / 4.f;
      // corner signs in (x, y, z) binary order, x slowest: (-,-,-), (-,-,+)...
      const float sg[3] = {(corner & 4) ? 1.f : -1.f, (corner & 2) ? 1.f : -1.f,
                           (corner & 1) ? 1.f : -1.f};
      const float loc[3] = {sg[0] * half[0], sg[1] * half[1], sg[2] * half[2]};
      for (int a = 0; a < 3; ++a)
        pt[a] = pw[a] + (Rw[3 * a] * loc[0] + Rw[3 * a + 1] * loc[1] +
                         Rw[3 * a + 2] * loc[2]);
      phi = T.hs_off[hi] - (nh[0] * pt[0] + nh[1] * pt[1] + nh[2] * pt[2]);
      for (int a = 0; a < 3; ++a) n[a] = S(nh[a]);
    }
    s[Y.PHI + c] = phi;
    s[Y.K1 + c] = k1;
    for (int a = 0; a < 3; ++a) {
      s[Y.NRM + 3 * c + a] = n[a];
      s[Y.PNT + 3 * c + a] = pt[a];
    }
    // relative contact Jacobian: rows of body A minus rows of body B
    const int ba = T.c_body_a[c], bb = T.c_body_b[c];
    for (int k = 0; k < nv; ++k) {
      S ja[3] = {S(0.f), S(0.f), S(0.f)}, jb[3] = {S(0.f), S(0.f), S(0.f)};
      if (ba >= 0 && T.anc[ba][k] != 0.f) point_jac_col(T, Y, s, k, pt, ja);
      if (bb >= 0 && T.anc[bb][k] != 0.f) point_jac_col(T, Y, s, k, pt, jb);
      for (int a = 0; a < 3; ++a) s[Y.JC + (3 * c + a) * nv + k] = ja[a] - jb[a];
    }
  }
}

// Force at the implicitly predicted penetration phi - dt vn, and (when
// D is given) its Jacobian D = df/dv_rel (row-major 3x3).
template <typename S>
__device__ void contact_force_implicit(const StepTable& T, int c, S phi,
                                       const S n[3], const S vrel[3], S K1,
                                       float vs, S f[3], S* D) {
  const float w = T.smooth_width, dt = T.dt, sc = T.force_scale;
  const float K = T.c_K[c], d = T.c_d[c], mu = T.c_mu[c];
  const S vn = vrel[0] * n[0] + vrel[1] * n[1] + vrel[2] * n[2];
  const S z = (phi - dt * vn) / w;
  const S phi_s = softplus(z) * w;
  S fn0 = sc * K * phi_s * phi_s + K1 * phi_s;
  const S xx = S(1.f) - d * vn;
  const float eps = 1e-3f;
  const S rt = s_sqrt(xx * xx + eps * eps);
  const S hc = 0.5f * (xx + rt);
  const S fn = fn0 * hc;
  S vt[3];
  for (int a = 0; a < 3; ++a) vt[a] = vrel[a] - vn * n[a];
  const S sigma = s_sqrt(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2] + vs * vs);
  const S mu_over = mu * fn / sigma;
  for (int a = 0; a < 3; ++a) f[a] = fn * n[a] - mu_over * vt[a];
  if (D) {
    const S sig = sigmoid(z);
    const S dfn0 = 2.f * sc * K * phi_s + K1;
    const S dhc = 0.5f * (S(1.f) + xx / rt);
    const S bb = -(dfn0 * sig * dt * hc + fn0 * dhc * d);
    const S m2 = mu_over / (sigma * sigma);
    for (int a = 0; a < 3; ++a) {
      const S left = n[a] - mu * (vt[a] / sigma);
      for (int e = 0; e < 3; ++e) {
        const S P = S(a == e ? 1.f : 0.f) - n[a] * n[e];
        D[3 * a + e] = left * (bb * n[e]) - mu_over * P + m2 * (vt[a] * vt[e]);
      }
    }
  }
}

// Explicit force (contact_iters == 0) at the current penetration.
template <typename S>
__device__ void contact_force_explicit(const StepTable& T, int c, S phi,
                                       const S n[3], const S vrel[3], S K1,
                                       S f[3]) {
  const float w = T.smooth_width, vs = T.stiction_vel;
  const S phi_s = softplus(phi / w) * w;
  const S vn = vrel[0] * n[0] + vrel[1] * n[1] + vrel[2] * n[2];
  S fn = T.force_scale * T.c_K[c] * phi_s * phi_s + K1 * phi_s;
  const S x = S(1.f) - T.c_d[c] * vn;
  const float eps = 1e-3f;
  fn = fn * (0.5f * (x + s_sqrt(x * x + eps * eps)));
  S vt[3];
  for (int a = 0; a < 3; ++a) vt[a] = vrel[a] - vn * n[a];
  const S vt_norm = s_sqrt(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2] + vs * vs);
  const S r = T.c_mu[c] * fn / vt_norm;
  for (int a = 0; a < 3; ++a) f[a] = fn * n[a] - r * vt[a];
}

// Contact generalized force Jc' f(Jc vel) into TC; with G != nullptr also
// accumulates sum_c Jc' D Jc into the Newton matrix block (row stride
// nv + 1).  Returns nothing; implicit when implicit_vs > 0.
template <typename S>
__device__ void contact_tau(const StepTable& T, const Layout& Y,
                            const Lane<S>& s, int vel, bool implicit,
                            float vs, bool with_G) {
  const int nv = T.nv, w = nv + 1;
  for (int k = 0; k < nv; ++k) s[Y.TC + k] = S(0.f);
  if (with_G)
    for (int i = 0; i < nv; ++i)
      for (int j = 0; j < nv; ++j) s[Y.G + i * w + j] = S(0.f);
  for (int c = 0; c < T.nc; ++c) {
    S vrel[3], n[3], f[3], D[9];
    for (int a = 0; a < 3; ++a) {
      S acc = S(0.f);
      for (int k = 0; k < nv; ++k) acc += s[Y.JC + (3 * c + a) * nv + k] * s[vel + k];
      vrel[a] = acc;
    }
    load3(s, Y.NRM + 3 * c, n);
    const S phi = s[Y.PHI + c], k1 = s[Y.K1 + c];
    if (implicit)
      contact_force_implicit(T, c, phi, n, vrel, k1, vs, f, with_G ? D : nullptr);
    else
      contact_force_explicit(T, c, phi, n, vrel, k1, f);
    for (int k = 0; k < nv; ++k) {
      s[Y.TC + k] += s[Y.JC + (3 * c) * nv + k] * f[0] +
                     s[Y.JC + (3 * c + 1) * nv + k] * f[1] +
                     s[Y.JC + (3 * c + 2) * nv + k] * f[2];
    }
    if (with_G) {
      // E = D Jc (3 x nv), then G += Jc' E
      for (int a = 0; a < 3; ++a)
        for (int j = 0; j < nv; ++j)
          s[Y.EC + a * nv + j] = D[3 * a] * s[Y.JC + (3 * c) * nv + j] +
                                 D[3 * a + 1] * s[Y.JC + (3 * c + 1) * nv + j] +
                                 D[3 * a + 2] * s[Y.JC + (3 * c + 2) * nv + j];
      for (int i = 0; i < nv; ++i) {
        const S j0 = s[Y.JC + (3 * c) * nv + i], j1 = s[Y.JC + (3 * c + 1) * nv + i],
                j2 = s[Y.JC + (3 * c + 2) * nv + i];
        if (val(j0) == 0.f && val(j1) == 0.f && val(j2) == 0.f) continue;
        for (int j = 0; j < nv; ++j)
          s[Y.G + i * w + j] += j0 * s[Y.EC + j] + j1 * s[Y.EC + nv + j] +
                                j2 * s[Y.EC + 2 * nv + j];
      }
    }
  }
}

// Implicit residual res = M (vp - v) - dt (tau + Jc' f(Jc vp)) into out;
// returns |res|^2.  With with_G, also leaves G = M - dt Jc' D Jc with
// res in its last column.
template <typename S>
__device__ S residual(const StepTable& T, const Layout& Y, const Lane<S>& s,
                      int vp, float vs, bool with_G, int out) {
  const int nv = T.nv, w = nv + 1;
  const int V = Y.X + T.nq;
  contact_tau(T, Y, s, vp, true, vs, with_G);
  S sq = S(0.f);
  for (int i = 0; i < nv; ++i) {
    S acc = S(0.f);
    for (int j = 0; j < nv; ++j) acc += s[Y.M + i * nv + j] * (s[vp + j] - s[V + j]);
    const S r = acc - T.dt * (s[Y.TAU + i] + s[Y.TC + i]);
    s[out + i] = r;
    sq += r * r;
  }
  if (with_G) {
    for (int i = 0; i < nv; ++i) {
      for (int j = 0; j < nv; ++j)
        s[Y.G + i * w + j] = s[Y.M + i * nv + j] - T.dt * s[Y.G + i * w + j];
      s[Y.G + i * w + nv] = s[out + i];
    }
  }
  return sq;
}

// q' = q (+) dt v' into XN (quaternion renormalized every step).
template <typename S>
__device__ void integrate(const StepTable& T, const Layout& Y,
                          const Lane<S>& s, int vnext) {
  const float dt = T.dt;
  for (int b = 0; b < T.nb; ++b) {
    const int jt = T.jtype[b], qs = T.q_start[b], vs = T.v_start[b];
    if (jt == J_FREE) {
      const S qw = s[Y.X + qs], qx = s[Y.X + qs + 1], qy = s[Y.X + qs + 2],
              qz = s[Y.X + qs + 3];
      const S wx = s[vnext + vs], wy = s[vnext + vs + 1], wz = s[vnext + vs + 2];
      // 0.5 * (0, w) (x) q
      S qd[4];
      qd[0] = S(0.f) * qw - wx * qx - wy * qy - wz * qz;
      qd[1] = S(0.f) * qx + wx * qw + wy * qz - wz * qy;
      qd[2] = S(0.f) * qy - wx * qz + wy * qw + wz * qx;
      qd[3] = S(0.f) * qz + wx * qy - wy * qx + wz * qw;
      S qn[4] = {qw + dt * (0.5f * qd[0]), qx + dt * (0.5f * qd[1]),
                 qy + dt * (0.5f * qd[2]), qz + dt * (0.5f * qd[3])};
      const S nrm = s_sqrt(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
      for (int k = 0; k < 4; ++k) s[Y.XN + qs + k] = qn[k] / nrm;
      for (int a = 0; a < 3; ++a)
        s[Y.XN + qs + 4 + a] = s[Y.X + qs + 4 + a] + dt * s[vnext + vs + 3 + a];
    } else if (jt == J_REVOLUTE || jt == J_PRISMATIC) {
      s[Y.XN + qs] = s[Y.X + qs] + dt * s[vnext + vs];
    }
  }
  for (int k = 0; k < T.nv; ++k) s[Y.XN + T.nq + k] = s[vnext + k];
}

// The step: state at Y.X (q then v), input at Y.U -> next state at Y.XN.
template <typename S>
__device__ void lane_step(const StepTable& T, const Layout& Y,
                          const Lane<S>& s) {
  const int nv = T.nv;
  const int V = Y.X + T.nq;
  const float dt = T.dt;
  fk(T, Y, s);
  mass_matrix(T, Y, s);
  bias_and_tau(T, Y, s);
  // contact-free predictor v + dt M^-1 tau (into VP)
  chol_solve(Y, s, nv, Y.TAU, Y.VP);
  for (int k = 0; k < nv; ++k) s[Y.VP + k] = s[V + k] + dt * s[Y.VP + k];
  if (T.has_contact) {
    contact_primal(T, Y, s);
    if (T.contact_iters == 0) {
      contact_tau(T, Y, s, V, false, 0.f, false);
      for (int k = 0; k < nv; ++k) s[Y.TC + k] = s[Y.TAU + k] + s[Y.TC + k];
      chol_solve(Y, s, nv, Y.TC, Y.VP);
      for (int k = 0; k < nv; ++k) s[Y.VP + k] = s[V + k] + dt * s[Y.VP + k];
    } else {
      // stiction continuation + damped Newton: per lane, a half step
      // when the full step's residual grew (impact overshoot)
      for (int it = 0; it < T.contact_iters; ++it) {
        const float vs = T.sched[it];
        const S r0 = residual(T, Y, s, Y.VP, vs, true, Y.RES);
        gauss_jordan(Y, s, nv, Y.DV);
        for (int k = 0; k < nv; ++k) s[Y.VP1 + k] = s[Y.VP + k] - s[Y.DV + k];
        const S r1 = residual(T, Y, s, Y.VP1, vs, false, Y.R1);
        const bool grew = val(r1) > 4.f * val(r0);
        for (int k = 0; k < nv; ++k)
          s[Y.VP + k] = grew ? s[Y.VP + k] - 0.5f * s[Y.DV + k] : s[Y.VP1 + k];
      }
    }
  }
  integrate(T, Y, s, Y.VP);
}

// Threads per block for L lanes: as few as spread the lanes over every
// SM.  A lane's step is one long dependent chain, so time is set by that
// chain, not by how many lanes share an SM; fewer lanes per SM keep their
// scratch (about 12 KB a lane at the flagship sizes) inside the SM's L1.
inline int ddp_block_threads(int L) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int t = (L + sms - 1) / sms;
  return t < 1 ? 1 : (t > 32 ? 32 : t);
}

// Host-side size queries shared by both kernel libraries.
extern "C" int ddp_table_bytes() { return (int)sizeof(StepTable); }

extern "C" int ddp_scratch_per_lane(int nb, int nq, int nv, int nu, int nc,
                                    int ns, int nbox) {
  return make_layout(nb, nq, nv, nu, nc, ns, nbox).total;
}
