// One lane of the multibody contact step, as a CUDA device function.
//
// The device step that megastep.cu and megaroll.cu run: the counterpart
// of the step body that the JAX package's Pallas kernels trace from
// drake_ddp_tpu/multibody/lanestep.py (make_lane_step), and of the plain
// PyTorch step drake_ddp_tpu_torch/multibody/lanestep.py, which it
// follows operation for operation: forward kinematics, world inertias
// and mass matrix, velocity-product bias forces, narrowphase (sphere-
// halfspace, sphere-box, sphere-sphere, sphere-world-sphere, and the
// box-face corner quadrature against a halfspace or a body sphere),
// contact Jacobians, the
// stiction-continuation damped Newton solve of the implicit contact
// velocity with its unpivoted Cholesky predictor and unpivoted
// Gauss-Jordan steps, and the position integration with quaternion
// renormalization.
//
// Design.  A team of threads runs one lane (one scenario x candidate).
// The step is a long chain of small dependent phases (about 0.2 Mop per
// lane-step at the flagship sizes, most of it in the Newton matrix and
// its 18 x 19 Gauss-Jordan), and a flagship rollout has only 512 lanes,
// about 4 per SM: one thread per lane left each SM one warp with 4 live
// threads, every operation waiting on a memory round trip.  So each
// phase runs in parallel over its outputs (bodies, dofs, contacts,
// matrix entries) across the team, and the team syncs between phases.
// Every sum stays in one thread, in the order of the per-thread loop, so
// a team computes the per-thread step's arithmetic up to FMA
// contraction.  Chains that cannot be split (the triangular solves, the
// |res|^2 sums that the damped-Newton test compares) run on the team's
// first thread.  Branches on lane data (the Newton half step) are
// uniform within a team.  The team of one runs the same loops, which are
// then the per-thread step; only contact_tau, whose team schedule would
// make one thread store and reload every contact's force, keeps a
// per-thread order of its own.
//
// A team is a type: Solo (one thread; every loop below is the plain
// per-thread loop and sync() is nothing) or Team<N> (N = 32: one warp,
// __syncwarp; N = 64 or 128: several warps of one block, a named barrier
// per lane).  The working set is a view: Local (contiguous, in shared
// memory, with the table copied there: megaroll, megastep and megajac's
// float64 primal) or dual.cuh's TangentView (megajac's tangent passes:
// primal values read from the primal's store, tangents in the thread's
// own global scratch).  The step is a template over the scalar type S
// too, so that the Jacobian kernel (megajac.cu) runs the same code on the
// forward-mode dual number of dual.cuh: S needs + - * /, the s_* math
// functions below and val() for comparisons.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DDP_MAX_BODIES 32
#define DDP_MAX_Q 40
#define DDP_MAX_V 32
#define DDP_MAX_U 32
#define DDP_MAX_CONTACTS 160
#define DDP_MAX_SPHERES 64
#define DDP_MAX_BOXES 8
#define DDP_MAX_HALFSPACES 4
#define DDP_MAX_WORLD_SPHERES 8
#define DDP_MAX_ITERS 16

enum { J_FREE = 0, J_REVOLUTE = 1, J_PRISMATIC = 2, J_FIXED = 3 };
// contact row kinds: sphere-halfspace, sphere-box, box face corner vs
// halfspace, sphere-sphere (both on bodies), body sphere vs world
// sphere, box face corner vs body sphere
enum { C_SH = 0, C_SB = 1, C_BH = 2, C_SS = 3, C_SW = 4, C_BS = 5 };

// The packed model + contact + solver table.  Only 4-byte fields, ints
// first, so the layout has no padding; ops/_table.py mirrors it with a
// ctypes.Structure and checks sizeof against ddp_table_bytes().
struct StepTable {
  int32_t nb, nq, nv, nu, nc, ns, nbox, nh, nws, contact_iters, has_contact;
  int32_t nlevels;                   // depths of the kinematic tree
  int32_t parent[DDP_MAX_BODIES];
  int32_t jtype[DDP_MAX_BODIES];
  int32_t q_start[DDP_MAX_BODIES];
  int32_t v_start[DDP_MAX_BODIES];
  // bodies by depth: those of depth d are level_body[level_start[d] ..
  // level_start[d + 1])
  int32_t level_start[DDP_MAX_BODIES + 1];
  int32_t level_body[DDP_MAX_BODIES];
  int32_t act_vdof[DDP_MAX_U];
  int32_t dof_parent[DDP_MAX_V];   // parent body of the dof's body, -1 world
  int32_t sph_body[DDP_MAX_SPHERES];
  int32_t box_body[DDP_MAX_BOXES];
  int32_t c_kind[DDP_MAX_CONTACTS];
  // c_i0: sphere (SH, SB, SS, SW) or box (BH, BS); c_i1: halfspace (SH,
  // BH), box (SB), sphere (SS, BS) or world sphere (SW)
  int32_t c_i0[DDP_MAX_CONTACTS];
  int32_t c_i1[DDP_MAX_CONTACTS];
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
  float ws_pos[DDP_MAX_WORLD_SPHERES][3];
  float ws_r[DDP_MAX_WORLD_SPHERES];
  float c_K[DDP_MAX_CONTACTS];
  float c_d[DDP_MAX_CONTACTS];
  float c_mu[DDP_MAX_CONTACTS];
  float c_g[DDP_MAX_CONTACTS];       // box-face pressure gradient (BH, BS)
};

// Offsets of the per-lane working-set fields, in scalars.
struct Layout {
  int R, P, AX, OR, COMW, IW, W, AL, ALT, AO, FB, TB, M, LC, X, U, XN, TAU,
      TMP, VP, DV, RES, R1, VP1, TC, G, SQ, JC, PHI, NRM, PNT, K1, FC,
      DC, EC, CEN, BR, BP, VC, TAN, total;
};

// The working set of one lane: a team step holds all of it in shared
// memory (megaroll, megastep, megajac's primal).  The order serves
// megajac's tangent passes (one thread, dual.cuh's TangentView), which
// keep only the tangents of the fields below TAN: first what is constant
// in v (kinematics, mass matrix, contact geometry: below VC, a velocity
// direction reads a zero tangent there), then the rest of what a
// tangent pass writes, then what only a primal needs (the Cholesky
// factor, the Newton matrix, the Newton's own vectors, every contact's
// f, D and D Jc).  Every field has its own room: a tangent pass reads
// the primal values of the bias's per-body force and torque, which the
// cold primal's Cholesky would otherwise overwrite.
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
  y.M = o; o += nv * nv;
  y.JC = o; o += nc * 3 * nv;
  y.PHI = o; o += nc;
  y.NRM = o; o += 3 * nc;
  y.PNT = o; o += 3 * nc;
  y.K1 = o; o += nc;
  y.CEN = o; o += 3 * ns;
  y.BR = o; o += 9 * nbox;
  y.BP = o; o += 3 * nbox;
  y.VC = o;
  y.W = o; o += 3 * nb;
  y.AL = o; o += 3 * nb;
  y.ALT = o; o += 3 * nv;
  y.AO = o; o += 3 * nb;
  y.FB = o; o += 3 * nb;
  y.TB = o; o += 3 * nb;
  y.X = o; o += nq + nv;
  y.U = o; o += nu;
  y.XN = o; o += nq + nv;
  y.TAU = o; o += nv;
  y.TMP = o; o += nv;
  y.VP = o; o += nv;
  y.RES = o; o += nv;
  y.TC = o; o += nv;
  y.SQ = o; o += 1;             // |res|^2 of the last residual
  y.TAN = o;
  y.LC = o; o += nv * nv;       // the Cholesky factor
  y.DV = o; o += nv;
  y.R1 = o; o += nv;
  y.VP1 = o; o += nv;
  y.G = o; o += nv * (nv + 1);
  y.FC = o; o += 3 * nc;        // contact forces f
  y.DC = o; o += 9 * nc;        // and their Jacobians D = df/dv_rel
  y.EC = o; o += nc * 3 * nv;   // D Jc, per contact
  y.total = o;
  return y;
}

__host__ __device__ inline Layout make_layout(const StepTable& T) {
  return make_layout(T.nb, T.nq, T.nv, T.nu, T.nc, T.ns, T.nbox);
}

// ---------------------------------------------------------------------------
// teams and working-set views
// ---------------------------------------------------------------------------

// Phases of the step (and of megaroll's time loop) that a clocking team
// type times through lap(): megaroll_clocks.cu.  The kernels' own teams
// do nothing there.
enum StepPhase {
  PH_TAPE, PH_POLICY, PH_FK, PH_MASS, PH_BIAS, PH_PREDICTOR, PH_CONTACT,
  PH_RESIDUAL_G, PH_GAUSS_JORDAN, PH_RESIDUAL, PH_NEWTON_STEP, PH_INTEGRATE,
  PH_OUT, PH_COUNT
};

// The team of one: the per-thread step.
struct Solo {
  static constexpr int size = 1;
  __device__ static constexpr int rank() { return 0; }
  __device__ static void sync() {}
  __device__ static void lap(int) {}
};

// N threads on one lane: one warp (N = 32), or N / 32 warps of one block
// that sync on the named barrier `bar` (1..15; 0 is __syncthreads').
template <int N>
struct Team {
  static_assert(N == 32 || N == 64 || N == 128, "a team is 32, 64 or 128");
  static constexpr int size = N;
  int r, bar;
  __device__ Team(int rank, int barrier) : r(rank), bar(barrier) {}
  __device__ int rank() const { return r; }
  __device__ void lap(int) const {}
  __device__ void sync() const {
    if (N == 32)
      __syncwarp();
    else
      asm volatile("barrier.sync %0, %1;" ::"r"(bar), "r"(N) : "memory");
  }
};

// Contiguous view: element i at p[i].
template <typename S>
struct Local {
  using scalar = S;
  S* p;
  __device__ S& operator[](int i) const { return p[i]; }
};

// Scalar math for S = float and S = double.  A dual type provides the
// same overloads.  Accurate libdevice versions: the kernels are built
// without fast math, because stiff contact amplifies rounding.
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
__device__ inline double val(double x) { return x; }
__device__ inline double s_sqrt(double x) { return sqrt(x); }
__device__ inline double s_exp(double x) { return exp(x); }
__device__ inline double s_log1p(double x) { return log1p(x); }
__device__ inline double s_sin(double x) { return sin(x); }
__device__ inline double s_cos(double x) { return cos(x); }
__device__ inline double s_abs(double x) { return fabs(x); }
__device__ inline double s_sign(double x) {
  return x > 0. ? 1. : (x < 0. ? -1. : 0.);
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

template <class W>
__device__ inline void load3(const W& s, int off, typename W::scalar v[3]) {
  v[0] = s[off]; v[1] = s[off + 1]; v[2] = s[off + 2];
}

template <class W>
__device__ inline void load9(const W& s, int off, typename W::scalar v[9]) {
  for (int k = 0; k < 9; ++k) v[k] = s[off + k];
}

// Items i = rank, rank + size, ... below n: the team's share of a
// parallel phase.
#define TEAM_FOR(i, n) \
  for (int i = tm.rank(); i < (n); i += Tm::size)

// The team's share of an na x nb grid of items (a, b) in row-major
// order, t = a nb + b for t = rank, rank + size, ...: one division at
// the start (none for Solo), none per item.
__device__ inline void grid_next(int& a, int& b, int nb, int step) {
  b += step;
  while (b >= nb) {
    b -= nb;
    ++a;
  }
}

#define TEAM_FOR2(a, b, na, nb)                                  \
  for (int a = tm.rank() / (nb), b = tm.rank() % (nb); a < (na); \
       grid_next(a, b, (nb), Tm::size))

// row[j] -= f * piv[j] for j < n, a few loads ahead of their stores
// (the view's accesses may alias, so the compiler keeps their order).
template <class W>
__device__ inline void row_axpy(const W& s, int row, int piv,
                                typename W::scalar f, int n) {
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    const typename W::scalar a0 = s[row + j], a1 = s[row + j + 1],
                             a2 = s[row + j + 2], a3 = s[row + j + 3];
    const typename W::scalar b0 = s[piv + j], b1 = s[piv + j + 1],
                             b2 = s[piv + j + 2], b3 = s[piv + j + 3];
    s[row + j] = a0 - f * b0;
    s[row + j + 1] = a1 - f * b1;
    s[row + j + 2] = a2 - f * b2;
    s[row + j + 3] = a3 - f * b3;
  }
  for (; j < n; ++j) s[row + j] = s[row + j] - f * s[piv + j];
}

// ---------------------------------------------------------------------------
// kinematics and dynamics terms
// ---------------------------------------------------------------------------

// Pose R, p of body b from its parent's, and the world axis / origin of
// its velocity dofs.
template <class W>
__device__ void fk_body(const StepTable& T, const Layout& Y, const W& s,
                        int b) {
  using S = typename W::scalar;
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

// Body poses R (nb x 3x3), p (nb x 3), and the world axis / origin of
// every velocity dof: down the tree, the bodies of one depth in parallel.
template <class Tm, class W>
__device__ void fk(const Tm& tm, const StepTable& T, const Layout& Y,
                   const W& s) {
  for (int d = 0; d < T.nlevels; ++d) {
    const int k0 = T.level_start[d];
    TEAM_FOR(k, T.level_start[d + 1] - k0)
      fk_body(T, Y, s, T.level_body[k0 + k]);
    tm.sync();
  }
}

// Linear Jacobian column of dof k at world point pt:
// is_ang * axis x (pt - origin) + is_lin * axis (without the ancestor
// mask).
template <class W>
__device__ inline void point_jac_col(const StepTable& T, const Layout& Y,
                                     const W& s, int k,
                                     const typename W::scalar pt[3],
                                     typename W::scalar out[3]) {
  using S = typename W::scalar;
  S ax[3], lev[3], c[3];
  load3(s, Y.AX + 3 * k, ax);
  for (int a = 0; a < 3; ++a) lev[a] = pt[a] - s[Y.OR + 3 * k + a];
  cross3(ax, lev, c);
  for (int a = 0; a < 3; ++a)
    out[a] = T.is_ang[k] * c[a] + T.is_lin[k] * ax[a];
}

// World com positions, world inertias I_w = R I R', and the mass matrix
// M = sum_b J_ang' I_w J_ang + m J_com' J_com + diag(armature).
template <class Tm, class W>
__device__ void mass_matrix(const Tm& tm, const StepTable& T,
                            const Layout& Y, const W& s) {
  using S = typename W::scalar;
  const int nv = T.nv;
  TEAM_FOR(b, T.nb) {
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
  }
  // item (g, i): column i of M, rows j of column group g (as many groups
  // as keep the team busy; one for Solo), summed over the bodies in order
  const int ng = Tm::size > nv ? Tm::size / nv : 1;
  const int chunk = (nv + ng - 1) / ng;
  TEAM_FOR2(g, i, ng, nv) {
    const int j0 = g * chunk, j1 = j0 + chunk < nv ? j0 + chunk : nv;
    for (int j = j0; j < j1; ++j)
      s[Y.M + j * nv + i] = S(i == j ? T.armature[i] : 0.f);
  }
  tm.sync();
  for (int b = 0; b < T.nb; ++b) {
    S cw[3], Iw[9];
    bool have = false;
    const float m = T.mass[b];
    TEAM_FOR2(g, i, ng, nv) {
      const int j0 = g * chunk, j1 = j0 + chunk < nv ? j0 + chunk : nv;
      if (T.anc[b][i] == 0.f) continue;
      if (!have) {
        load3(s, Y.COMW + 3 * b, cw);
        load9(s, Y.IW + 9 * b, Iw);
        have = true;
      }
      S ai[3], li[3], Iai[3];
      load3(s, Y.AX + 3 * i, ai);
      for (int a = 0; a < 3; ++a) ai[a] = T.is_ang[i] * ai[a];
      point_jac_col(T, Y, s, i, cw, li);
      for (int a = 0; a < 3; ++a)
        Iai[a] = Iw[3 * a] * ai[0] + Iw[3 * a + 1] * ai[1] + Iw[3 * a + 2] * ai[2];
      for (int j = j0; j < j1; ++j) {
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
  tm.sync();
}

// Velocity-product bias forces (qddot = 0) + damping, into TAU as
// tau = B u - bias.
template <class Tm, class W>
__device__ void bias_and_tau(const Tm& tm, const StepTable& T,
                             const Layout& Y, const W& s) {
  using S = typename W::scalar;
  const int nb = T.nb, nv = T.nv, nq = T.nq;
  const int V = Y.X + nq;
  // body angular velocities w_b = sum_k anc[b][k] is_ang_k axis_k v_k
  TEAM_FOR(b, nb) {
    S w[3] = {S(0.f), S(0.f), S(0.f)};
    for (int k = 0; k < nv; ++k) {
      if (T.anc[b][k] == 0.f || T.is_ang[k] == 0.f) continue;
      const S vk = s[V + k];
      for (int a = 0; a < 3; ++a) w[a] += s[Y.AX + 3 * k + a] * vk;
    }
    for (int a = 0; a < 3; ++a) s[Y.W + 3 * b + a] = w[a];
  }
  tm.sync();
  // alpha terms v_k is_ang_k (w_parent x axis_k)
  TEAM_FOR(k, nv) {
    S wp[3] = {S(0.f), S(0.f), S(0.f)};
    const int pb = T.dof_parent[k];
    if (pb >= 0) load3(s, Y.W + 3 * pb, wp);
    S ax[3], c[3];
    load3(s, Y.AX + 3 * k, ax);
    cross3(wp, ax, c);
    const S f = s[V + k] * T.is_ang[k];
    for (int a = 0; a < 3; ++a) s[Y.ALT + 3 * k + a] = f * c[a];
  }
  tm.sync();
  TEAM_FOR(b, nb) {
    S al[3] = {S(0.f), S(0.f), S(0.f)};
    for (int k = 0; k < nv; ++k) {
      if (T.anc[b][k] == 0.f) continue;
      for (int a = 0; a < 3; ++a) al[a] += s[Y.ALT + 3 * k + a];
    }
    for (int a = 0; a < 3; ++a) s[Y.AL + 3 * b + a] = al[a];
  }
  tm.sync();
  // origin accelerations down the tree, one depth at a time
  for (int d = 0; d < T.nlevels; ++d) {
    const int k0 = T.level_start[d];
    TEAM_FOR(k, T.level_start[d + 1] - k0) {
      const int b = T.level_body[k0 + k];
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
    tm.sync();
  }
  // per-body force F and torque T
  TEAM_FOR(b, nb) {
    S cw[3], p[3], w[3], al[3], Iw[9], c_w[3];
    load3(s, Y.COMW + 3 * b, cw);
    load3(s, Y.P + 3 * b, p);
    load3(s, Y.W + 3 * b, w);
    load3(s, Y.AL + 3 * b, al);
    load9(s, Y.IW + 9 * b, Iw);
    for (int a = 0; a < 3; ++a) c_w[a] = cw[a] - p[a];
    S c1[3], c2[3], c3[3], Iww[3], Ial[3], c4[3];
    cross3(al, c_w, c1);
    cross3(w, c_w, c2);
    cross3(w, c2, c3);
    const float m = T.mass[b];
    for (int a = 0; a < 3; ++a)
      s[Y.FB + 3 * b + a] =
          m * ((s[Y.AO + 3 * b + a] + c1[a] + c3[a]) - T.gravity[a]);
    for (int a = 0; a < 3; ++a) {
      Iww[a] = Iw[3 * a] * w[0] + Iw[3 * a + 1] * w[1] + Iw[3 * a + 2] * w[2];
      Ial[a] = Iw[3 * a] * al[0] + Iw[3 * a + 1] * al[1] + Iw[3 * a + 2] * al[2];
    }
    cross3(w, Iww, c4);
    for (int a = 0; a < 3; ++a) s[Y.TB + 3 * b + a] = Ial[a] + c4[a];
  }
  TEAM_FOR(k, nv) s[Y.TMP + k] = T.damping[k] * s[V + k];
  tm.sync();
  // projected on the dofs, in body order
  for (int b = 0; b < nb; ++b) {
    S cw[3], F[3], Tq[3];
    bool have = false;
    TEAM_FOR(k, nv) {
      if (T.anc[b][k] == 0.f) continue;
      if (!have) {
        load3(s, Y.COMW + 3 * b, cw);
        load3(s, Y.FB + 3 * b, F);
        load3(s, Y.TB + 3 * b, Tq);
        have = true;
      }
      S ax[3], lk[3];
      load3(s, Y.AX + 3 * k, ax);
      point_jac_col(T, Y, s, k, cw, lk);
      s[Y.TMP + k] += T.is_ang[k] * (ax[0] * Tq[0] + ax[1] * Tq[1] + ax[2] * Tq[2]) +
                      (lk[0] * F[0] + lk[1] * F[1] + lk[2] * F[2]);
    }
  }
  TEAM_FOR(k, nv) {
    S t = -s[Y.TMP + k];
    for (int i = 0; i < T.nu; ++i)
      if (T.act_vdof[i] == k) t += s[Y.U + i];
    s[Y.TAU + k] = t;
  }
  tm.sync();
}

// Unpivoted Cholesky solve M x = rhs (M at Y.M, factor into Y.LC):
// column-by-column Crout factor as the JAX solve_spd_T (the rows of a
// column in parallel), then forward and back substitution on the team's
// first thread.  rhs and x may alias.
template <class Tm, class W>
__device__ void chol_solve(const Tm& tm, const Layout& Y, const W& s, int nv,
                           int rhs, int x) {
  using S = typename W::scalar;
  for (int j = 0; j < nv; ++j) {
    TEAM_FOR(r, nv - j) {
      const int i = j + r;
      S acc = S(0.f);
      for (int k = 0; k < j; ++k)
        acc += s[Y.LC + i * nv + k] * s[Y.LC + j * nv + k];
      s[Y.TMP + i] = s[Y.M + i * nv + j] - acc;
    }
    tm.sync();
    const S d = s_sqrt(s[Y.TMP + j]);
    TEAM_FOR(i, nv)
      s[Y.LC + i * nv + j] = i >= j ? s[Y.TMP + i] / d : S(0.f);
    tm.sync();
  }
  if (tm.rank() == 0) {
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
  tm.sync();
}

// Unpivoted Gauss-Jordan on the augmented nv x (nv+1) matrix at Y.G;
// the solution goes to x.  Per pivot the rows update in parallel, each
// by its own thread (which alone reads its factor's column entry), so
// one sync per pivot suffices.
template <class Tm, class W>
__device__ void gauss_jordan(const Tm& tm, const Layout& Y, const W& s,
                             int nv, int x) {
  using S = typename W::scalar;
  const int w = nv + 1;
  for (int k = 0; k < nv; ++k) {
    const S pivot = s[Y.G + k * w + k];
    TEAM_FOR(i, nv) {
      if (i == k) continue;
      row_axpy(s, Y.G + i * w, Y.G + k * w, s[Y.G + i * w + k] / pivot, w);
    }
    tm.sync();
  }
  TEAM_FOR(i, nv) s[x + i] = s[Y.G + i * w + nv] / s[Y.G + i * w + i];
  tm.sync();
}

// Unpivoted Gauss-Jordan inverse of the nv x nv block at Y.G (row stride
// nv + 1), as lanejac.inv_small_T: eliminate on [G | I], then divide each
// row of the right half by its diagonal.  The right half lives in `inv`
// at `inv` of the working set (element (i, j) at inv + i nv + j); G is
// overwritten.  The pivot row is skipped, as the reference updates it
// with a zero factor.  As gauss_jordan: per pivot each row by its own
// thread, one sync per pivot.  megajac's primal runs it.
template <class Tm, class W>
__device__ void gauss_jordan_inverse(const Tm& tm, const Layout& Y,
                                     const W& s, int nv, int inv) {
  using S = typename W::scalar;
  const int w = nv + 1;
  TEAM_FOR2(i, j, nv, nv) s[inv + i * nv + j] = S(i == j ? 1.f : 0.f);
  tm.sync();
  for (int k = 0; k < nv; ++k) {
    const S pivot = s[Y.G + k * w + k];
    TEAM_FOR(i, nv) {
      if (i == k) continue;
      const S f = s[Y.G + i * w + k] / pivot;
      row_axpy(s, Y.G + i * w, Y.G + k * w, f, nv);
      row_axpy(s, inv + i * nv, inv + k * nv, f, nv);
    }
    tm.sync();
  }
  TEAM_FOR2(i, j, nv, nv)
    s[inv + i * nv + j] = s[inv + i * nv + j] / s[Y.G + i * w + i];
  tm.sync();
}

// ---------------------------------------------------------------------------
// contact
// ---------------------------------------------------------------------------

// World pose of box i (constant for a world box).
template <class W>
__device__ void box_pose(const Layout& Y, const W& s, int i,
                         typename W::scalar Rw[9], typename W::scalar pw[3]) {
  for (int k = 0; k < 9; ++k) Rw[k] = s[Y.BR + 9 * i + k];
  for (int a = 0; a < 3; ++a) pw[a] = s[Y.BP + 3 * i + a];
}

// Corner `corner` of box bi at the pose (Rw, pw) into pt, and the box's
// silhouette area projected along nvec: the corner quadrature of the
// box-face law, whose linear stiffness is K1 = g A_proj / 4 per corner
// (BH against a halfspace, BS against a body sphere).
template <typename S, typename N>
__device__ inline S box_corner(const StepTable& T, int bi, int corner,
                               const S Rw[9], const S pw[3], const N nvec[3],
                               S pt[3]) {
  const float* half = T.box_half[bi];
  S nb_ax[3];
  for (int j = 0; j < 3; ++j)
    nb_ax[j] =
        s_abs(nvec[0] * Rw[j] + nvec[1] * Rw[3 + j] + nvec[2] * Rw[6 + j]);
  const S a_proj = 4.f * (half[1] * half[2] * nb_ax[0] +
                          half[0] * half[2] * nb_ax[1] +
                          half[0] * half[1] * nb_ax[2]);
  // corner signs in (x, y, z) binary order, x slowest: (-,-,-), (-,-,+)...
  const float sg[3] = {(corner & 4) ? 1.f : -1.f, (corner & 2) ? 1.f : -1.f,
                       (corner & 1) ? 1.f : -1.f};
  const float loc[3] = {sg[0] * half[0], sg[1] * half[1], sg[2] * half[2]};
  for (int a = 0; a < 3; ++a)
    pt[a] = pw[a] + (Rw[3 * a] * loc[0] + Rw[3 * a + 1] * loc[1] +
                     Rw[3 * a + 2] * loc[2]);
  return a_proj;
}

// Narrowphase of contact row c: PHI, NRM, PNT and K1.  Every kind reads
// only the sphere centres and box poses, so the row depends on q alone.
template <class W>
__device__ void contact_row(const StepTable& T, const Layout& Y, const W& s,
                            int c) {
  using S = typename W::scalar;
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
    box_pose(Y, s, bi, Rw, pw);
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
  } else if (kind == C_SS || kind == C_SW) {
    // sphere vs sphere (SS: both on bodies; SW: the second a fixed world
    // sphere): the normal from the second centre to the first, the point
    // halfway through the overlap
    const int si = T.c_i0[c], sj = T.c_i1[c];
    S ca[3], cb[3];
    load3(s, Y.CEN + 3 * si, ca);
    float rb;
    if (kind == C_SS) {
      load3(s, Y.CEN + 3 * sj, cb);
      rb = T.sph_r[sj];
    } else {
      for (int a = 0; a < 3; ++a) cb[a] = S(T.ws_pos[sj][a]);
      rb = T.ws_r[sj];
    }
    S d[3];
    for (int a = 0; a < 3; ++a) d[a] = ca[a] - cb[a];
    const S dist = s_sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const S dmax = val(dist) > 1e-9f ? dist : S(1e-9f);
    // ra + rb summed in float, as the plain step and the JAX package
    // sum the float32 table radii (an exact double sum moves phi ~1e-9)
    phi = S(T.sph_r[si] + rb) - dist;
    for (int a = 0; a < 3; ++a) {
      n[a] = d[a] / dmax;
      pt[a] = cb[a] + (rb - 0.5f * phi) * n[a];
    }
  } else if (kind == C_BH) {  // box face corner vs halfspace
    const int bi = T.c_i0[c], hi = T.c_i1[c];
    S Rw[9], pw[3];
    box_pose(Y, s, bi, Rw, pw);
    const float* nh = T.hs_n[hi];
    k1 = T.c_g[c] * box_corner(T, bi, T.c_corner[c], Rw, pw, nh, pt) / 4.f;
    phi = T.hs_off[hi] - (nh[0] * pt[0] + nh[1] * pt[1] + nh[2] * pt[2]);
    for (int a = 0; a < 3; ++a) n[a] = S(nh[a]);
  } else {  // C_BS: box face corner vs body sphere, the area along the
            // direction from the box centre to the sphere's
    const int bi = T.c_i0[c], si = T.c_i1[c];
    S Rw[9], pw[3], cen[3], dir[3], nbar[3], delta[3];
    box_pose(Y, s, bi, Rw, pw);
    load3(s, Y.CEN + 3 * si, cen);
    for (int a = 0; a < 3; ++a) dir[a] = cen[a] - pw[a];
    const S dn =
        s_sqrt(dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2] + 1e-18f);
    for (int a = 0; a < 3; ++a) nbar[a] = dir[a] / dn;
    k1 = T.c_g[c] * box_corner(T, bi, T.c_corner[c], Rw, pw, nbar, pt) / 4.f;
    for (int a = 0; a < 3; ++a) delta[a] = pt[a] - cen[a];
    const S dist = s_sqrt(delta[0] * delta[0] + delta[1] * delta[1] +
                          delta[2] * delta[2] + 1e-18f);
    phi = T.sph_r[si] - dist;
    for (int a = 0; a < 3; ++a) n[a] = delta[a] / dist;
  }
  s[Y.PHI + c] = phi;
  s[Y.K1 + c] = k1;
  for (int a = 0; a < 3; ++a) {
    s[Y.NRM + 3 * c + a] = n[a];
    s[Y.PNT + 3 * c + a] = pt[a];
  }
}

// Narrowphase and contact Jacobians: PHI, NRM, PNT, K1 and JC for every
// contact row, in the JAX row order (table c_* arrays).  Sphere centres
// and box poses, then contact rows, then Jacobian entries (row c, dof k)
// in parallel.
template <class Tm, class W>
__device__ void contact_primal(const Tm& tm, const StepTable& T,
                               const Layout& Y, const W& s) {
  using S = typename W::scalar;
  const int nv = T.nv;
  TEAM_FOR(t, T.ns + T.nbox) {
    if (t < T.ns) {
      const int ci = t;
      const int b = T.sph_body[ci];
      const float* off = T.sph_off[ci];
      for (int a = 0; a < 3; ++a)
        s[Y.CEN + 3 * ci + a] =
            s[Y.P + 3 * b + a] + (s[Y.R + 9 * b + 3 * a] * off[0] +
                                  s[Y.R + 9 * b + 3 * a + 1] * off[1] +
                                  s[Y.R + 9 * b + 3 * a + 2] * off[2]);
    } else {
      const int i = t - T.ns;
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
  }
  tm.sync();
  TEAM_FOR(c, T.nc) contact_row(T, Y, s, c);
  tm.sync();
  // relative contact Jacobian: rows of body A minus rows of body B
  S pt[3];
  int have = -1;                      // the contact whose point is in pt
  TEAM_FOR2(c, k, T.nc, nv) {
    const int ba = T.c_body_a[c], bb = T.c_body_b[c];
    if (c != have) {
      load3(s, Y.PNT + 3 * c, pt);
      have = c;
    }
    S ja[3] = {S(0.f), S(0.f), S(0.f)}, jb[3] = {S(0.f), S(0.f), S(0.f)};
    if (ba >= 0 && T.anc[ba][k] != 0.f) point_jac_col(T, Y, s, k, pt, ja);
    if (bb >= 0 && T.anc[bb][k] != 0.f) point_jac_col(T, Y, s, k, pt, jb);
    for (int a = 0; a < 3; ++a) s[Y.JC + (3 * c + a) * nv + k] = ja[a] - jb[a];
  }
  tm.sync();
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

// v_rel = Jc vel of contact c, its force f and (with D) D = df/dv_rel.
template <class W>
__device__ void contact_force(const StepTable& T, const Layout& Y,
                              const W& s, int c, int vel, bool implicit,
                              float vs, typename W::scalar f[3],
                              typename W::scalar* D) {
  using S = typename W::scalar;
  const int nv = T.nv;
  S vrel[3], n[3];
  for (int a = 0; a < 3; ++a) {
    S acc = S(0.f);
    for (int k = 0; k < nv; ++k) acc += s[Y.JC + (3 * c + a) * nv + k] * s[vel + k];
    vrel[a] = acc;
  }
  load3(s, Y.NRM + 3 * c, n);
  const S phi = s[Y.PHI + c], k1 = s[Y.K1 + c];
  if (implicit)
    contact_force_implicit(T, c, phi, n, vrel, k1, vs, f, D);
  else
    contact_force_explicit(T, c, phi, n, vrel, k1, f);
}

// Contact generalized force Jc' f(Jc vel) into TC; with with_G also
// G = sum_c Jc' D Jc into the Newton matrix block (row stride nv + 1).
// Implicit when `implicit`.  Rows of Jc that are zero are skipped in G,
// as in the reference, and every entry sums its contacts in order.  The
// team of one keeps the per-thread order: contact by contact, f and D in
// registers, E = D Jc of that contact, then TC and G accumulated in
// place.  A team first finds f and D of every contact in parallel; then
// TC over dofs (in contact order) and E of every contact; then each
// entry of G, summed in a register.
template <class Tm, class W>
__device__ void contact_tau(const Tm& tm, const StepTable& T,
                            const Layout& Y, const W& s, int vel,
                            bool implicit, float vs, bool with_G) {
  using S = typename W::scalar;
  const int nv = T.nv, nc = T.nc, w = nv + 1;
  if constexpr (Tm::size == 1) {
    for (int k = 0; k < nv; ++k) s[Y.TC + k] = S(0.f);
    if (with_G)
      for (int i = 0; i < nv; ++i)
        for (int j = 0; j < nv; ++j) s[Y.G + i * w + j] = S(0.f);
    for (int c = 0; c < nc; ++c) {
      const int J = Y.JC + 3 * c * nv;
      S f[3], D[9];
      contact_force(T, Y, s, c, vel, implicit, vs, f, with_G ? D : nullptr);
      for (int k = 0; k < nv; ++k)
        s[Y.TC + k] += s[J + k] * f[0] + s[J + nv + k] * f[1] +
                       s[J + 2 * nv + k] * f[2];
      if (!with_G) continue;
      for (int a = 0; a < 3; ++a)
        for (int j = 0; j < nv; ++j)
          s[Y.EC + a * nv + j] = D[3 * a] * s[J + j] +
                                 D[3 * a + 1] * s[J + nv + j] +
                                 D[3 * a + 2] * s[J + 2 * nv + j];
      for (int i = 0; i < nv; ++i) {
        const S j0 = s[J + i], j1 = s[J + nv + i], j2 = s[J + 2 * nv + i];
        if (val(j0) == 0.f && val(j1) == 0.f && val(j2) == 0.f) continue;
        for (int j = 0; j < nv; ++j)
          s[Y.G + i * w + j] += j0 * s[Y.EC + j] + j1 * s[Y.EC + nv + j] +
                                j2 * s[Y.EC + 2 * nv + j];
      }
    }
    return;
  }
  TEAM_FOR(c, nc) {
    S f[3], D[9];
    contact_force(T, Y, s, c, vel, implicit, vs, f, with_G ? D : nullptr);
    for (int a = 0; a < 3; ++a) s[Y.FC + 3 * c + a] = f[a];
    if (with_G)
      for (int k = 0; k < 9; ++k) s[Y.DC + 9 * c + k] = D[k];
  }
  tm.sync();
  TEAM_FOR(k, nv) {
    S acc = S(0.f);
    for (int c = 0; c < nc; ++c) {
      const int J = Y.JC + 3 * c * nv;
      acc += s[J + k] * s[Y.FC + 3 * c] + s[J + nv + k] * s[Y.FC + 3 * c + 1] +
             s[J + 2 * nv + k] * s[Y.FC + 3 * c + 2];
    }
    s[Y.TC + k] = acc;
  }
  if (!with_G) {
    tm.sync();
    return;
  }
  // E_c = D_c Jc_c (3 x nv) at EC + 3 c nv
  TEAM_FOR2(ca, j, 3 * nc, nv) {
    const int J = Y.JC + 3 * (ca / 3) * nv, d = Y.DC + 3 * ca;
    s[Y.EC + ca * nv + j] = s[d] * s[J + j] + s[d + 1] * s[J + nv + j] +
                            s[d + 2] * s[J + 2 * nv + j];
  }
  tm.sync();
  TEAM_FOR2(i, j, nv, nv) {
    S acc = S(0.f);
    for (int c = 0; c < nc; ++c) {
      const int J = Y.JC + 3 * c * nv, e = Y.EC + 3 * c * nv;
      const S j0 = s[J + i], j1 = s[J + nv + i], j2 = s[J + 2 * nv + i];
      if (val(j0) == 0.f && val(j1) == 0.f && val(j2) == 0.f) continue;
      acc += j0 * s[e + j] + j1 * s[e + nv + j] + j2 * s[e + 2 * nv + j];
    }
    s[Y.G + i * w + j] = acc;
  }
  tm.sync();
}

// Implicit residual res = M (vp - v) - dt (tau + Jc' f(Jc vp)) into out;
// returns |res|^2 (summed in row order on the team's first thread: the
// damped-Newton test compares two such sums).  With with_G, also leaves
// G = M - dt Jc' D Jc with res in its last column.  With contact false
// the contact term is left out (the Jacobian's v-directions, whose
// contact tangent is zero).
template <class Tm, class W>
__device__ typename W::scalar residual(const Tm& tm, const StepTable& T,
                                       const Layout& Y, const W& s, int vp,
                                       float vs, bool with_G, int out,
                                       bool contact = true) {
  using S = typename W::scalar;
  const int nv = T.nv, w = nv + 1;
  const int V = Y.X + T.nq;
  if (contact) {
    contact_tau(tm, T, Y, s, vp, true, vs, with_G);
  } else {
    TEAM_FOR(k, nv) s[Y.TC + k] = S(0.f);
    tm.sync();
  }
  TEAM_FOR(i, nv) {
    S acc = S(0.f);
    for (int j = 0; j < nv; ++j) acc += s[Y.M + i * nv + j] * (s[vp + j] - s[V + j]);
    s[out + i] = acc - T.dt * (s[Y.TAU + i] + s[Y.TC + i]);
  }
  tm.sync();
  if (tm.rank() == 0) {
    S sq = S(0.f);
    for (int i = 0; i < nv; ++i) sq += s[out + i] * s[out + i];
    s[Y.SQ] = sq;
  }
  if (with_G) {
    TEAM_FOR2(i, j, nv, w) {
      const int t = i * w + j;
      s[Y.G + t] = j < nv ? s[Y.M + i * nv + j] - T.dt * s[Y.G + t]
                          : s[out + i];
    }
  }
  tm.sync();
  return s[Y.SQ];
}

// q' = q (+) dt v' into XN (quaternion renormalized every step): the
// bodies' positions and the velocities in parallel.
template <class Tm, class W>
__device__ void integrate(const Tm& tm, const StepTable& T, const Layout& Y,
                          const W& s, int vnext) {
  using S = typename W::scalar;
  const float dt = T.dt;
  TEAM_FOR(t, T.nb + T.nv) {
    if (t >= T.nb) {
      const int k = t - T.nb;
      s[Y.XN + T.nq + k] = s[vnext + k];
      continue;
    }
    const int b = t;
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
  tm.sync();
}

// The next velocity v' into VP, after fk, mass_matrix and bias_and_tau:
// the contact-free predictor v + dt M^-1 tau, then the contact solve
// (narrowphase and contact Jacobians first).  The step and the
// cold-Newton Jacobian (megajac.cu) both run it.
template <class Tm, class W>
__device__ void next_velocity(const Tm& tm, const StepTable& T,
                              const Layout& Y, const W& s) {
  using S = typename W::scalar;
  const int nv = T.nv;
  const int V = Y.X + T.nq;
  const float dt = T.dt;
  // contact-free predictor v + dt M^-1 tau (into VP)
  chol_solve(tm, Y, s, nv, Y.TAU, Y.VP);
  TEAM_FOR(k, nv) s[Y.VP + k] = s[V + k] + dt * s[Y.VP + k];
  tm.sync();
  tm.lap(PH_PREDICTOR);
  if (!T.has_contact) return;
  contact_primal(tm, T, Y, s);
  tm.lap(PH_CONTACT);
  if (T.contact_iters == 0) {
    contact_tau(tm, T, Y, s, V, false, 0.f, false);
    TEAM_FOR(k, nv) s[Y.TC + k] = s[Y.TAU + k] + s[Y.TC + k];
    tm.sync();
    chol_solve(tm, Y, s, nv, Y.TC, Y.VP);
    TEAM_FOR(k, nv) s[Y.VP + k] = s[V + k] + dt * s[Y.VP + k];
    tm.sync();
    return;
  }
  // stiction continuation + damped Newton: per lane, a half step when
  // the full step's residual grew (impact overshoot)
  for (int it = 0; it < T.contact_iters; ++it) {
    const float vs = T.sched[it];
    const S r0 = residual(tm, T, Y, s, Y.VP, vs, true, Y.RES);
    tm.lap(PH_RESIDUAL_G);
    gauss_jordan(tm, Y, s, nv, Y.DV);
    tm.lap(PH_GAUSS_JORDAN);
    TEAM_FOR(k, nv) s[Y.VP1 + k] = s[Y.VP + k] - s[Y.DV + k];
    tm.sync();
    tm.lap(PH_NEWTON_STEP);
    const S r1 = residual(tm, T, Y, s, Y.VP1, vs, false, Y.R1);
    tm.lap(PH_RESIDUAL);
    const bool grew = val(r1) > 4.f * val(r0);
    TEAM_FOR(k, nv)
      s[Y.VP + k] = grew ? s[Y.VP + k] - 0.5f * s[Y.DV + k] : s[Y.VP1 + k];
    tm.sync();
    tm.lap(PH_NEWTON_STEP);
  }
}

// The step: state at Y.X (q then v), input at Y.U -> next state at Y.XN.
// X and U must be visible to the whole team; XN is on return.
template <class Tm, class W>
__device__ void lane_step(const Tm& tm, const StepTable& T, const Layout& Y,
                          const W& s) {
  fk(tm, T, Y, s);
  tm.lap(PH_FK);
  mass_matrix(tm, T, Y, s);
  tm.lap(PH_MASS);
  bias_and_tau(tm, T, Y, s);
  tm.lap(PH_BIAS);
  next_velocity(tm, T, Y, s);
  integrate(tm, T, Y, s, Y.VP);
  tm.lap(PH_INTEGRATE);
}

// ---------------------------------------------------------------------------
// launch configuration
// ---------------------------------------------------------------------------

// Bytes of shared memory the table takes in a team kernel (16-aligned).
__host__ __device__ inline int ddp_table_smem() {
  return ((int)sizeof(StepTable) + 15) & ~15;
}

// Scalars per lane in a team kernel's shared memory (a multiple of 4, so
// 16-byte aligned for float and double).
inline int ddp_lane_floats(int per_lane) { return (per_lane + 3) & ~3; }

// Most lanes in one block of a team kernel: the flagship's 512 lanes over
// 132 SMs.  The kernels declare __launch_bounds__(DDP_MAX_BLOCK_LANES *
// team), so that ptxas budgets registers for such a block; 4 x 128
// threads and 4 named barriers (1..4) are within a block's limits.
#define DDP_MAX_BLOCK_LANES 4

// The launch of a team kernel: one lane per team of `team` threads, as
// few lanes per block as spread L lanes over every SM, but no more than
// DDP_MAX_BLOCK_LANES and the shared memory (the table once per block,
// then each lane's working set of per_lane scalars of scalar_bytes each)
// allow.  Sets the kernel's dynamic shared memory limit and shrinks the
// block until one fits an SM's registers.  Returns a CUDA error code (0 =
// ok; cudaErrorInvalidValue when one lane does not fit).
struct TeamLaunch {
  int lanes_per_block, blocks, threads, smem;
};

inline int ddp_team_launch(const void* kernel, int team, int L, int per_lane,
                           TeamLaunch* out, int scalar_bytes = 4) {
  int dev = 0, sms = 132, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int lane_bytes = scalar_bytes * ddp_lane_floats(per_lane);
  const int table = ddp_table_smem();
  if (table + lane_bytes > optin) return (int)cudaErrorInvalidValue;
  int lpb = (L + sms - 1) / sms;
  const int by_smem = (optin - table) / lane_bytes;
  if (lpb > by_smem) lpb = by_smem;
  if (lpb > DDP_MAX_BLOCK_LANES) lpb = DDP_MAX_BLOCK_LANES;
  if (lpb < 1) lpb = 1;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      table + lpb * lane_bytes);
  if (err) return err;
  for (;;) {
    int fit = 0;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, kernel, lpb * team, table + lpb * lane_bytes);
    if (err) return err;
    if (fit > 0) break;
    if (lpb == 1) return (int)cudaErrorLaunchOutOfResources;
    --lpb;
  }
  out->lanes_per_block = lpb;
  out->blocks = (L + lpb - 1) / lpb;
  out->threads = lpb * team;
  out->smem = table + lpb * lane_bytes;
  return 0;
}

// Copy the table into shared memory, all threads of the block.
__device__ inline void ddp_copy_table(const StepTable* table,
                                      unsigned char* smem) {
  const int words = (int)sizeof(StepTable) / 4;
  const int* src = (const int*)table;
  int* dst = (int*)smem;
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
}

// Host-side size queries shared by the kernel libraries.
extern "C" int ddp_table_bytes() { return (int)sizeof(StepTable); }

// Scalars of one lane's working set.
extern "C" int ddp_scratch_per_lane(int nb, int nq, int nv, int nu, int nc,
                                    int ns, int nbox) {
  return make_layout(nb, nq, nv, nu, nc, ns, nbox).total;
}

// Shared memory one block may use on the current device (bytes).
extern "C" int ddp_smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}
