// megajac: the structured-IFT step Jacobian (fx, fu) for L lanes.
//
// Replaces the Pallas kernels of drake_ddp_tpu/ops/megajac.py
// (make_pallas_jac, root-seeded or not) and of
// tools/probe_megajac_compile.py (build_kernel, the cold-Newton variant).
// It computes, for each lane, what multibody/lanejac.py make_lane_jac
// computes: with the step's residual
//
//     res(v'; q, v, u) = M(q)(v' - v) - dt (B u - bias(q, v) + Jc(q)' f(v'))
//
// solved at the root v', the implicit function theorem gives
// dv' = -G^-1 dres with G = M - dt Jc' D Jc, and q' = q (+) dt v' gives
// the position rows through the integrator's tangent.  Lane-last f32:
// x (n, L), u (m, L), x_next (n, L) or none -> fx (n, n, L),
// fu (n, m, L), element (i, d) of lane l at (i * cols + d) * L + l.
//
// Two kernels on one stream, both running the device step of
// lanestep.cuh with its team of one (Solo: one thread, working set
// lane-strided in global memory):
//   - primal, one thread per lane: forward kinematics, mass matrix, bias,
//     narrowphase and contact Jacobians at (q, v, u); the root v' (root-
//     seeded: the velocity of x_next; cold: the step's own predictor and
//     stiction-continuation Newton, next_velocity of lanestep.cuh); G at
//     the root with D at the final stiction width; G^-1 by unpivoted
//     Gauss-Jordan.  Writes G^-1 and v' to buffers the wrapper allocates.
//   - tangent, one thread per (lane, direction), n + m directions: the
//     same device step on the dual number of dual.cuh.  A q-direction
//     runs fk, mass matrix, bias, narrowphase, contact Jacobians and the
//     residual's force at the final width with q dual (v, u, v' primal);
//     a v-direction runs the same with v dual and no contact term (its
//     tangent is zero); then dv' = -G^-1 dres.  A u-direction is
//     dv' = dt G^-1 e_act.  Every direction ends in the integrator's
//     tangent and writes its column of fx or fu.
//
// Precision.  Inputs and outputs are float32; everything between is
// float64 (the step in double, the dual number's parts in double).  G
// has condition numbers of 1e4 to 1e5 on cheetah states, so two float32
// evaluations of the Jacobian that only order their sums differently
// differ by up to 5x on some lanes, and a float32 kernel cannot stay
// within a small multiple of the plain float32 version's error on every
// lane.  In float64 the kernel's own rounding is far below that error,
// and what is left is the rounding of its inputs, which the plain
// version shares.  The H100 runs float64 at half its float32 rate.
//
// What bounds it on an H100: latency of long dependent scalar chains, as
// for the step (lanestep.cuh).  One thread per lane would give 1792
// threads at the flagship's derivative call, about 14 per SM, each
// walking 49 dual passes in sequence.  The (lane, direction) grid gives
// 49 times the threads (87,808), every one a single pass, and threads of
// a warp share their direction, so they take the same branches and write
// neighbouring lanes of one column.  Each tangent thread recomputes in
// its dual pass the primal kinematics it needs rather than reading
// them: that costs operations and saves a second store of the working
// set.  The price is scratch: a Lane<Dual> working set per thread (the
// team of one's layout, 48 KB at the flagship sizes), lane-strided over
// all threads (4.3 GB at 1792 lanes), which does not fit in L2; shared-
// memory tiles and a smaller dual working set are later work.  The
// ragged lane edge is masked, not padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math), loaded with ctypes.

#include "dual.cuh"

__global__ void megajac_primal_kernel(const StepTable* __restrict__ table,
                                      const float* __restrict__ x,
                                      const float* __restrict__ u,
                                      const float* __restrict__ x_next,
                                      double* __restrict__ ginv,
                                      double* __restrict__ vp,
                                      double* __restrict__ scratch, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const StepTable& T = *table;
  const Layout Y = make_layout<Solo>(T);
  const Lane<double> s{scratch + lane, L};
  const int nq = T.nq, nv = T.nv, n = nq + nv, w = nv + 1;
  const size_t Ls = (size_t)L;
  for (int i = 0; i < n; ++i) s[Y.X + i] = x[i * Ls + lane];
  for (int i = 0; i < T.nu; ++i) s[Y.U + i] = u[i * Ls + lane];
  const Solo tm{};
  fk(tm, T, Y, s);
  mass_matrix(tm, T, Y, s);
  bias_and_tau(tm, T, Y, s);
  if (x_next) {
    // root-seeded: the rollout's next state is the root (no Newton)
    if (T.has_contact) contact_primal(tm, T, Y, s);
    for (int k = 0; k < nv; ++k) s[Y.VP + k] = x_next[(nq + k) * Ls + lane];
  } else {
    next_velocity(tm, T, Y, s);
  }
  if (T.has_contact) {
    residual(tm, T, Y, s, Y.VP, T.stiction_vel, true, Y.RES);
  } else {
    for (int i = 0; i < nv; ++i)
      for (int j = 0; j < nv; ++j) s[Y.G + i * w + j] = s[Y.M + i * nv + j];
  }
  gauss_jordan_inverse(Y, s, nv, Lane<double>{ginv + lane, L});
  for (int k = 0; k < nv; ++k) vp[k * Ls + lane] = s[Y.VP + k];
}

__global__ void megajac_tangent_kernel(const StepTable* __restrict__ table,
                                       const float* __restrict__ x,
                                       const float* __restrict__ u,
                                       const double* __restrict__ ginv,
                                       const double* __restrict__ vp,
                                       float* __restrict__ fx,
                                       float* __restrict__ fu,
                                       Dual* __restrict__ scratch, int L,
                                       int ndir) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L * ndir) return;
  const int d = t / L, lane = t - d * L;       // direction-major threads
  const StepTable& T = *table;
  const Layout Y = make_layout<Solo>(T);
  const Lane<Dual> s{scratch + t, L * ndir};
  const int nq = T.nq, nv = T.nv, nu = T.nu, n = nq + nv;
  const size_t Ls = (size_t)L;
  const double* G = ginv + lane;               // G^-1 (i, j) at G[(i nv + j) L]
  for (int i = 0; i < n; ++i)
    s[Y.X + i] = Dual(x[i * Ls + lane], i == d ? 1.f : 0.f);
  for (int i = 0; i < nu; ++i) s[Y.U + i] = Dual(u[i * Ls + lane]);
  for (int k = 0; k < nv; ++k) s[Y.VP + k] = Dual(vp[k * Ls + lane]);
  if (d < n) {
    // dres along e_d with (v' and u) held primal; its tangent only
    const Solo tm{};
    fk(tm, T, Y, s);
    mass_matrix(tm, T, Y, s);
    bias_and_tau(tm, T, Y, s);
    const bool contact = d < nq && T.has_contact;
    if (contact) contact_primal(tm, T, Y, s);
    residual(tm, T, Y, s, Y.VP, T.stiction_vel, false, Y.RES, contact);
    for (int i = 0; i < nv; ++i) {
      double acc = 0.;
      for (int j = 0; j < nv; ++j) acc += G[(i * nv + j) * Ls] * s[Y.RES + j].d;
      s[Y.VP + i].d = -acc;
    }
  } else {
    // dres/du_k = -dt e_act: dv' = dt G^-1 column act_vdof[k]
    const int a = T.act_vdof[d - n];
    for (int i = 0; i < nv; ++i) s[Y.VP + i].d = T.dt * G[(i * nv + a) * Ls];
  }
  integrate(Solo(), T, Y, s, Y.VP);
  for (int i = 0; i < n; ++i) {
    const float g = (float)s[Y.XN + i].d;
    if (d < n)
      fx[((size_t)i * n + d) * Ls + lane] = g;
    else
      fu[((size_t)i * nu + (d - n)) * Ls + lane] = g;
  }
}

// Threads per block of the tangent kernel.
#define MEGAJAC_TANGENT_THREADS 128

// Launch both kernels on `stream`; returns cudaGetLastError() (0 =
// launched).  x_next == nullptr selects the cold-Newton variant.  ndir is
// n + m; the float64 buffers are ginv (nv, nv, L), vp (nv, L) and scratch
// (ddp_scratch_per_lane doubles per lane), and dual_scratch holds as many
// Duals per (lane, direction).
extern "C" int megajac_launch(const void* table, const float* x,
                              const float* u, const float* x_next, float* fx,
                              float* fu, double* ginv, double* vp,
                              double* scratch, void* dual_scratch, int L,
                              int ndir, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = ddp_block_threads(L);
  megajac_primal_kernel<<<(L + threads - 1) / threads, threads, 0, st>>>(
      (const StepTable*)table, x, u, x_next, ginv, vp, scratch, L);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)L * ndir;
  const int blocks =
      (int)((total + MEGAJAC_TANGENT_THREADS - 1) / MEGAJAC_TANGENT_THREADS);
  megajac_tangent_kernel<<<blocks, MEGAJAC_TANGENT_THREADS, 0, st>>>(
      (const StepTable*)table, x, u, ginv, vp, fx, fu, (Dual*)dual_scratch,
      L, ndir);
  return (int)cudaGetLastError();
}
