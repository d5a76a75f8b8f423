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
// lanestep.cuh in float64 on its working-set layout (make_layout):
//   - primal, a team of DDP_TEAM threads per lane with the lane's working
//     set and the step table in shared memory (megastep.cu's design):
//     forward kinematics, mass matrix, bias, narrowphase and contact
//     Jacobians at (q, v, u); the root v' (root-seeded: the velocity of
//     x_next; cold: the step's own predictor and stiction-continuation
//     Newton, next_velocity of lanestep.cuh); G at the root with D at the
//     final stiction width; G^-1 by the team's unpivoted Gauss-Jordan.
//     Writes G^-1 and the working set's fields below TAN (the store) to
//     global memory, lane-strided.
//   - tangent, one thread per (lane, direction), n + m directions,
//     direction-major so that a warp shares its direction and branches:
//     the same device step on the dual number of dual.cuh through a
//     TangentView, whose values are the store's and whose tangents alone
//     live in the thread's scratch.  A q-direction runs fk, mass matrix,
//     bias, narrowphase, contact Jacobians and the residual's force at
//     the final width with q dual (v, u, v' primal); a v-direction runs
//     the bias and the residual without the contact term, kinematics, M
//     and contact being constant in v (the reference's res_of_v); then
//     dv' = -G^-1 dres.  A u-direction is dv' = dt G^-1 e_act.  Every
//     direction ends in the integrator's tangent and writes its column
//     of fx or fu.
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
// What bounds it on an H100.  The primal is a long chain of small
// dependent phases per lane (megastep's latency bound), so a team runs
// each phase in parallel over its outputs; its float64 working set is
// about 32 KB a lane, 4 lanes a block.  The tangent passes are 49 times
// as many independent chains and stream their scratch: one double per
// field a pass writes (a q-direction's fields below TAN, about 18 KB a
// thread at the flagship sizes; a v- or u-direction's from VC on, about
// 4 KB; 0.85 GB at 1792 lanes), read back within the pass, while the
// primal values come from the 34 MB store, which stays in L2.  The
// ragged lane edge is masked, not padded.  Every sum stays in one thread
// in the per-thread order, so G^-1, fx and fu do not depend on the team
// size.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math), loaded with ctypes.  -DDDP_TEAM
//        = 32, 64 or 128 sets the primal's team size (threads per lane).

#include "dual.cuh"

#ifndef DDP_TEAM
#define DDP_TEAM 128
#endif

// At most DDP_MAX_BLOCK_LANES lanes a block (ddp_team_launch caps them).
__global__ void __launch_bounds__(DDP_MAX_BLOCK_LANES * DDP_TEAM)
    megajac_primal_kernel(const StepTable* __restrict__ table,
                          const float* __restrict__ x,
                          const float* __restrict__ u,
                          const float* __restrict__ x_next,
                          double* __restrict__ ginv,
                          double* __restrict__ store, int L,
                          int lanes_per_block, int lane_scalars) {
  extern __shared__ __align__(16) unsigned char smem[];
  ddp_copy_table(table, smem);
  __syncthreads();
  const int slot = threadIdx.x / DDP_TEAM;
  const int lane = blockIdx.x * lanes_per_block + slot;
  if (lane >= L) return;  // the whole team: nothing below syncs the block
  using Tm = Team<DDP_TEAM>;
  const Tm tm((int)threadIdx.x % DDP_TEAM, slot + 1);
  const StepTable& T = *(const StepTable*)smem;
  const Layout Y = make_layout(T);
  const Local<double> s{(double*)(smem + ddp_table_smem()) +
                        (size_t)slot * lane_scalars};
  const int nq = T.nq, nv = T.nv, n = nq + nv;
  const size_t Ls = (size_t)L;
  TEAM_FOR(i, n) s[Y.X + i] = x[i * Ls + lane];
  TEAM_FOR(i, T.nu) s[Y.U + i] = u[i * Ls + lane];
  tm.sync();
  fk(tm, T, Y, s);
  mass_matrix(tm, T, Y, s);
  bias_and_tau(tm, T, Y, s);
  if (x_next) {
    // root-seeded: the rollout's next state is the root (no Newton)
    if (T.has_contact) contact_primal(tm, T, Y, s);
    TEAM_FOR(k, nv) s[Y.VP + k] = x_next[(nq + k) * Ls + lane];
    tm.sync();
  } else {
    next_velocity(tm, T, Y, s);
  }
  if (T.has_contact) {
    residual(tm, T, Y, s, Y.VP, T.stiction_vel, true, Y.RES);
  } else {
    TEAM_FOR2(i, j, nv, nv) s[Y.G + i * (nv + 1) + j] = s[Y.M + i * nv + j];
    tm.sync();
  }
  // G^-1 into the Cholesky factor's room, free at the root
  gauss_jordan_inverse(tm, Y, s, nv, Y.LC);
  TEAM_FOR(i, nv * nv) ginv[i * Ls + lane] = s[Y.LC + i];
  TEAM_FOR(i, Y.TAN) store[i * Ls + lane] = s[i];
}

// Threads per block of the tangent kernel, and the blocks an SM must
// hold, for which ptxas budgets registers (spilling a few hundred bytes):
// its passes wait on memory, and 3 blocks an SM hide more of that than
// the 2 that its unbounded register count would leave.
#define MEGAJAC_TANGENT_THREADS 128
#define MEGAJAC_TANGENT_MIN_BLOCKS 3

__global__ void __launch_bounds__(MEGAJAC_TANGENT_THREADS,
                                  MEGAJAC_TANGENT_MIN_BLOCKS)
    megajac_tangent_kernel(const StepTable* __restrict__ table,
                           const double* __restrict__ ginv,
                           const double* __restrict__ store,
                           float* __restrict__ fx, float* __restrict__ fu,
                           double* __restrict__ scratch, int L, int ndir) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= L * ndir) return;
  const int d = t / L, lane = t - d * L;       // direction-major threads
  const StepTable& T = *table;
  const Layout Y = make_layout(T);
  const int nq = T.nq, nv = T.nv, nu = T.nu, n = nq + nv;
  const bool q_dir = d < nq;
  // a q-direction keeps the tangents of every field below TAN; along v
  // and u the fields below VC are constant, so a v- or u-direction keeps
  // only those from VC on.  Scratch: the q-directions' (TAN, nq, L), then
  // the others' (TAN - VC, ndir - nq, L).
  const TangentView s =
      q_dir ? TangentView{store + lane, scratch + t, L, L * nq, 0}
            : TangentView{store + lane,
                          scratch + (size_t)Y.TAN * nq * L + (t - nq * L), L,
                          L * (ndir - nq), Y.VC};
  const size_t Ls = (size_t)L;
  const double* G = ginv + lane;               // G^-1 (i, j) at G[(i nv + j) L]
  // the inputs' tangents: e_d for an x-direction; v' held primal
  for (int i = 0; i < n; ++i) s[Y.X + i] = Dual(0., i == d ? 1. : 0.);
  for (int i = 0; i < nu; ++i) s[Y.U + i] = Dual(0.);
  for (int k = 0; k < nv; ++k) s[Y.VP + k] = Dual(0.);
  if (d < n) {
    // dres along e_d; its tangent only
    const Solo tm{};
    if (q_dir) {
      fk(tm, T, Y, s);
      mass_matrix(tm, T, Y, s);
    }
    bias_and_tau(tm, T, Y, s);
    const bool contact = q_dir && T.has_contact;
    if (contact) contact_primal(tm, T, Y, s);
    residual(tm, T, Y, s, Y.VP, T.stiction_vel, false, Y.RES, contact);
    for (int i = 0; i < nv; ++i) {
      double acc = 0.;
      for (int j = 0; j < nv; ++j)
        acc += G[(i * nv + j) * Ls] * Dual(s[Y.RES + j]).d;
      s[Y.VP + i] = Dual(0., -acc);
    }
  } else {
    // dres/du_k = -dt e_act: dv' = dt G^-1 column act_vdof[k]
    const int a = T.act_vdof[d - n];
    for (int i = 0; i < nv; ++i)
      s[Y.VP + i] = Dual(0., T.dt * G[(i * nv + a) * Ls]);
  }
  integrate(Solo(), T, Y, s, Y.VP);
  for (int i = 0; i < n; ++i) {
    const float g = (float)Dual(s[Y.XN + i]).d;
    if (d < n)
      fx[((size_t)i * n + d) * Ls + lane] = g;
    else
      fu[((size_t)i * nu + (d - n)) * Ls + lane] = g;
  }
}

// The primal's launch for L lanes whose working set is per_lane doubles
// (ddp_scratch_per_lane): out = {threads per lane, lanes per
// block, dynamic shared bytes per block, blocks}.  Returns a CUDA error
// code (0 = ok).
extern "C" int megajac_config(int L, int per_lane, int* out) {
  TeamLaunch c;
  const int err = ddp_team_launch((const void*)megajac_primal_kernel,
                                  DDP_TEAM, L, per_lane, &c, 8);
  if (err) return err;
  out[0] = DDP_TEAM;
  out[1] = c.lanes_per_block;
  out[2] = c.smem;
  out[3] = c.blocks;
  return 0;
}

// Fields of the primal's store (make_layout's TAN).
extern "C" int megajac_store_per_lane(int nb, int nq, int nv, int nu, int nc,
                                      int ns, int nbox) {
  return make_layout(nb, nq, nv, nu, nc, ns, nbox).TAN;
}

// Doubles of the tangent passes' scratch per lane: TAN for each of the
// nq q-directions, TAN - VC for each of the nv + nu others.
extern "C" int megajac_scratch_per_lane(int nb, int nq, int nv, int nu,
                                        int nc, int ns, int nbox) {
  const Layout y = make_layout(nb, nq, nv, nu, nc, ns, nbox);
  return nq * y.TAN + (nv + nu) * (y.TAN - y.VC);
}

// The primal on `stream`: x_next == nullptr selects the cold-Newton
// variant; writes ginv (nv, nv, L) and store (TAN, L), float64.  Returns
// a CUDA error code (0 = launched).
extern "C" int megajac_primal_launch(const void* table, const float* x,
                                     const float* u, const float* x_next,
                                     double* ginv, double* store, int L,
                                     int per_lane, void* stream) {
  TeamLaunch c;
  const int err = ddp_team_launch((const void*)megajac_primal_kernel,
                                  DDP_TEAM, L, per_lane, &c, 8);
  if (err) return err;
  megajac_primal_kernel<<<c.blocks, c.threads, c.smem, (cudaStream_t)stream>>>(
      (const StepTable*)table, x, u, x_next, ginv, store, L,
      c.lanes_per_block, ddp_lane_floats(per_lane));
  return (int)cudaGetLastError();
}

// The tangent passes on `stream`, after the primal: ndir = n + m, scratch
// holds megajac_scratch_per_lane doubles per lane.  Returns a CUDA error
// code.
extern "C" int megajac_tangent_launch(const void* table, const double* ginv,
                                      const double* store, float* fx,
                                      float* fu, double* scratch, int L,
                                      int ndir, void* stream) {
  const long long total = (long long)L * ndir;
  const int blocks =
      (int)((total + MEGAJAC_TANGENT_THREADS - 1) / MEGAJAC_TANGENT_THREADS);
  megajac_tangent_kernel<<<blocks, MEGAJAC_TANGENT_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const StepTable*)table, ginv, store, fx, fu, scratch, L, ndir);
  return (int)cudaGetLastError();
}
