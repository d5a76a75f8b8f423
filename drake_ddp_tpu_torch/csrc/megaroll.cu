// megaroll: the whole closed-loop linesearch rollout in one launch.
//
// Replaces the Pallas kernel of drake_ddp_tpu/ops/megaroll.py
// (make_pallas_rollout).  For each lane and t < T:
//
//     u_t = u_bar_t - eps * kappa_t - K_t (x_t - x_bar_t)
//     x_{t+1} = step(x_t, u_t)
//
// with xs[t] the state AFTER step t.  Layout is lane-last f32: x0 (n, L),
// eps (L), u_bar / kappa (T, m, L), K (T, m, n, L), x_bar (T, n, L) ->
// xs (T, n, L), us (T, m, L).  The time loop runs inside the kernel (the
// Pallas kernel's fori_loop).
//
// What bounds it on an H100: latency.  Each lane-step is a chain of
// about 0.2 Mop of small dependent phases (lanestep.cuh), the bytes are
// few (the tapes, 44.6 MB per flagship launch), and a flagship rollout
// has only 512 lanes, about 4 per SM.  With one thread per lane and its
// working set in global memory, each SM ran one warp with 4 live
// threads and every operation waited on a memory round trip (5.18 ms
// per step).  The team design: a team of DDP_TEAM threads runs one
// lane, each phase of the step in parallel over its outputs; the
// lane's working set (about 17 KB at the cheetah's sizes) and the step
// table (one copy per block) live in shared memory; the lanes of a
// block are as few as spread the launch over every SM, at most 4.  Per step the
// team first reads that step's tape slice (K_t, u_bar_t, kappa_t,
// x_bar_t) into shared memory, strided by L in the lane-last layout.
// The state stays in shared memory between steps.  The ragged lane edge
// is masked, not padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math), loaded with ctypes.  -DDDP_TEAM
//        = 32, 64 or 128 sets the team size (threads per lane).

#include "lanestep.cuh"

#ifndef DDP_TEAM
#define DDP_TEAM 128   // the fastest of 32, 64 and 128 (PERF.md)
#endif

// Floats a lane keeps beside its working set: one step's K slice (m x n),
// u_bar and kappa (m each) and x_bar (n).
__host__ __device__ inline int roll_tape_floats(int n, int m) {
  return m * n + 2 * m + n;
}

// At most DDP_MAX_BLOCK_LANES lanes a block (ddp_team_launch caps them).
// Tm is the team type: Team<DDP_TEAM>, or the phase-clocking team of
// megaroll_clocks.cu.
template <class Tm>
__global__ void __launch_bounds__(DDP_MAX_BLOCK_LANES * Tm::size)
    megaroll_kernel(const StepTable* __restrict__ table,
                    const float* __restrict__ x0,
                    const float* __restrict__ eps,
                    const float* __restrict__ u_bar,
                    const float* __restrict__ kappa,
                    const float* __restrict__ K,
                    const float* __restrict__ x_bar,
                    float* __restrict__ xs,
                    float* __restrict__ us, int L, int Tn,
                    int lanes_per_block, int lane_floats) {
  extern __shared__ __align__(16) unsigned char smem[];
  ddp_copy_table(table, smem);
  __syncthreads();
  const int slot = threadIdx.x / Tm::size;
  const int lane = blockIdx.x * lanes_per_block + slot;
  if (lane >= L) return;  // the whole team: nothing below syncs the block
  const Tm tm((int)threadIdx.x % Tm::size, slot + 1);
  const StepTable& T = *(const StepTable*)smem;
  const Layout Y = make_layout(T);
  float* ws = (float*)(smem + ddp_table_smem()) + (size_t)slot * lane_floats;
  const Local<float> s{ws};
  const int n = T.nq + T.nv, m = T.nu;
  float* Kt = ws + Y.total;   // K_t (m x n), then u_bar_t, kappa_t, x_bar_t
  float* ub = Kt + m * n;
  float* kap = ub + m;
  float* xb = kap + m;
  const size_t Ls = (size_t)L;
  TEAM_FOR(i, n) s[Y.X + i] = x0[i * Ls + lane];
  const float e = eps[lane];
  for (int t = 0; t < Tn; ++t) {
    TEAM_FOR(k, roll_tape_floats(n, m)) {
      float v;
      if (k < m * n)
        v = K[((size_t)t * m * n + k) * Ls + lane];
      else if (k < m * n + m)
        v = u_bar[((size_t)t * m + (k - m * n)) * Ls + lane];
      else if (k < m * n + 2 * m)
        v = kappa[((size_t)t * m + (k - m * n - m)) * Ls + lane];
      else
        v = x_bar[((size_t)t * n + (k - m * n - 2 * m)) * Ls + lane];
      Kt[k] = v;
    }
    tm.sync();
    tm.lap(PH_TAPE);
    TEAM_FOR(i, m) {
      float kdx = 0.f;
      for (int j = 0; j < n; ++j) kdx += Kt[i * n + j] * (s[Y.X + j] - xb[j]);
      const float uu = ub[i] - e * kap[i] - kdx;
      s[Y.U + i] = uu;
      us[((size_t)t * m + i) * Ls + lane] = uu;
    }
    tm.sync();
    tm.lap(PH_POLICY);
    lane_step(tm, T, Y, s);
    TEAM_FOR(i, n) {
      const float v = s[Y.XN + i];
      xs[((size_t)t * n + i) * Ls + lane] = v;
      s[Y.X + i] = v;
    }
    tm.sync();
    tm.lap(PH_OUT);
  }
}

// Launch the team kernel `Tm` on `stream`; returns a CUDA error code.
template <class Tm>
int megaroll_launch_team(const void* table, const float* x0,
                         const float* eps, const float* u_bar,
                         const float* kappa, const float* K,
                         const float* x_bar, float* xs, float* us, int L,
                         int Tn, int per_lane, int n, int m, void* stream) {
  const int floats = per_lane + roll_tape_floats(n, m);
  TeamLaunch c;
  const int err = ddp_team_launch((const void*)megaroll_kernel<Tm>, Tm::size,
                                  L, floats, &c);
  if (err) return err;
  megaroll_kernel<Tm><<<c.blocks, c.threads, c.smem, (cudaStream_t)stream>>>(
      (const StepTable*)table, x0, eps, u_bar, kappa, K, x_bar, xs, us, L, Tn,
      c.lanes_per_block, ddp_lane_floats(floats));
  return (int)cudaGetLastError();
}

// The launch configuration for L lanes whose working set is per_lane
// floats (ddp_scratch_per_lane): out = {threads per lane, lanes per
// block, dynamic shared bytes per block, blocks}.  Returns a CUDA error
// code (0 = ok).
extern "C" int megaroll_config(int L, int per_lane, int n, int m, int* out) {
  TeamLaunch c;
  const int err =
      ddp_team_launch((const void*)megaroll_kernel<Team<DDP_TEAM>>, DDP_TEAM,
                      L, per_lane + roll_tape_floats(n, m), &c);
  if (err) return err;
  out[0] = DDP_TEAM;
  out[1] = c.lanes_per_block;
  out[2] = c.smem;
  out[3] = c.blocks;
  return 0;
}

// Launch on `stream`; returns a CUDA error code (0 = launched).
extern "C" int megaroll_launch(const void* table, const float* x0,
                               const float* eps, const float* u_bar,
                               const float* kappa, const float* K,
                               const float* x_bar, float* xs, float* us,
                               int L, int Tn, int per_lane, int n, int m,
                               void* stream) {
  return megaroll_launch_team<Team<DDP_TEAM>>(table, x0, eps, u_bar, kappa, K,
                                              x_bar, xs, us, L, Tn, per_lane,
                                              n, m, stream);
}
