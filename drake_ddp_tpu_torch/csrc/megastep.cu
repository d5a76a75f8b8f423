// megastep: one multibody contact step for L lanes in one launch.
//
// Replaces the Pallas kernel of drake_ddp_tpu/ops/megastep.py
// (make_pallas_step): (x (n, L), u (m, L)) -> x_next (n, L), lane-last
// f32.  It is the same device step that megaroll.cu loops over, at one
// step: the batched solver launches it once per horizon step on its
// rollout_kernel="megastep" path.
//
// What bounds it on an H100: latency, as for megaroll (a chain of about
// 0.2 Mop of small dependent phases per lane, few bytes, 512 lanes at
// the flagship).  The team design of megaroll.cu: a team of DDP_TEAM
// threads per lane runs each phase of the step in parallel over its
// outputs, with the lane's working set and the step table in shared
// memory.  The ragged lane edge is masked, not padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math), loaded with ctypes.  -DDDP_TEAM
//        = 32, 64 or 128 sets the team size (threads per lane).

#include "lanestep.cuh"

#ifndef DDP_TEAM
#define DDP_TEAM 128   // the fastest of 32, 64 and 128 (PERF.md)
#endif

// At most DDP_MAX_BLOCK_LANES lanes a block (ddp_team_launch caps them).
__global__ void __launch_bounds__(DDP_MAX_BLOCK_LANES * DDP_TEAM)
    megastep_kernel(const StepTable* __restrict__ table,
                    const float* __restrict__ x,
                    const float* __restrict__ u,
                    float* __restrict__ x_next, int L,
                    int lanes_per_block, int lane_floats) {
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
  const Local<float> s{(float*)(smem + ddp_table_smem()) +
                       (size_t)slot * lane_floats};
  const int n = T.nq + T.nv;
  const size_t Ls = (size_t)L;
  TEAM_FOR(i, n) s[Y.X + i] = x[i * Ls + lane];
  TEAM_FOR(i, T.nu) s[Y.U + i] = u[i * Ls + lane];
  tm.sync();
  lane_step(tm, T, Y, s);
  TEAM_FOR(i, n) x_next[i * Ls + lane] = s[Y.XN + i];
}

// The launch configuration for L lanes whose working set is per_lane
// floats (ddp_scratch_per_lane): out = {threads per lane, lanes per
// block, dynamic shared bytes per block, blocks}.  Returns a CUDA error
// code (0 = ok).
extern "C" int megastep_config(int L, int per_lane, int* out) {
  TeamLaunch c;
  const int err =
      ddp_team_launch((const void*)megastep_kernel, DDP_TEAM, L, per_lane, &c);
  if (err) return err;
  out[0] = DDP_TEAM;
  out[1] = c.lanes_per_block;
  out[2] = c.smem;
  out[3] = c.blocks;
  return 0;
}

// Launch on `stream`; returns a CUDA error code (0 = launched).
extern "C" int megastep_launch(const void* table, const float* x,
                               const float* u, float* x_next, int L,
                               int per_lane, void* stream) {
  TeamLaunch c;
  const int err =
      ddp_team_launch((const void*)megastep_kernel, DDP_TEAM, L, per_lane, &c);
  if (err) return err;
  megastep_kernel<<<c.blocks, c.threads, c.smem, (cudaStream_t)stream>>>(
      (const StepTable*)table, x, u, x_next, L, c.lanes_per_block,
      ddp_lane_floats(per_lane));
  return (int)cudaGetLastError();
}
