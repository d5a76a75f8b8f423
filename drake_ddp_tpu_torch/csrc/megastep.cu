// megastep: one multibody contact step for L lanes in one launch.
//
// Replaces the Pallas kernel of drake_ddp_tpu/ops/megastep.py
// (make_pallas_step): (x (n, L), u (m, L)) -> x_next (n, L), lane-last
// f32.  One thread per lane runs the device step of lanestep.cuh; see
// there for the design and what bounds it.  The batched solver launches
// this once per horizon step on its rollout_kernel="megastep" path.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math), loaded with ctypes.

#include "lanestep.cuh"

__global__ void megastep_kernel(const StepTable* __restrict__ table,
                                const float* __restrict__ x,
                                const float* __restrict__ u,
                                float* __restrict__ x_next,
                                float* __restrict__ scratch, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;  // ragged edge: masked, not padded
  const StepTable& T = *table;
  const Layout Y = make_layout(T);
  const Lane<float> s{scratch + lane, L};
  const int n = T.nq + T.nv;
  for (int i = 0; i < n; ++i) s[Y.X + i] = x[(size_t)i * L + lane];
  for (int i = 0; i < T.nu; ++i) s[Y.U + i] = u[(size_t)i * L + lane];
  lane_step(T, Y, s);
  for (int i = 0; i < n; ++i) x_next[(size_t)i * L + lane] = s[Y.XN + i];
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int megastep_launch(const void* table, const float* x,
                               const float* u, float* x_next, float* scratch,
                               int L, void* stream) {
  const int threads = ddp_block_threads(L);
  const int blocks = (L + threads - 1) / threads;
  megastep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const StepTable*)table, x, u, x_next, scratch, L);
  return (int)cudaGetLastError();
}
