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
// Pallas kernel's fori_loop); the state stays in the lane's scratch
// between steps.  One thread per lane runs the device step of
// lanestep.cuh; see there for the design and what bounds it.  The
// ragged lane edge is masked, not padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no fast math), loaded with ctypes.

#include "lanestep.cuh"

__global__ void megaroll_kernel(const StepTable* __restrict__ table,
                                const float* __restrict__ x0,
                                const float* __restrict__ eps,
                                const float* __restrict__ u_bar,
                                const float* __restrict__ kappa,
                                const float* __restrict__ K,
                                const float* __restrict__ x_bar,
                                float* __restrict__ xs,
                                float* __restrict__ us,
                                float* __restrict__ scratch, int L, int Tn) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const StepTable& T = *table;
  const Layout Y = make_layout(T);
  const Lane<float> s{scratch + lane, L};
  const int n = T.nq + T.nv, m = T.nu;
  const size_t Ls = (size_t)L;
  for (int i = 0; i < n; ++i) s[Y.X + i] = x0[i * Ls + lane];
  const float e = eps[lane];
  for (int t = 0; t < Tn; ++t) {
    for (int i = 0; i < m; ++i) {
      const float* Ki = K + ((size_t)t * m + i) * n * Ls + lane;
      const float* xb = x_bar + (size_t)t * n * Ls + lane;
      float kdx = 0.f;
      for (int j = 0; j < n; ++j) kdx += Ki[j * Ls] * (s[Y.X + j] - xb[j * Ls]);
      const size_t ui = ((size_t)t * m + i) * Ls + lane;
      const float uu = u_bar[ui] - e * kappa[ui] - kdx;
      s[Y.U + i] = uu;
      us[ui] = uu;
    }
    lane_step(T, Y, s);
    for (int i = 0; i < n; ++i) {
      const float v = s[Y.XN + i];
      xs[((size_t)t * n + i) * Ls + lane] = v;
      s[Y.X + i] = v;
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int megaroll_launch(const void* table, const float* x0,
                               const float* eps, const float* u_bar,
                               const float* kappa, const float* K,
                               const float* x_bar, float* xs, float* us,
                               float* scratch, int L, int Tn, void* stream) {
  const int threads = ddp_block_threads(L);
  const int blocks = (L + threads - 1) / threads;
  megaroll_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const StepTable*)table, x0, eps, u_bar, kappa, K, x_bar, xs, us,
      scratch, L, Tn);
  return (int)cudaGetLastError();
}
