// megaroll with its step's phases clocked: where a launch's time goes.
//
// The megaroll kernel of megaroll.cu, instantiated with a team type whose
// lap() adds the clock64() cycles since the team's previous lap to a
// per-phase total (StepPhase in lanestep.cuh), on the team's first
// thread.  A phase ends at a team sync, so the first thread's cycles are
// the team's.  The totals are over all lanes and steps of one launch.
// Diagnostics only: chip_smoke.py prints them beside megaroll's time.
//
// Build: as megaroll.cu.

#include "megaroll.cu"

__device__ unsigned long long ddp_phase_cycles[PH_COUNT];

// The SM's cycle counter (declared for the device pass only).
__device__ inline long long ddp_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}

__device__ inline void ddp_add_cycles(int phase, long long cycles) {
#ifdef __CUDA_ARCH__
  atomicAdd(&ddp_phase_cycles[phase], (unsigned long long)cycles);
#endif
}

template <int N>
struct ClockedTeam : Team<N> {
  mutable long long t;
  __device__ ClockedTeam(int rank, int barrier)
      : Team<N>(rank, barrier), t(ddp_clock()) {}
  __device__ void lap(int phase) const {
    const long long now = ddp_clock();
    if (this->r == 0) ddp_add_cycles(phase, now - t);
    t = now;
  }
};

// One clocked launch on `stream`, synchronised; the per-phase cycle
// totals go to cycles[PH_COUNT].  Returns a CUDA error code (0 = ok).
extern "C" int megaroll_clocks_launch(const void* table, const float* x0,
                                      const float* eps, const float* u_bar,
                                      const float* kappa, const float* K,
                                      const float* x_bar, float* xs,
                                      float* us, int L, int Tn, int per_lane,
                                      int n, int m,
                                      unsigned long long* cycles,
                                      void* stream) {
  const unsigned long long zero[PH_COUNT] = {};
  int err = (int)cudaMemcpyToSymbolAsync(ddp_phase_cycles, zero, sizeof(zero),
                                         0, cudaMemcpyHostToDevice,
                                         (cudaStream_t)stream);
  if (err) return err;
  err = megaroll_launch_team<ClockedTeam<DDP_TEAM>>(
      table, x0, eps, u_bar, kappa, K, x_bar, xs, us, L, Tn, per_lane, n, m,
      stream);
  if (err) return err;
  err = (int)cudaMemcpyFromSymbolAsync(cycles, ddp_phase_cycles,
                                       sizeof(zero), 0,
                                       cudaMemcpyDeviceToHost,
                                       (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}
