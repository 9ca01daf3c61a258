// One observation window of two-phase NRS-TBF service, all W ticks fused.
//
// Replaces the TPU kernel src/repro/kernels/fleet_window/kernel.py
// (fleet_window_pallas -> _kernel -> serve_window_block, whose tick is
// repro.storage.simulator._serve_tick).  Its plain PyTorch version is
// repro_torch/kernels/fleet_window/ref.py::fleet_window_ref.
//
// What bounds it on the H100: bytes.  A window reads the [W, O, J] rate
// block once and four [O, J] state arrays, and writes three [O, J] arrays,
// about (W + 7) * O * J * 4 bytes (71 MB at W=10, O=256, J=4096; 21 us at
// 3.35 TB/s).  The arithmetic is a few dozen flops per lane per tick.
// Under the byte bound sits a latency chain: each tick needs three row
// sums (sum want1, sum s1, sum want2) before the next phase can start.
//
// Design: one thread block per OST row (rows never mix; that is the paper's
// decentralization).  The per-lane state (queue, vol_left, budget, backlog
// cap, served accumulator) stays in registers across all W ticks; only the
// tick's rate row is read, coalesced, each tick, and only the window
// results are written.  Sums use common.cuh's block reductions.
//
// Numerics: built with --fmad=false and without fast math, so every
// expression rounds as the plain version's does; inf behaves as in IEEE
// (min(rate, inf), inf - issued, an unruled budget stays inf).  Row sums
// accumulate in double and round once, as the plain version's do; in
// other orders, so the two agree to a float32 ulp (in practice bitwise);
// against the reference's float32 sums, values differ by ulps.
#include "common.cuh"

namespace {

using namespace repro;

constexpr float EPS = 1e-9f;

template <int LPT>
__global__ void __launch_bounds__(THREADS)
fleet_window_kernel(const float* __restrict__ queue_in,
                    const float* __restrict__ vol_in,
                    const float* __restrict__ budget_in,
                    const float* __restrict__ backlog,
                    const float* __restrict__ rates,
                    const float* __restrict__ cap_tick,
                    float* __restrict__ queue_out,
                    float* __restrict__ vol_out,
                    float* __restrict__ served_out,
                    int n_ost, int n_jobs, int n_ticks) {
  __shared__ Scratch scratch;
  const int o = blockIdx.x;
  const size_t row = static_cast<size_t>(o) * n_jobs;
  const float cap = cap_tick[o];

  float q[LPT], v[LPT], b[LPT], bl[LPT], acc[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = threadIdx.x + i * THREADS;
    const bool in = j < n_jobs;
    q[i] = in ? queue_in[row + j] : 0.0f;
    v[i] = in ? vol_in[row + j] : 0.0f;
    b[i] = in ? budget_in[row + j] : 0.0f;
    bl[i] = in ? backlog[row + j] : 0.0f;
    acc[i] = 0.0f;
  }

#pragma unroll 1
  for (int t = 0; t < n_ticks; ++t) {
    const float* rate_t = rates + (static_cast<size_t>(t) * n_ost + o) * n_jobs;
    float w1[LPT];
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      w1[i] = 0.0f;
      if (j < n_jobs) {
        // client issuance bounded by volume and backlog headroom
        const float headroom = fmaxf(bl[i] - q[i], 0.0f);
        const float issued = fminf(fminf(rate_t[j], v[i]), headroom);
        q[i] = q[i] + issued;
        v[i] = v[i] - issued;
        q[i] = fmaxf(q[i], 0.0f);
        // phase 1: token-gated service for ruled (finite-budget) jobs
        w1[i] = isfinite(b[i]) ? fminf(q[i], fmaxf(b[i], 0.0f)) : 0.0f;
        part += w1[i];
      }
    }
    const float scale1 = fminf(1.0f, cap / fmaxf(block_sum(part, scratch), EPS));

    float s1[LPT];
    part = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      s1[i] = w1[i] * scale1;
      part += s1[i];
    }
    // phase 2: the fallback queue served from idle capacity only
    const float spare = fmaxf(cap - block_sum(part, scratch), 0.0f);

    part = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (j < n_jobs && !isfinite(b[i])) part += q[i];
    }
    const float scale2 = fminf(1.0f, spare / fmaxf(block_sum(part, scratch), EPS));

#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (j < n_jobs) {
        const float w2 = isfinite(b[i]) ? 0.0f : q[i];
        // clamp: proportional scaling can overshoot the queue by an ulp
        const float served = fminf(s1[i] + w2 * scale2, q[i]);
        q[i] = q[i] - served;
        b[i] = b[i] - served;  // inf stays inf for unruled jobs
        acc[i] = acc[i] + served;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = threadIdx.x + i * THREADS;
    if (j < n_jobs) {
      queue_out[row + j] = q[i];
      vol_out[row + j] = v[i];
      served_out[row + j] = acc[i];
    }
  }
}

}  // namespace

// queue/vol/budget/backlog: [O, J]; rates: [W, O, J]; cap_tick: [O];
// outputs [O, J].  Launches on `stream`, does not synchronise, allocates
// nothing; returns the launch's cudaError_t.
extern "C" int fleet_window(const float* queue, const float* vol,
                            const float* budget, const float* backlog,
                            const float* rates, const float* cap_tick,
                            float* queue_out, float* vol_out,
                            float* served_out, int n_ost, int n_jobs,
                            int n_ticks, void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_J || n_ost < 1 || n_ticks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_LPT(n_jobs, fleet_window_kernel<LPT><<<n_ost, THREADS, 0, s>>>(
      queue, vol, budget, backlog, rates, cap_tick, queue_out, vol_out,
      served_out, n_ost, n_jobs, n_ticks));
  return static_cast<int>(cudaGetLastError());
}
