// The window service shared by fleet_window.cu and window_mega.cu: all W
// ticks of two-phase NRS-TBF service on one OST row held in registers.
//
// The tick is repro.storage.simulator._serve_tick (plain version:
// repro_torch/storage/simulator.py::_serve_tick):
//   issued  = min(rate, vol_left, max(backlog - queue, 0));  queue += issued
//   phase 1 = ruled (finite-budget) jobs take min(queue, budget), scaled to
//             the tick's capacity when their wants exceed it;
//   phase 2 = unruled jobs share the capacity phase 1 left idle.
// Each tick needs three row sums: want1 and want2 in one reduction, then s1.
//
// Numerics: built with --fmad=false and without fast math, so every
// expression rounds as the plain version's does; inf behaves as in IEEE
// (min(rate, inf), inf - issued, an unruled budget stays inf).
#pragma once

#include "common.cuh"

namespace repro {

constexpr float SERVE_EPS = 1e-9f;

// q/v/b/acc: queue, remaining volume, token budget and the window's served
// accumulator of this thread's lanes, updated in place; bl: backlog caps
// (read-only: a float[LPT] or lanes of shared memory).  rates points at
// tick 0 of this row (of this block's slice of a row over a cluster); tick
// t's row is t * tick_stride further.  Lanes at or past n_jobs (the
// block's lanes) are absent from every sum and left untouched; red: Red,
// or ClusterRed for a row over a cluster.
template <int LPT, class BL, class R>
__device__ __forceinline__ void serve_window(float (&q)[LPT], float (&v)[LPT],
                                             float (&b)[LPT], const BL& bl,
                                             float (&acc)[LPT],
                                             const float* __restrict__ rates,
                                             size_t tick_stride, int n_ticks,
                                             float cap, int n_jobs,
                                             R& red) {
  // each tick's rate row is loaded one tick ahead, so its latency hides
  // behind the tick before (a barrier keeps loads from moving across it)
  float rate_next[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = threadIdx.x + i * THREADS;
    rate_next[i] = n_ticks > 0 && j < n_jobs ? rates[j] : 0.0f;
  }
#pragma unroll 1
  for (int t = 0; t < n_ticks; ++t) {
    float rate_t[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      rate_t[i] = rate_next[i];
      if (t + 1 < n_ticks && j < n_jobs)
        rate_next[i] = rates[static_cast<size_t>(t + 1) * tick_stride + j];
    }
    float w1[LPT];
    double part = 0.0, part2 = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      w1[i] = 0.0f;
      if (j < n_jobs) {
        // client issuance bounded by volume and backlog headroom
        const float headroom = fmaxf(bl[i] - q[i], 0.0f);
        const float issued = fminf(fminf(rate_t[i], v[i]), headroom);
        q[i] = q[i] + issued;
        v[i] = v[i] - issued;
        q[i] = fmaxf(q[i], 0.0f);
        // phase 1: token-gated service for ruled (finite-budget) jobs
        w1[i] = isfinite(b[i]) ? fminf(q[i], fmaxf(b[i], 0.0f)) : 0.0f;
        part += w1[i];
        if (!isfinite(b[i])) part2 += q[i];   // phase 2's wants
      }
    }
    const float2 wants = block_sum2(part, part2, red);
    const float scale1 = fminf(1.0f, cap / fmaxf(wants.x, SERVE_EPS));

    float s1[LPT];
    part = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      s1[i] = w1[i] * scale1;
      part += s1[i];
    }
    // phase 2: the fallback queue served from idle capacity only
    const float spare = fmaxf(cap - block_sum(part, red), 0.0f);
    const float scale2 = fminf(1.0f, spare / fmaxf(wants.y, SERVE_EPS));

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
}

}  // namespace repro
