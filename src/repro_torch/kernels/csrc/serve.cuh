// The window service shared by fleet_window.cu and window_mega.cu: all W
// ticks of two-phase NRS-TBF service on one OST row held in registers.
//
// The tick is repro.storage.simulator._serve_tick (plain version:
// repro_torch/storage/simulator.py::_serve_tick):
//   issued  = min(rate, vol_left, max(backlog - queue, 0));  queue += issued
//   phase 1 = ruled (finite-budget) jobs take min(queue, budget), scaled to
//             the tick's capacity when their wants exceed it;
//   phase 2 = unruled jobs share the capacity phase 1 left idle.
// Each tick needs three row sums (want1, s1, want2) in sequence.
//
// Numerics: built with --fmad=false and without fast math, so every
// expression rounds as the plain version's does; inf behaves as in IEEE
// (min(rate, inf), inf - issued, an unruled budget stays inf).
#pragma once

#include "common.cuh"

namespace repro {

constexpr float SERVE_EPS = 1e-9f;

// q/v/b/acc: queue, remaining volume, token budget and the window's served
// accumulator of this thread's lanes, updated in place; bl: backlog caps.
// rates points at tick 0 of this row; tick t's row is t * tick_stride
// further.  Lanes at or past n_jobs are absent from every sum and left
// untouched.
template <int LPT>
__device__ __forceinline__ void serve_window(float (&q)[LPT], float (&v)[LPT],
                                             float (&b)[LPT],
                                             const float (&bl)[LPT],
                                             float (&acc)[LPT],
                                             const float* __restrict__ rates,
                                             size_t tick_stride, int n_ticks,
                                             float cap, int n_jobs,
                                             Scratch& scratch) {
#pragma unroll 1
  for (int t = 0; t < n_ticks; ++t) {
    const float* rate_t = rates + static_cast<size_t>(t) * tick_stride;
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
    const float scale1 =
        fminf(1.0f, cap / fmaxf(block_sum(part, scratch), SERVE_EPS));

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
    const float scale2 =
        fminf(1.0f, spare / fmaxf(block_sum(part, scratch), SERVE_EPS));

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
