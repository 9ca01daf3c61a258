// The window service shared by fleet_window.cu and window_mega.cu: all W
// ticks of two-phase NRS-TBF service on one OST row held in registers.
//
// The tick is repro.storage.simulator._serve_tick (plain version:
// repro_torch/storage/simulator.py::_serve_tick):
//   issued  = min(rate, vol_left, max(backlog - queue, 0));  queue += issued
//   phase 1 = ruled (finite-budget) jobs take min(queue, budget), scaled to
//             the tick's capacity when their wants exceed it;
//   phase 2 = unruled jobs share the capacity phase 1 left idle.
// Each tick needs three row sums: want1 and want2 in one reduction, then
// s1 in a second.
//
// Two ticks: the lean one (LEAN, B1's) and the megakernel's (B3's), which
// is this tick as it was before the lean one, kept because B3 ran some of
// its instances slower with it (PERF.md).  The lean tick gives the same
// bits with fewer instructions on the SM, which bounds it (PERF.md counts
// them by class):
// - it forms the s1 sum only where phase 1 overflows the capacity while an
//   unruled job waits (below; the fleets do in a quarter of their
//   row-ticks or fewer, PERF.md);
// - its reductions do less work for the same sums (tick_reduce): one
//   block's leave out a butterfly step that adds only zeros, a cluster's
//   add each lane's slots without a loop;
// - FULL: where every lane of the block holds a job (J = LPT * 512, or a
//   cluster row with slices of 8192) the lane tests are left out.
//
// Numerics: built with --fmad=false and without fast math, so every
// expression rounds as the plain version's does; inf behaves as in IEEE
// (min(rate, inf), inf - issued, an unruled budget stays inf).
#pragma once

#include "common.cuh"

namespace repro {

constexpr float SERVE_EPS = 1e-9f;

// The lean tick's row sums: block_reduce's on a warp.  On one block (Red)
// its second butterfly starts from slot lane % WARPS without the step over
// 16 lanes, which there adds 0.0 to slot sums that are never -0.0 (every
// partial starts at +0.0 and adds values >= 0): every lane enters the next
// step with the same double, and adds the same doubles in the same order.
template <int NF, class R>
__device__ __forceinline__ void tick_reduce(double (&f)[2], R& r) {
  int c = 0;
  block_reduce<NF, 0>(f, c, r);
}

template <int NF>
__device__ __forceinline__ void tick_reduce(double (&f)[2], Red& r) {
  static_assert(WARPS == 16, "the second butterfly covers 16 warp slots");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int set = r.n++ & 1;
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(f[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NF; ++k) r.s->f[set][warp][k] = f[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    double x = r.s->f[set][lane % WARPS][k];
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    f[k] = x;
  }
}

// On a cluster (c >= 2, so every lane has a slot): block_reduce's pushes
// and barriers (common.cuh's two-set argument holds as there), each lane
// starting from its first slot, which block_reduce adds to 0.0, and adding
// its other slots (up to MAX_CLUSTER * WARPS / 32) in the same order, the
// loop over them unrolled.
template <int NF>
__device__ __forceinline__ void tick_reduce(double (&f)[2], ClusterRed& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (r.n == 0) cluster_wait();
  const int set = r.n++ & 1;
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(f[k]);
  if (lane < r.blocks) {
    ClusterScratch* const to = peer(r.cs, lane);
    const int m = r.rank * WARPS + warp;
#pragma unroll
    for (int k = 0; k < NF; ++k) to->f[set][m][k] = f[k];
  }
  cluster_sync();
  double g[2];
#pragma unroll
  for (int k = 0; k < NF; ++k) g[k] = r.cs->f[set][lane][k];
#pragma unroll
  for (int i = 1; i < MAX_CLUSTER * WARPS / 32; ++i) {
    const int m = lane + 32 * i;
    if (m < r.blocks * WARPS) {
#pragma unroll
      for (int k = 0; k < NF; ++k) g[k] += r.cs->f[set][m][k];
    }
  }
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(g[k]);
}

// q/v/b/acc: queue, remaining volume, token budget and the window's served
// accumulator of this thread's lanes, updated in place; bl: backlog caps
// (read-only: a float[LPT] or lanes of shared memory).  rates points at
// tick 0 of this row (of this block's slice of a row over a cluster); tick
// t's row is t * tick_stride further.  Lanes at or past n_jobs (the
// block's lanes) are absent from every sum and left untouched; red: Red,
// ClusterRed for a row over a cluster, or WarpRed for a row on a warp.
// LEAN: the lean tick (above; false: the megakernel's); FULL (lean ticks
// only): every one of the LPT * THREADS lanes holds a job.
template <int LPT, bool LEAN = true, bool FULL = false, class BL, class R>
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
    rate_next[i] = n_ticks > 0 && (FULL || j < n_jobs) ? rates[j] : 0.0f;
  }
#pragma unroll 1
  for (int t = 0; t < n_ticks; ++t) {
    float rate_t[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      rate_t[i] = rate_next[i];
      if (t + 1 < n_ticks && (FULL || j < n_jobs))
        rate_next[i] = rates[static_cast<size_t>(t + 1) * tick_stride + j];
    }
    float w1[LPT];
    double part = 0.0, part2 = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      w1[i] = 0.0f;
      if (FULL || j < n_jobs) {
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
    float2 wants;
    if constexpr (LEAN) {
      double f[2] = {part, part2};
      tick_reduce<2>(f, red);
      wants = make_float2(__double2float_rn(f[0]), __double2float_rn(f[1]));
    } else {
      wants = block_sum2(part, part2, red);
    }
    const float scale1 = fminf(1.0f, cap / fmaxf(wants.x, SERVE_EPS));

    float s1[LPT];
    float scale2;
    if constexpr (LEAN) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) s1[i] = w1[i] * scale1;
      // phase 2: the fallback queue served from idle capacity only, what
      // phase 1 left of cap: cap - sum(s1), a second row sum, formed only
      // where phase 1 overflowed the capacity while an unruled job waits.
      // Elsewhere the tick gives the bits it would give with the sum:
      // - scale1 == 1: s1 = w1 * 1 is w1 bit for bit, so sum(s1) would add
      //   the same doubles in the same order as wants.x (absent lanes add
      //   +0.0 to a sum that is never -0.0) and round to wants.x;
      // - wants.y == 0: every unruled queue is 0, so w2 * scale2 is 0 (of
      //   w2's sign) for any finite scale2 >= 0, as the one below is.
      // Both tests read row totals, the same in every thread of the row's
      // block, cluster or warp, so the whole row skips the reduction
      // together (common.cuh: the slot sets count the reductions run).
      float spare = fmaxf(cap - wants.x, 0.0f);
      if (scale1 != 1.0f && wants.y != 0.0f) {
        part = 0.0;
#pragma unroll
        for (int i = 0; i < LPT; ++i) part += s1[i];
        double f[2] = {part, 0.0};
        tick_reduce<1>(f, red);
        spare = fmaxf(cap - __double2float_rn(f[0]), 0.0f);
      }
      scale2 = fminf(1.0f, spare / fmaxf(wants.y, SERVE_EPS));
    } else {
      part = 0.0;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        s1[i] = w1[i] * scale1;
        part += s1[i];
      }
      // phase 2: the fallback queue served from idle capacity only
      const float spare = fmaxf(cap - block_sum(part, red), 0.0f);
      scale2 = fminf(1.0f, spare / fmaxf(wants.y, SERVE_EPS));
    }

#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = threadIdx.x + i * THREADS;
      if (FULL || j < n_jobs) {
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
