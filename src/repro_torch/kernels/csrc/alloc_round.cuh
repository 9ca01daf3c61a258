// The AdapTBF allocation round (paper Eq. 1-25) on one OST row, shared by
// adaptbf_alloc.cu and window_mega.cu.
//
// The round is repro.kernels.adaptbf_alloc.kernel._alloc_block with
// repro.core.remainder.integerize and topk_mask traced inline (plain
// version: repro_torch/core/adaptbf.py::alloc_rows).  What bounds it on the
// H100 is not its bytes but its chain of dependent row reductions, each a
// barrier (common.cuh).  The reference's searches take ~75 of them a
// largest-remainder distribution (a 25-bit descent, 32 threshold probes,
// log2(J) tie-break probes); here a distribution takes at most 6 (11 when
// its floors overshoot the budget):
//   - the row sum of the floors and the masked count share one reduction;
//   - topk_mask is a radix select over the same order map: up to four
//     passes of an 8-bit digit, each a 256-bin row histogram in shared
//     memory (shared atomics: aggregating them by __match_any_sync was
//     slower) that every warp scans for the digit and the rank left below
//     it, stopping once every lane sharing the digits found is selected;
//     the tied lanes' rank by index is one ballot prefix count (index
//     order is lane slot, warp, lane), only when the seats left are fewer
//     than the ties;
//   - the excess descent (only when the floors overshoot the budget)
//     evaluates g(r) = sum min(fl, r) at 31 candidates a pass, 5 bits at a
//     time, in 5 passes: a warp reduce-scatter of the candidates' integer
//     partials, one barrier, one candidate a lane;
// and the round's own row sums pair up where independent (11 reductions
// become 6).  Every search finds the unique answer of the reference's: the
// k largest keys with ties to the lowest index, the threshold, the excess
// round count p.
//
// Numerics: the integer path is bitwise with the reference.  Counts are
// int32; the excess sums are of integers below 2^25, exact in any order and
// rounded to float as the reference's float32 sums are below 2^24; rintf
// rounds half to even as jnp.round does; __float_as_int is the bit map;
// delta is clipped to +-2^30 before the int cast.  Built with --fmad=false
// and without fast math, so `u + u * p` and friends round as in the
// reference; every float constant carries an f suffix.  Float row sums
// accumulate in double and round once, as the plain version's do.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float ALLOC_EPS = 1e-12f;
constexpr float TWO30 = 1073741824.0f;  // 2^30
constexpr float TWO25 = 33554432.0f;    // 2^25: above every descent candidate

__device__ __forceinline__ int lane_of(int i) { return threadIdx.x + i * THREADS; }

// Zero the radix tables before the block's first search (a reduction's
// barrier must come between).  Search n counts into table set n & 1 and
// zeroes the other set, which search n - 1 used: a barrier (the
// distribution's first reduction) separates every two searches.
__device__ __forceinline__ void search_init(Scratch& s) {
  for (int k = threadIdx.x; k < 2 * 4 * 256; k += THREADS) (&s.hist[0][0][0])[k] = 0;
}

// Membership of the k largest keys of the row, ties to the lowest index.
// Every lane below n_jobs is ranked (-inf keys too, as in the reference).
template <int LPT>
__device__ __forceinline__ void topk_mask(const float (&key)[LPT], int k,
                                          bool (&sel)[LPT], int n_jobs,
                                          Red& r) {
  Scratch& s = *r.s;
  const int set = r.searches++ & 1;
  for (int k2 = threadIdx.x; k2 < 4 * 256; k2 += THREADS)
    (&s.hist[set ^ 1][0][0])[k2] = 0;
  if (k <= 0 || k >= n_jobs) {  // nothing, or every lane of the row
#pragma unroll
    for (int i = 0; i < LPT; ++i) sel[i] = k > 0 && lane_of(i) < n_jobs;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned u[LPT];  // the reference's int32 order map, as unsigned order
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float kv = key[i] == 0.0f ? 0.0f : key[i];  // -0.0 ties +0.0
    const int bits = __float_as_int(kv);
    u[i] = static_cast<unsigned>(bits >= 0 ? bits : bits ^ 0x7FFFFFFF) ^
           0x80000000u;
  }
  // the threshold (the k-th largest key) digit by digit, and krem, its
  // rank among the lanes that share the digits found so far
  unsigned pre = 0;
  int krem = k, n_tied = 0;
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    int* const hist = s.hist[set][pass];
    const unsigned hi = pass == 0 ? 0u : 0xFFFFFFFFu << (shift + 8);
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if (lane_of(i) < n_jobs && (u[i] & hi) == pre)
        atomicAdd(&hist[(u[i] >> shift) & 255u], 1);
    __syncthreads();
    // every warp: lane l holds digits 8l .. 8l+7; the threshold's digit d
    // has count(digit > d) < krem <= count(digit >= d)
    int b[8], tot = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      b[e] = hist[8 * lane + e];
      tot += b[e];
    }
    int incl = tot;  // lanes l .. 31: digits 8l .. 255
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += o;
    }
    int acc = incl - tot, d = 0, above = 0;
    bool found = false;
#pragma unroll
    for (int e = 7; e >= 0; --e) {
      if (!found && acc + b[e] >= krem) {
        found = true;
        d = 8 * lane + e;
        above = acc;
      }
      acc += b[e];
    }
    const int src =
        __ffs(__ballot_sync(0xffffffffu, incl - tot < krem && krem <= incl)) - 1;
    d = __shfl_sync(0xffffffffu, d, src);
    krem -= __shfl_sync(0xffffffffu, above, src);
    pre |= static_cast<unsigned>(d) << shift;
    n_tied = hist[d];
    if (n_tied == krem) {  // every lane sharing the digits so far is in
      const unsigned mask = 0xFFFFFFFFu << shift;
#pragma unroll
      for (int i = 0; i < LPT; ++i)
        sel[i] = lane_of(i) < n_jobs && (u[i] & mask) >= pre;
      return;
    }
  }
  // the krem (< n_tied) lowest-index lanes equal to the threshold: a tied
  // lane's rank is the count of tied lanes before it in index order (lane
  // slot, warp, lane)
  unsigned tied[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    tied[i] = __ballot_sync(0xffffffffu, lane_of(i) < n_jobs && u[i] == pre);
    if (lane == 0) s.tie[i][warp] = __popc(tied[i]);
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  int base = 0;  // tied lanes in earlier lane slots
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int v = lane < WARPS ? s.tie[i][lane] : 0;
    const int rank = base + warp_count(lane < warp ? v : 0) +
                     __popc(tied[i] & below);
    base += warp_count(v);
    sel[i] = lane_of(i) < n_jobs &&
             (u[i] > pre || (((tied[i] >> lane) & 1u) && rank < krem));
  }
}

// The excess rounds: p, the largest r < 2^25 with g(r) = sum min(fl, r) <=
// d_dn, and g(p) as a float (g is nondecreasing, g(0) = 0).  Five passes
// of 5 bits: candidates p + c 2^shift (c = 0..31, c = 0 is p itself), each
// thread's integer partials reduce-scattered over the warp in groups of 8,
// one barrier, then lane c sums candidate c over the warps.
template <int LPT>
__device__ __forceinline__ void excess_rounds(const float (&fl)[LPT],
                                              float d_dn, int& p, float& g_p,
                                              Red& r) {
  Scratch& s = *r.s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned f[LPT];  // min(fl, 2^25): a thread's partial stays below 2^29
#pragma unroll
  for (int i = 0; i < LPT; ++i) f[i] = static_cast<unsigned>(fminf(fl[i], TWO25));
  p = 0;
  g_p = 0.0f;
#pragma unroll 1
  for (int pass = 0; pass < 5; ++pass) {
    const int shift = 20 - 5 * pass;
    unsigned long long(*const cand)[32] = s.cand[pass & 1];
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {
      unsigned v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const unsigned c = static_cast<unsigned>(p) + ((grp * 8u + e) << shift);
        unsigned sum = 0;
#pragma unroll
        for (int i = 0; i < LPT; ++i) sum += min(f[i], c);
        v[e] = sum;
      }
      // lanes whose bits 4..2 read e end with candidate e's sum over 8
      // threads (below 2^32), then over the warp in 64 bits
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool up = lane & 16;
        const unsigned o = __shfl_xor_sync(0xffffffffu, up ? v[e] : v[e + 4], 16);
        v[e] = (up ? v[e + 4] : v[e]) + o;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool up = lane & 8;
        const unsigned o = __shfl_xor_sync(0xffffffffu, up ? v[e] : v[e + 2], 8);
        v[e] = (up ? v[e + 2] : v[e]) + o;
      }
      {
        const bool up = lane & 4;
        const unsigned o = __shfl_xor_sync(0xffffffffu, up ? v[0] : v[1], 4);
        v[0] = (up ? v[1] : v[0]) + o;
      }
      unsigned long long w = v[0];
      w += __shfl_xor_sync(0xffffffffu, w, 2);
      w += __shfl_xor_sync(0xffffffffu, w, 1);
      if ((lane & 3) == 0) cand[warp][grp * 8 + (lane >> 2)] = w;
    }
    // the table alternates between passes: it was last read two passes
    // ago, before the barrier of the pass between
    __syncthreads();
    unsigned long long tot = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) tot += cand[k][lane];
    const float gc = __ull2float_rn(tot);
    const int best = 31 - __clz(__ballot_sync(0xffffffffu, gc <= d_dn));
    g_p = __shfl_sync(0xffffffffu, gc, best);
    p += best << shift;
  }
}

// Floor raw + remainder over the mask and correct largest-remainder-first
// so the masked total equals `budget`; updates the remainder carry.
// Callers pass mask = false for lanes past J.
template <int LPT>
__device__ __forceinline__ void integerize(const float (&raw)[LPT],
                                           float (&remainder)[LPT],
                                           float budget,
                                           const bool (&mask)[LPT],
                                           float (&alloc)[LPT], int n_jobs,
                                           Red& r) {
  float fl[LPT], rem[LPT];
  double part = 0.0;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float x = mask[i] ? raw[i] + remainder[i] : 0.0f;
    fl[i] = fmaxf(floorf(x), 0.0f);
    rem[i] = mask[i] ? x - fl[i] : 0.0f;
    part += fl[i];
    cnt += mask[i];
  }
  float fl_sum;
  int n_masked;
  block_sum_count(part, cnt, r, fl_sum, n_masked);
  const float delta = rintf(budget - fl_sum);
  const int delta_i = static_cast<int>(fminf(fmaxf(delta, -TWO30), TWO30));

  // leftover: q full rounds plus a partial top-k round
  const int d_up = max(delta_i, 0);
  const int q = d_up / max(n_masked, 1);
  const int k_up = d_up - q * n_masked;

  // excess: p full take-one rounds, then a partial top-k round (only a
  // row whose floors overshoot its budget reads them)
  const float d_dn = fmaxf(-delta, 0.0f);
  int p = 0;
  float g_p = 0.0f;
  if (delta < 0.0f) excess_rounds<LPT>(fl, d_dn, p, g_p, r);
  const float p_f = static_cast<float>(p);
  const int k_dn = static_cast<int>(fminf(d_dn - g_p, TWO30));

  // one merged membership search: the up key/count when delta > 0, the
  // down key/count otherwise
  const bool is_up = delta > 0.0f;
  float key[LPT];
  bool elig[LPT], sel[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    elig[i] = mask[i] && fl[i] >= p_f + 1.0f;
    key[i] = (is_up ? mask[i] : elig[i]) ? rem[i] : __int_as_float(0xff800000);  // -inf
  }
  topk_mask<LPT>(key, is_up ? k_up : k_dn, sel, n_jobs, r);

  const float qf = static_cast<float>(q);
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float bump_up = qf * (mask[i] ? 1.0f : 0.0f) + ((sel[i] && mask[i]) ? 1.0f : 0.0f);
    const float bump_dn = fminf(fl[i], p_f) + ((sel[i] && elig[i]) ? 1.0f : 0.0f);
    const float applied = delta > 0.0f ? bump_up : (delta < 0.0f ? -bump_dn : 0.0f);
    alloc[i] = fl[i] + applied;
    if (mask[i]) remainder[i] = rem[i] - applied;
  }
}

// The distribution primitive: integerize, or with float tokens the
// reference's passthrough (raw over the mask, remainder unchanged).
template <int LPT>
__device__ __forceinline__ void distribute(bool integer_tokens,
                                           const float (&raw)[LPT],
                                           float (&remainder)[LPT],
                                           float budget,
                                           const bool (&mask)[LPT],
                                           float (&alloc)[LPT], int n_jobs,
                                           Red& r) {
  if (integer_tokens) {
    integerize<LPT>(raw, remainder, budget, mask, alloc, n_jobs, r);
  } else {
#pragma unroll
    for (int i = 0; i < LPT; ++i) alloc[i] = mask[i] ? raw[i] : 0.0f;
  }
}

// One allocation round of this block's row.  demand holds the row's demand
// in this thread's lanes (0 past n_jobs); the other inputs are read from
// the row pointers.  Writes the next allocation, the new record and the new
// remainder of this thread's lanes into alloc, record_out and rem.
template <int LPT>
__device__ __forceinline__ void adaptbf_round(
    const float (&demand)[LPT], const float* __restrict__ nodes_row,
    const float* __restrict__ record_row,
    const float* __restrict__ remainder_row,
    const float* __restrict__ prev_row, float cap, float u_max,
    bool integer_tokens, float (&alloc)[LPT], float (&record_out)[LPT],
    float (&rem)[LPT], int n_jobs, Red& r) {
  float record[LPT], p[LPT];
  bool active[LPT];
  double part = 0.0;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    const bool in = j < n_jobs;
    record[i] = in ? record_row[j] : 0.0f;
    rem[i] = in ? remainder_row[j] : 0.0f;
    active[i] = in && demand[i] > 0.0f;
    p[i] = active[i] ? nodes_row[j] : 0.0f;  // n_act
    part += p[i];
    cnt += active[i];
  }

  // step 1: priority-based initial allocation (Eq. 1-2)
  float n_sum;
  int n_active;
  block_sum_count(part, cnt, r, n_sum, n_active);
  const float n_tot = fmaxf(n_sum, ALLOC_EPS);
  const float budget1 = n_active > 0 ? cap : 0.0f;
  float raw[LPT], alpha[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    p[i] = p[i] / n_tot;
    raw[i] = budget1 * p[i];
  }
  distribute<LPT>(integer_tokens, raw, rem, budget1, active, alpha, n_jobs, r);

  // step 2: surplus redistribution (Eq. 3-8); the surplus and demand-factor
  // totals in one reduction
  float u[LPT], surplus[LPT], df[LPT];
  part = 0.0;
  double part_df = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    const float prev = j < n_jobs ? prev_row[j] : 0.0f;
    u[i] = active[i] ? fminf(demand[i] / fmaxf(prev, 1.0f), u_max) : 0.0f;
    surplus[i] = active[i] ? fmaxf(alpha[i] - demand[i], 0.0f) : 0.0f;
    part += surplus[i];
    const float d = u[i] > 1.0f ? u[i] + u[i] * p[i] : u[i] * p[i];
    df[i] = active[i] ? d : 0.0f;
    part_df += df[i];
  }
  const float2 s2 = block_sum2(part, part_df, r);
  const float t_s = s2.x;
  const float df_tot = fmaxf(s2.y, ALLOC_EPS);
#pragma unroll
  for (int i = 0; i < LPT; ++i) raw[i] = df[i] / df_tot * t_s;
  float add[LPT], r_rd[LPT];
  distribute<LPT>(integer_tokens, raw, rem, t_s, active, add, n_jobs, r);
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    alpha[i] = alpha[i] - surplus[i] + add[i];   // alpha_RD (Eq. 7)
    r_rd[i] = record[i] + surplus[i] - add[i];   // r_RD (Eq. 8)
  }

  // step 3: re-compensation (Eq. 9-20); c with the lenders' demand-factor
  // total, then the reclaim with what lenders are owed
  bool j_plus[LPT];
  part = 0.0;
  part_df = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    j_plus[i] = active[i] && record[i] > 0.0f && r_rd[i] > 0.0f;
    const float u_future = demand[i] / fmaxf(alpha[i], 1.0f);
    const float c_term = p[i] * (fmaxf(1.0f, u[i]) + fmaxf(0.0f, 1.0f - u_future)) / 2.0f;
    part += j_plus[i] ? c_term : 0.0f;
    df[i] = j_plus[i] ? df[i] : 0.0f;  // df_plus: RF = DF (Eq. 18)
    part_df += df[i];
  }
  const float2 s3 = block_sum2(part, part_df, r);
  const float c = s3.x;
  const float dfp_tot = fmaxf(s3.y, ALLOC_EPS);
  float reclaim[LPT], owed[LPT];
  double part_owed = 0.0;
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const bool j_minus = active[i] && record[i] < 0.0f && r_rd[i] < 0.0f;
    float rc = fminf(fabsf(record[i]), fabsf(c * alpha[i]));
    rc = fminf(rc, alpha[i]);
    reclaim[i] = j_minus ? rc : 0.0f;
    owed[i] = j_plus[i] ? r_rd[i] : 0.0f;
    part += reclaim[i];
    part_owed += owed[i];
  }
  // total reclaim capped at what active lenders are owed (deviation 3)
  const float2 s4 = block_sum2(part, part_owed, r);
  const float rc_tot = fmaxf(s4.x, ALLOC_EPS);
  const float rc_scale = fminf(1.0f, s4.y / rc_tot);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    reclaim[i] = reclaim[i] * rc_scale;
    if (integer_tokens) reclaim[i] = floorf(reclaim[i]);
    part += reclaim[i];
  }
  const float t_r = block_sum(part, r);
  part = 0.0;
  double part_head = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    add[i] = fminf(df[i] / dfp_tot * t_r, owed[i]);  // per-lender cap
    part += add[i];
    part_head += owed[i] - add[i];
  }
  const float2 s5 = block_sum2(part, part_head, r);
  const float leftover = t_r - s5.x;
  const float head_tot = fmaxf(s5.y, ALLOC_EPS);
#pragma unroll
  for (int i = 0; i < LPT; ++i)
    raw[i] = add[i] + leftover * (owed[i] - add[i]) / head_tot;
  distribute<LPT>(integer_tokens, raw, rem, t_r, j_plus, add, n_jobs, r);

#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float alpha_rc = alpha[i] - reclaim[i] + add[i];
    alloc[i] = active[i] ? alpha_rc : 0.0f;
    record_out[i] = r_rd[i] + reclaim[i] - add[i];
  }
}

}  // namespace repro
