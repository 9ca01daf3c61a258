// The AdapTBF allocation round (paper Eq. 1-25) on one OST row, shared by
// adaptbf_alloc.cu and window_mega.cu.
//
// The round is repro.kernels.adaptbf_alloc.kernel._alloc_block with
// repro.core.remainder.integerize and topk_mask traced inline (plain
// version: repro_torch/core/adaptbf.py::alloc_rows).  Each of its three
// largest-remainder distributions takes about 75 dependent row-wide counts
// or sums: a 25-bit descent for the excess rounds, 32 threshold probes on
// the float bit pattern and log2(J) index tie-break probes.
//
// Numerics: the integer path is bitwise with the reference.  Counts are
// int32; the excess descent sums integer-valued floats below 2^24, exact in
// any order; rintf rounds half to even as jnp.round does; __float_as_int is
// the bit map; delta is clipped to +-2^30 before the int cast.  Built with
// --fmad=false and without fast math, so `u + u * p` and friends round as in
// the reference; every float constant carries an f suffix.  Float row sums
// accumulate in double and round once, as the plain version's do.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float ALLOC_EPS = 1e-12f;
constexpr float TWO30 = 1073741824.0f;  // 2^30
constexpr int P_BITS = 25;              // excess-round descent width
constexpr int INT32_MIN_ = -2147483647 - 1;

__device__ __forceinline__ int lane_of(int i) { return threadIdx.x + i * THREADS; }

// Membership of the k largest keys of the row, ties to the lowest index.
template <int LPT>
__device__ __forceinline__ void topk_mask(const float (&key)[LPT], int k,
                                          bool (&sel)[LPT], int n_jobs,
                                          Scratch& s) {
  int ordv[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float kv = key[i] == 0.0f ? 0.0f : key[i];  // -0.0 ties +0.0
    const int bits = __float_as_int(kv);
    ordv[i] = bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
  }
  int c = 0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) c += (lane_of(i) < n_jobs && ordv[i] >= 0);
  // threshold: the largest t with count(ordv >= t) >= k
  int t = block_count(c, s) >= k ? 0 : INT32_MIN_;
#pragma unroll 1
  for (int bit = 30; bit >= 0; --bit) {
    const int cand = t | (1 << bit);
    c = 0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) c += (lane_of(i) < n_jobs && ordv[i] >= cand);
    if (block_count(c, s) >= k) t = cand;
  }
  c = 0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) c += (lane_of(i) < n_jobs && ordv[i] > t);
  const int needed = k - block_count(c, s);
  // tie-break: the largest index bound m with fewer than `needed` tied
  // entries below it
  int m = 0;
  const int tie_bits = 32 - __clz(max(n_jobs - 1, 1));
#pragma unroll 1
  for (int bit = tie_bits - 1; bit >= 0; --bit) {
    const int cand = m | (1 << bit);
    c = 0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = lane_of(i);
      c += (j < n_jobs && ordv[i] == t && j < cand);
    }
    if (block_count(c, s) < needed) m = cand;
  }
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    sel[i] = j < n_jobs &&
             (ordv[i] > t || (ordv[i] == t && j <= m && needed > 0));
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
                                           Scratch& s) {
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
  const float delta = rintf(budget - block_sum(part, s));
  const int delta_i = static_cast<int>(fminf(fmaxf(delta, -TWO30), TWO30));
  const int n_masked = block_count(cnt, s);

  // leftover: q full rounds plus a partial top-k round
  const int d_up = max(delta_i, 0);
  const int q = d_up / max(n_masked, 1);
  const int k_up = d_up - q * n_masked;

  // excess: p full take-one rounds, p by bit-descent on g(r) = sum min(fl, r)
  const float d_dn = fmaxf(-delta, 0.0f);
  int p = 0;
#pragma unroll 1
  for (int bit = P_BITS - 1; bit >= 0; --bit) {
    const int cand = p | (1 << bit);
    const float cf = static_cast<float>(cand);
    double g = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) g += fminf(fl[i], cf);
    if (block_sum(g, s) <= d_dn) p = cand;
  }
  const float p_f = static_cast<float>(p);
  double g = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) g += fminf(fl[i], p_f);
  const int k_dn = static_cast<int>(fminf(d_dn - block_sum(g, s), TWO30));

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
  topk_mask<LPT>(key, is_up ? k_up : k_dn, sel, n_jobs, s);

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
                                           Scratch& s) {
  if (integer_tokens) {
    integerize<LPT>(raw, remainder, budget, mask, alloc, n_jobs, s);
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
    float (&rem)[LPT], int n_jobs, Scratch& s) {
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
  const bool any_active = block_count(cnt, s) > 0;
  const float n_tot = fmaxf(block_sum(part, s), ALLOC_EPS);
  const float budget1 = any_active ? cap : 0.0f;
  float raw[LPT], alpha[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    p[i] = p[i] / n_tot;
    raw[i] = budget1 * p[i];
  }
  distribute<LPT>(integer_tokens, raw, rem, budget1, active, alpha, n_jobs, s);

  // step 2: surplus redistribution (Eq. 3-8)
  float u[LPT], surplus[LPT], df[LPT];
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    const float prev = j < n_jobs ? prev_row[j] : 0.0f;
    u[i] = active[i] ? fminf(demand[i] / fmaxf(prev, 1.0f), u_max) : 0.0f;
    surplus[i] = active[i] ? fmaxf(alpha[i] - demand[i], 0.0f) : 0.0f;
    part += surplus[i];
  }
  const float t_s = block_sum(part, s);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float d = u[i] > 1.0f ? u[i] + u[i] * p[i] : u[i] * p[i];
    df[i] = active[i] ? d : 0.0f;
    part += df[i];
  }
  const float df_tot = fmaxf(block_sum(part, s), ALLOC_EPS);
#pragma unroll
  for (int i = 0; i < LPT; ++i) raw[i] = df[i] / df_tot * t_s;
  float add[LPT], r_rd[LPT];
  distribute<LPT>(integer_tokens, raw, rem, t_s, active, add, n_jobs, s);
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    alpha[i] = alpha[i] - surplus[i] + add[i];   // alpha_RD (Eq. 7)
    r_rd[i] = record[i] + surplus[i] - add[i];   // r_RD (Eq. 8)
  }

  // step 3: re-compensation (Eq. 9-20)
  bool j_plus[LPT];
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    j_plus[i] = active[i] && record[i] > 0.0f && r_rd[i] > 0.0f;
    const float u_future = demand[i] / fmaxf(alpha[i], 1.0f);
    const float c_term = p[i] * (fmaxf(1.0f, u[i]) + fmaxf(0.0f, 1.0f - u_future)) / 2.0f;
    part += j_plus[i] ? c_term : 0.0f;
  }
  const float c = block_sum(part, s);
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
  const float rc_tot = fmaxf(block_sum(part, s), ALLOC_EPS);
  const float t_owed = block_sum(part_owed, s);
  const float rc_scale = fminf(1.0f, t_owed / rc_tot);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    reclaim[i] = reclaim[i] * rc_scale;
    if (integer_tokens) reclaim[i] = floorf(reclaim[i]);
    part += reclaim[i];
  }
  const float t_r = block_sum(part, s);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    df[i] = j_plus[i] ? df[i] : 0.0f;  // df_plus: RF = DF (Eq. 18)
    part += df[i];
  }
  const float dfp_tot = fmaxf(block_sum(part, s), ALLOC_EPS);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    add[i] = fminf(df[i] / dfp_tot * t_r, owed[i]);  // per-lender cap
    part += add[i];
  }
  const float leftover = t_r - block_sum(part, s);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) part += owed[i] - add[i];
  const float head_tot = fmaxf(block_sum(part, s), ALLOC_EPS);
#pragma unroll
  for (int i = 0; i < LPT; ++i)
    raw[i] = add[i] + leftover * (owed[i] - add[i]) / head_tot;
  distribute<LPT>(integer_tokens, raw, rem, t_r, j_plus, add, n_jobs, s);

#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float alpha_rc = alpha[i] - reclaim[i] + add[i];
    alloc[i] = active[i] ? alpha_rc : 0.0f;
    record_out[i] = r_rd[i] + reclaim[i] - add[i];
  }
}

}  // namespace repro
