// The AdapTBF allocation round (paper Eq. 1-25) for every OST row.
//
// Replaces the TPU kernel src/repro/kernels/adaptbf_alloc/kernel.py
// (fleet_alloc_pallas -> _kernel -> _alloc_block, with
// repro.core.remainder.integerize and topk_mask traced inline).  Its plain
// PyTorch version is repro_torch/core/adaptbf.py::alloc_rows (through
// repro_torch/kernels/adaptbf_alloc/ref.py).
//
// What bounds it on the H100: neither bytes (five [O, J] inputs and three
// outputs, 34 MB at O=256, J=4096: 10 us at 3.35 TB/s) nor arithmetic, but
// the latency of its chain of row reductions.  Each of the three
// largest-remainder distributions takes about 75 dependent row-wide
// counts or sums: a 25-bit descent for the excess rounds, 32 threshold
// probes on the float bit pattern and log2(J) index tie-break probes.
// Every one is a barrier-separated block reduction.
//
// Design: one thread block per OST row, the whole round in one launch, so
// no intermediate leaves registers.  Thread t owns lanes t + i * THREADS;
// lanes past J are absent from every sum and count (J is not padded: padded
// lanes would enter the top-k counts).  A reduction is a warp butterfly and
// one shared slot per warp (common.cuh), and every thread receives the same
// total, so each probe's branch is uniform across the block.  Making the
// chain shorter (fewer probes, several rows per block) is later work.
//
// Numerics: the integer path is bitwise with the reference.  Counts are
// int32; the excess descent sums integer-valued floats below 2^24, exact in
// any order; rintf rounds half to even as jnp.round does; __float_as_int is
// the bit map; delta is clipped to +-2^30 before the int cast.  Built with
// --fmad=false and without fast math, so `u + u * p` and friends round as in
// the reference; every float constant carries an f suffix.  Float row sums
// accumulate in double and round once, as the plain version's do; in
// other orders, so the two agree to a float32 ulp (in practice bitwise);
// against the reference's float32 sums, shares differ by ulps.
#include "common.cuh"

namespace {

using namespace repro;

constexpr float EPS = 1e-12f;
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

template <int LPT>
__global__ void __launch_bounds__(THREADS)
adaptbf_alloc_kernel(const float* __restrict__ demand_g,
                     const float* __restrict__ nodes_g,
                     const float* __restrict__ record_g,
                     const float* __restrict__ remainder_g,
                     const float* __restrict__ prev_g,
                     const float* __restrict__ cap_g,
                     float* __restrict__ alloc_out,
                     float* __restrict__ record_out,
                     float* __restrict__ remainder_out,
                     int n_jobs, float u_max) {
  __shared__ Scratch s;
  const size_t row = static_cast<size_t>(blockIdx.x) * n_jobs;
  const float cap = cap_g[blockIdx.x];

  float demand[LPT], record[LPT], rem[LPT], p[LPT];
  bool active[LPT];
  double part = 0.0;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    const bool in = j < n_jobs;
    demand[i] = in ? demand_g[row + j] : 0.0f;
    record[i] = in ? record_g[row + j] : 0.0f;
    rem[i] = in ? remainder_g[row + j] : 0.0f;
    active[i] = in && demand[i] > 0.0f;
    p[i] = active[i] ? nodes_g[row + j] : 0.0f;  // n_act
    part += p[i];
    cnt += active[i];
  }

  // step 1: priority-based initial allocation (Eq. 1-2)
  const bool any_active = block_count(cnt, s) > 0;
  const float n_tot = fmaxf(block_sum(part, s), EPS);
  const float budget1 = any_active ? cap : 0.0f;
  float raw[LPT], alpha[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    p[i] = p[i] / n_tot;
    raw[i] = budget1 * p[i];
  }
  integerize<LPT>(raw, rem, budget1, active, alpha, n_jobs, s);

  // step 2: surplus redistribution (Eq. 3-8)
  float u[LPT], surplus[LPT], df[LPT];
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    const float prev = j < n_jobs ? prev_g[row + j] : 0.0f;
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
  const float df_tot = fmaxf(block_sum(part, s), EPS);
#pragma unroll
  for (int i = 0; i < LPT; ++i) raw[i] = df[i] / df_tot * t_s;
  float add[LPT], r_rd[LPT];
  integerize<LPT>(raw, rem, t_s, active, add, n_jobs, s);
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
  const float rc_tot = fmaxf(block_sum(part, s), EPS);
  const float t_owed = block_sum(part_owed, s);
  const float rc_scale = fminf(1.0f, t_owed / rc_tot);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    reclaim[i] = floorf(reclaim[i] * rc_scale);
    part += reclaim[i];
  }
  const float t_r = block_sum(part, s);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    df[i] = j_plus[i] ? df[i] : 0.0f;  // df_plus: RF = DF (Eq. 18)
    part += df[i];
  }
  const float dfp_tot = fmaxf(block_sum(part, s), EPS);
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
  const float head_tot = fmaxf(block_sum(part, s), EPS);
#pragma unroll
  for (int i = 0; i < LPT; ++i)
    raw[i] = add[i] + leftover * (owed[i] - add[i]) / head_tot;
  integerize<LPT>(raw, rem, t_r, j_plus, add, n_jobs, s);

#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    if (j < n_jobs) {
      const float alpha_rc = alpha[i] - reclaim[i] + add[i];
      alloc_out[row + j] = active[i] ? alpha_rc : 0.0f;
      record_out[row + j] = r_rd[i] + reclaim[i] - add[i];
      remainder_out[row + j] = rem[i];
    }
  }
}

}  // namespace

// demand/nodes/record/remainder/alloc_prev: [O, J]; capacity: [O]; outputs
// [O, J].  Launches on `stream`, does not synchronise, allocates nothing;
// returns the launch's cudaError_t.
extern "C" int adaptbf_alloc(const float* demand, const float* nodes,
                             const float* record, const float* remainder,
                             const float* alloc_prev, const float* capacity,
                             float* alloc_out, float* record_out,
                             float* remainder_out, int n_ost, int n_jobs,
                             float u_max, void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_J || n_ost < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_LPT(n_jobs, adaptbf_alloc_kernel<LPT><<<n_ost, THREADS, 0, st>>>(
      demand, nodes, record, remainder, alloc_prev, capacity, alloc_out,
      record_out, remainder_out, n_jobs, u_max));
  return static_cast<int>(cudaGetLastError());
}
