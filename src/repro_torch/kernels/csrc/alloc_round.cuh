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
//     after four passes the tied lanes' rank by index is one ballot
//     prefix count (index order is lane slot, warp, lane) -- ranking a
//     small bucket's lanes directly after an earlier pass was measured
//     and was no faster, and 11/11/10-bit digits (three passes, scanned
//     in two levels) were slower (PERF.md);
//   - the excess descent (only when the floors overshoot the budget)
//     evaluates g(r) = sum min(fl, r) at 31 candidates a pass, 5 bits at a
//     time, in 5 passes: a warp reduce-scatter of the candidates' integer
//     partials, one barrier, one candidate a lane;
// and the round's own row sums pair up where independent (11 reductions
// become 6).  Every search finds the unique answer of the reference's: the
// k largest keys with ties to the lowest index, the threshold, the excess
// round count p.
//
// A row over a cluster (common.cuh, ClusterRed) runs the same searches
// with every barrier the cluster's, and shares only block totals, pushed
// into every block before the barrier, so what crosses the cluster does
// not grow with the warps a block:
//   - a radix pass: each block counts its slice into its own histogram
//     (shared atomics), then after a __syncthreads adds each nonzero bin
//     into the row table of every block (atomicAdd on the peer's shared
//     address: red.shared::cluster), and in the last pass also into the
//     lower-ranks table of every higher rank; after the cluster barrier
//     every warp scans its own block's row table.  Integer counts: exact in
//     any order, so every thread finds the same digit.  At most 1 KiB to
//     each of the c blocks a pass (2, 4, 8 KiB at c = 2, 4, 8), the last
//     pass at most (2c - 1 - rank) KiB (3, 7, 15 KiB at rank 0);
//   - the tied lanes' rank: lanes of lower ranks come first in index order,
//     and their count is the lower-ranks table at the threshold's last
//     digit, already in the block's shared memory: the tie stage's barrier
//     is the block's own, and it sends nothing across the cluster;
//   - an excess pass: warp 0 sums the block's 16 warps' 32 candidate sums
//     after a __syncthreads and writes them into slot `rank` of every
//     block; after the barrier each lane sums its candidate's c slots in
//     rank order (exact integers).  256 B to each block a pass (512 B, 1 KiB,
//     2 KiB at c = 2, 4, 8).
// A row on one warp (J <= WARP_J, common.cuh's RowWarp; WarpRed) runs
// its searches on shuffles alone: topk_mask is a direct rank, each lane
// counting the lanes whose key is larger or equal at a lower index (one
// pass over the row's lanes), and the excess descent's five passes sum each
// candidate's min(fl, c) lane by lane by shuffle (at most 32 terms below
// 2^25: exact), so the searches find the same unique answers.
//
// The tables follow the reductions' two-set rule: peers add into a table
// set only after a cluster barrier that every block reaches after its last
// read of it and after zeroing it (a search's row and lower-ranks tables
// are zeroed one search ahead, past the next distribution's first
// reduction; RowBlock<true> zeroes the first set), and a pass's candidate
// slots are rewritten two passes on.
//
// Registers.  A row's lanes are spread 8 a thread at J = 4096, so every
// float[LPT] array the round keeps alive across a barrier costs 8
// registers, and two 512-thread blocks an SM leave 64 a thread.  The round
// holds few: lane masks are bits of one word (active, the lenders, a
// distribution's mask, eligibility, selection); the demand factor u and
// the surplus are recomputed where they are used (the same expressions,
// so the same bits), and record and the previous allocation are read again
// from global memory instead of being held.  The values that live across
// the round (the remainder carry, alpha, the redistributed record r_rd,
// the reclaim, and until the reclaim is known the priority p in its
// place) sit in thread-private lanes of dynamic shared memory
// (SmemRound).
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

// The round's live lane arrays: lane arrays 0-3 of the kernel's dynamic
// shared memory (a kernel puts its own after them, from ARRAYS on).  prio
// (p) shares reclaim's lanes: p is last read before reclaim is written.
template <int LPT>
struct SmemRound {
  static constexpr int ARRAYS = 4;
  static constexpr int BYTES = ARRAYS * LPT * THREADS * 4;
  SmemLanes<LPT, 0> rem;
  SmemLanes<LPT, 1> alpha;
  SmemLanes<LPT, 2> r_rd;
  SmemLanes<LPT, 3> reclaim;
  SmemLanes<LPT, 3> prio;
};

// Zero the radix tables before the block's first search (a reduction's
// barrier, the cluster's for a row over a cluster, must come between).
// Search n counts into table set n & 1 and zeroes the other set, which
// search n - 1 used: a barrier (the distribution's first reduction)
// separates every two searches.
__device__ __forceinline__ void search_init(Scratch& s) {
  for (int k = threadIdx.x; k < 2 * 4 * 256; k += THREADS) (&s.hist[0][0][0])[k] = 0;
}

// Membership of the k largest keys of the row, ties to the lowest index,
// as a lane mask.  Every lane below n_jobs is ranked (-inf keys too, as in
// the reference).
template <int LPT>
__device__ __forceinline__ uint32_t topk_mask(const float (&key)[LPT], int k,
                                              int n_jobs, Red& r) {
  Scratch& s = *r.s;
  const int set = r.searches++ & 1;
  for (int k2 = threadIdx.x; k2 < 4 * 256; k2 += THREADS)
    (&s.hist[set ^ 1][0][0])[k2] = 0;
  uint32_t in = 0;  // lanes below n_jobs
#pragma unroll
  for (int i = 0; i < LPT; ++i) in |= static_cast<uint32_t>(lane_of(i) < n_jobs) << i;
  if (k <= 0 || k >= n_jobs) return k > 0 ? in : 0u;  // nothing, or every lane
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
      if (bit(in, i) && (u[i] & hi) == pre)
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
      uint32_t sel = 0;
#pragma unroll
      for (int i = 0; i < LPT; ++i)
        sel |= static_cast<uint32_t>(bit(in, i) && (u[i] & mask) >= pre) << i;
      return sel;
    }
  }
  // the krem (< n_tied) lowest-index lanes equal to the threshold: a tied
  // lane's rank is the count of tied lanes before it in index order (lane
  // slot, warp, lane)
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const unsigned tied = __ballot_sync(0xffffffffu, bit(in, i) && u[i] == pre);
    if (lane == 0) s.tie[i][warp] = __popc(tied);
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  uint32_t sel = 0;
  int base = 0;  // tied lanes in earlier lane slots
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const unsigned tied = __ballot_sync(0xffffffffu, bit(in, i) && u[i] == pre);
    const int v = lane < WARPS ? s.tie[i][lane] : 0;
    const int rank = base + warp_count(lane < warp ? v : 0) + __popc(tied & below);
    base += warp_count(v);
    sel |= static_cast<uint32_t>(bit(in, i) &&
                                 (u[i] > pre || (bit(tied, lane) && rank < krem)))
           << i;
  }
  return sel;
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

// The cluster overloads below repeat the one-block searches above with the
// cluster's barriers and pushed block totals.  They are kept apart so that
// the one-block code stays as it was: sharing the text through template
// branches moved ptxas's register allocation and spills (PERF.md).
//
// topk_mask for a row over a cluster: each block counts its own lanes
// (below n_jobs, its slice) and adds its counts into every block's row
// table; every warp scans its own block's; a tied lane's rank adds the
// tied lanes of the lower ranks (the lower-ranks table).
template <int LPT>
__device__ __forceinline__ uint32_t topk_mask(const float (&key)[LPT], int k,
                                              int n_jobs, ClusterRed& r) {
  Scratch& s = *r.s;
  ClusterScratch& cs = *r.cs;
  const int set = r.searches++ & 1;
  for (int k2 = threadIdx.x; k2 < 4 * 256; k2 += THREADS) {
    (&s.hist[set ^ 1][0][0])[k2] = 0;
    (&cs.hist[set ^ 1][0][0])[k2] = 0;
  }
  for (int k2 = threadIdx.x; k2 < 256; k2 += THREADS) cs.lower[set ^ 1][k2] = 0;
  uint32_t in = 0;  // this block's lanes below n_jobs
#pragma unroll
  for (int i = 0; i < LPT; ++i) in |= static_cast<uint32_t>(lane_of(i) < n_jobs) << i;
  if (k <= 0 || k >= r.row_jobs) return k > 0 ? in : 0u;  // nothing, or every lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned u[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float kv = key[i] == 0.0f ? 0.0f : key[i];
    const int bits = __float_as_int(kv);
    u[i] = static_cast<unsigned>(bits >= 0 ? bits : bits ^ 0x7FFFFFFF) ^
           0x80000000u;
  }
  unsigned pre = 0;
  int krem = k, n_tied = 0;
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    int* const hist = s.hist[set][pass];
    int* const row = cs.hist[set][pass];
    const unsigned hi = pass == 0 ? 0u : 0xFFFFFFFFu << (shift + 8);
#pragma unroll
    for (int i = 0; i < LPT; ++i)
      if (bit(in, i) && (u[i] & hi) == pre)
        atomicAdd(&hist[(u[i] >> shift) & 255u], 1);
    __syncthreads();
    // bin m % 256 of this block into the tables of block m / 256
    for (int m = threadIdx.x; m < r.blocks * 256; m += THREADS) {
      const int q = m >> 8, bin = m & 255;
      const int v = hist[bin];
      if (v != 0) {
        atomicAdd(peer(&row[bin], q), v);
        if (pass == 3 && q > r.rank) atomicAdd(peer(&cs.lower[set][bin], q), v);
      }
    }
    cluster_sync();
    int b[8], tot = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      b[e] = row[8 * lane + e];
      tot += b[e];
    }
    int incl = tot;
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
    n_tied = row[d];
    if (n_tied == krem) {
      const unsigned mask = 0xFFFFFFFFu << shift;
      uint32_t sel = 0;
#pragma unroll
      for (int i = 0; i < LPT; ++i)
        sel |= static_cast<uint32_t>(bit(in, i) && (u[i] & mask) >= pre) << i;
      return sel;
    }
  }
  // index order: rank, lane slot, warp, lane
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const unsigned tied = __ballot_sync(0xffffffffu, bit(in, i) && u[i] == pre);
    if (lane == 0) s.tie[i][warp] = __popc(tied);
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  uint32_t sel = 0;
  int base = cs.lower[set][pre & 255u];  // tied lanes of the lower ranks
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const unsigned tied = __ballot_sync(0xffffffffu, bit(in, i) && u[i] == pre);
    const int v = lane < WARPS ? s.tie[i][lane] : 0;
    const int rank = base + warp_count(lane < warp ? v : 0) + __popc(tied & below);
    base += warp_count(v);
    sel |= static_cast<uint32_t>(bit(in, i) &&
                                 (u[i] > pre || (bit(tied, lane) && rank < krem)))
           << i;
  }
  return sel;
}

// excess_rounds for a row over a cluster: each pass's candidate sums are
// the block's (warp 0 over its 16 warps), pushed into slot `rank` of every
// block, then the c slots summed in rank order after the cluster barrier.
template <int LPT>
__device__ __forceinline__ void excess_rounds(const float (&fl)[LPT],
                                              float d_dn, int& p, float& g_p,
                                              ClusterRed& r) {
  Scratch& s = *r.s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned f[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) f[i] = static_cast<unsigned>(fminf(fl[i], TWO25));
  p = 0;
  g_p = 0.0f;
#pragma unroll 1
  for (int pass = 0; pass < 5; ++pass) {
    const int shift = 20 - 5 * pass;
    unsigned long long(*const cand)[32] = s.cand[pass & 1];
    unsigned long long(*const slots)[32] = r.cs->cand[pass & 1];
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
    __syncthreads();
    if (warp == 0) {
      unsigned long long mine = 0;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) mine += cand[k][lane];
#pragma unroll 1
      for (int q = 0; q < r.blocks; ++q) *peer(&slots[r.rank][lane], q) = mine;
    }
    cluster_sync();
    unsigned long long tot = 0;
#pragma unroll 1
    for (int q = 0; q < r.blocks; ++q) tot += slots[q][lane];
    const float gc = __ull2float_rn(tot);
    const int best = 31 - __clz(__ballot_sync(0xffffffffu, gc <= d_dn));
    g_p = __shfl_sync(0xffffffffu, gc, best);
    p += best << shift;
  }
}

// The searches on a warp row (WarpRed: J <= WARP_J, lane l holds job l,
// LPT = 1): warp shuffles only, no shared memory and no barrier.
//
// topk_mask as a direct rank: the lane's rank in the order (larger key
// first, ties to the lower index) is the count of the row's lanes whose
// order-mapped key is larger, or equal at a lower index, read one lane at
// a time by shuffle; the lane is selected when its rank is below k.  One
// pass, the same unique answer as the radix select.
// n_jobs counts lanes from the warp row's first (RowWarp: -32 * warp).
template <int LPT>
__device__ __forceinline__ uint32_t topk_mask(const float (&key)[LPT], int k,
                                              int n_jobs, WarpRed& r) {
  static_assert(LPT == 1, "a warp row holds one lane a thread");
  const int lane = threadIdx.x & 31;
  const int n = n_jobs + r.first;  // the row's jobs
  const uint32_t in = lane < n;
  if (k <= 0 || k >= n) return k > 0 ? in : 0u;  // nothing, or every lane
  const float kv = key[0] == 0.0f ? 0.0f : key[0];  // -0.0 ties +0.0
  const int bits = __float_as_int(kv);
  const unsigned u = static_cast<unsigned>(bits >= 0 ? bits : bits ^ 0x7FFFFFFF) ^
                     0x80000000u;
  int rank = 0;
#pragma unroll 4
  for (int m = 0; m < n; ++m) {
    const unsigned um = __shfl_sync(0xffffffffu, u, m);
    rank += um > u || (um == u && m < lane);
  }
  return in & static_cast<uint32_t>(rank < k);
}

// excess_rounds on a warp row: the five 5-bit passes of the one-block
// descent, candidate c = p + c 2^shift on lane c, its sum of min(fl, c)
// over the lanes up to the last nonzero floor, read one at a time by
// shuffle (exact: at most 32 terms below 2^25), rounded once to float.
template <int LPT>
__device__ __forceinline__ void excess_rounds(const float (&fl)[LPT],
                                              float d_dn, int& p, float& g_p,
                                              WarpRed&) {
  static_assert(LPT == 1, "a warp row holds one lane a thread");
  const int lane = threadIdx.x & 31;
  const unsigned f = static_cast<unsigned>(fminf(fl[0], TWO25));
  // lanes up to the last nonzero floor (lanes past the row's jobs hold 0)
  const int n_lanes = 32 - __clz(__ballot_sync(0xffffffffu, f != 0u));
  p = 0;
  g_p = 0.0f;
#pragma unroll 1
  for (int pass = 0; pass < 5; ++pass) {
    const int shift = 20 - 5 * pass;
    const unsigned c = static_cast<unsigned>(p) + (static_cast<unsigned>(lane) << shift);
    unsigned sum = 0;
#pragma unroll 4
    for (int m = 0; m < n_lanes; ++m) sum += min(__shfl_sync(0xffffffffu, f, m), c);
    const float gc = __uint2float_rn(sum);
    const int best = 31 - __clz(__ballot_sync(0xffffffffu, gc <= d_dn));
    g_p = __shfl_sync(0xffffffffu, gc, best);
    p += best << shift;
  }
}

// Floor raw + remainder over the mask and correct largest-remainder-first
// so the masked total equals `budget`; updates the remainder carry (lanes
// of `remainder`, registers or shared memory).  Callers leave lanes past J
// out of the mask.
template <int LPT, class Rem, class R>
__device__ __forceinline__ void integerize(const float (&raw)[LPT],
                                           Rem& remainder, float budget,
                                           uint32_t mask, float (&alloc)[LPT],
                                           int n_jobs, R& r) {
  float fl[LPT], rem[LPT];
  double part = 0.0;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const bool m = bit(mask, i);
    const float x = m ? raw[i] + remainder[i] : 0.0f;
    fl[i] = fmaxf(floorf(x), 0.0f);
    rem[i] = m ? x - fl[i] : 0.0f;
    part += fl[i];
    cnt += m;
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
  uint32_t elig = 0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const bool e = bit(mask, i) && fl[i] >= p_f + 1.0f;
    elig |= static_cast<uint32_t>(e) << i;
    key[i] = (is_up ? bit(mask, i) : e) ? rem[i] : __int_as_float(0xff800000);  // -inf
  }
  const uint32_t sel = topk_mask<LPT>(key, is_up ? k_up : k_dn, n_jobs, r);

  const float qf = static_cast<float>(q);
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const bool m = bit(mask, i), s = bit(sel, i);
    const float bump_up = qf * (m ? 1.0f : 0.0f) + ((s && m) ? 1.0f : 0.0f);
    const float bump_dn = fminf(fl[i], p_f) + ((s && bit(elig, i)) ? 1.0f : 0.0f);
    const float applied = delta > 0.0f ? bump_up : (delta < 0.0f ? -bump_dn : 0.0f);
    alloc[i] = fl[i] + applied;
    if (m) remainder[i] = rem[i] - applied;
  }
}

// The distribution primitive: integerize, or with float tokens the
// reference's passthrough (raw over the mask, remainder unchanged).
template <int LPT, class Rem, class R>
__device__ __forceinline__ void distribute(bool integer_tokens,
                                           const float (&raw)[LPT],
                                           Rem& remainder, float budget,
                                           uint32_t mask, float (&alloc)[LPT],
                                           int n_jobs, R& r) {
  if (integer_tokens) {
    integerize<LPT>(raw, remainder, budget, mask, alloc, n_jobs, r);
  } else {
#pragma unroll
    for (int i = 0; i < LPT; ++i) alloc[i] = bit(mask, i) ? raw[i] : 0.0f;
  }
}

// One allocation round of this block's row (or its slice of a row over a
// cluster: n_jobs lanes from the row pointers, r a ClusterRed), its live
// lanes in the first SmemRound<LPT>::BYTES of dynamic shared memory.
// `demand` holds the row's demand in this thread's lanes (0 past n_jobs): a
// float[LPT] or lanes of shared memory.  nodes, record, the remainder carry
// and the previous allocation are read from the row pointers.  For each
// lane slot i, out(i, alloc, record, remainder) receives the next
// allocation, the new record and the new remainder (lanes past n_jobs
// too: the caller drops them).
template <int LPT, class Dem, class R, class Out>
__device__ __forceinline__ void adaptbf_round(
    Dem& demand, const float* __restrict__ nodes_row,
    const float* __restrict__ record_row,
    const float* __restrict__ remainder_row,
    const float* __restrict__ prev_row, float cap, float u_max,
    bool integer_tokens, int n_jobs, R& r, Out&& out) {
  SmemRound<LPT> L;
  // inputs past n_jobs read as 0
  auto in_row = [&](const float* __restrict__ row, int i) {
    const int j = lane_of(i);
    return j < n_jobs ? row[j] : 0.0f;
  };
  uint32_t active = 0;
  double part = 0.0;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    L.rem[i] = in_row(remainder_row, i);
    const bool a = lane_of(i) < n_jobs && demand[i] > 0.0f;
    active |= static_cast<uint32_t>(a) << i;
    part += a ? nodes_row[lane_of(i)] : 0.0f;  // n_act
    cnt += a;
  }

  // step 1: priority-based initial allocation (Eq. 1-2)
  float n_sum;
  int n_active;
  block_sum_count(part, cnt, r, n_sum, n_active);
  const float n_tot = fmaxf(n_sum, ALLOC_EPS);
  const float budget1 = n_active > 0 ? cap : 0.0f;
  // u = min(demand / max(prev, 1), u_max) over the active lanes
  auto util = [&](int i) {
    return bit(active, i)
               ? fminf(demand[i] / fmaxf(in_row(prev_row, i), 1.0f), u_max)
               : 0.0f;
  };
  // the demand factor (Eq. 5), 0 off the active lanes
  auto dfac = [&](int i, float u, float p) {
    const float d = u > 1.0f ? u + u * p : u * p;
    return bit(active, i) ? d : 0.0f;
  };
  auto surplus = [&](int i) {
    return bit(active, i) ? fmaxf(L.alpha[i] - demand[i], 0.0f) : 0.0f;
  };
  float raw[LPT];
  {
    float alpha[LPT];
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      L.prio[i] = (bit(active, i) ? nodes_row[lane_of(i)] : 0.0f) / n_tot;
      raw[i] = budget1 * L.prio[i];
    }
    distribute<LPT>(integer_tokens, raw, L.rem, budget1, active, alpha, n_jobs, r);
#pragma unroll
    for (int i = 0; i < LPT; ++i) L.alpha[i] = alpha[i];
  }

  // step 2: surplus redistribution (Eq. 3-8); the surplus and demand-factor
  // totals in one reduction (raw holds df until it is scaled)
  part = 0.0;
  double part_df = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    part += surplus(i);
    raw[i] = dfac(i, util(i), L.prio[i]);
    part_df += raw[i];
  }
  const float2 s2 = block_sum2(part, part_df, r);
  const float t_s = s2.x;
  const float df_tot = fmaxf(s2.y, ALLOC_EPS);
#pragma unroll
  for (int i = 0; i < LPT; ++i) raw[i] = raw[i] / df_tot * t_s;
  {
    float add[LPT];
    distribute<LPT>(integer_tokens, raw, L.rem, t_s, active, add, n_jobs, r);
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const float sur = surplus(i);                              // of alpha1
      L.r_rd[i] = in_row(record_row, i) + sur - add[i];          // r_RD (Eq. 8)
      L.alpha[i] = L.alpha[i] - sur + add[i];                    // alpha_RD (Eq. 7)
    }
  }

  // step 3: re-compensation (Eq. 9-20); c with the lenders' demand-factor
  // total, then the reclaim with what lenders are owed (raw holds df_plus:
  // RF = DF, Eq. 18)
  uint32_t j_plus = 0;
  part = 0.0;
  part_df = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const bool jp = bit(active, i) && in_row(record_row, i) > 0.0f && L.r_rd[i] > 0.0f;
    j_plus |= static_cast<uint32_t>(jp) << i;
    const float u = util(i), p = L.prio[i];
    const float u_future = demand[i] / fmaxf(L.alpha[i], 1.0f);
    const float c_term = p * (fmaxf(1.0f, u) + fmaxf(0.0f, 1.0f - u_future)) / 2.0f;
    part += jp ? c_term : 0.0f;
    raw[i] = jp ? dfac(i, u, p) : 0.0f;
    part_df += raw[i];
  }
  const float2 s3 = block_sum2(part, part_df, r);
  const float c = s3.x;
  const float dfp_tot = fmaxf(s3.y, ALLOC_EPS);
  auto owed = [&](int i) { return bit(j_plus, i) ? L.r_rd[i] : 0.0f; };
  double part_owed = 0.0;
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float record = in_row(record_row, i), alpha = L.alpha[i];
    const bool j_minus = bit(active, i) && record < 0.0f && L.r_rd[i] < 0.0f;
    float rc = fminf(fabsf(record), fabsf(c * alpha));
    rc = fminf(rc, alpha);
    L.reclaim[i] = j_minus ? rc : 0.0f;
    part += L.reclaim[i];
    part_owed += owed(i);
  }
  // total reclaim capped at what active lenders are owed (deviation 3)
  const float2 s4 = block_sum2(part, part_owed, r);
  const float rc_tot = fmaxf(s4.x, ALLOC_EPS);
  const float rc_scale = fminf(1.0f, s4.y / rc_tot);
  part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    float rc = L.reclaim[i] * rc_scale;
    if (integer_tokens) rc = floorf(rc);
    L.reclaim[i] = rc;
    part += rc;
  }
  const float t_r = block_sum(part, r);
  // the lenders' compensation, capped per lender (raw: df_plus, then it)
  part = 0.0;
  double part_head = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    raw[i] = fminf(raw[i] / dfp_tot * t_r, owed(i));
    part += raw[i];
    part_head += owed(i) - raw[i];
  }
  const float2 s5 = block_sum2(part, part_head, r);
  const float leftover = t_r - s5.x;
  const float head_tot = fmaxf(s5.y, ALLOC_EPS);
#pragma unroll
  for (int i = 0; i < LPT; ++i)
    raw[i] = raw[i] + leftover * (owed(i) - raw[i]) / head_tot;
  float add[LPT];
  distribute<LPT>(integer_tokens, raw, L.rem, t_r, j_plus, add, n_jobs, r);
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const float alpha_rc = L.alpha[i] - L.reclaim[i] + add[i];
    out(i, bit(active, i) ? alpha_rc : 0.0f, L.r_rd[i] + L.reclaim[i] - add[i],
        L.rem[i]);
  }
}

}  // namespace repro
