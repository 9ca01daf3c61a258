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
// the latency of its chain of row reductions, each a barrier.  The
// reference's probe searches take ~75 of them a largest-remainder
// distribution (~230 a round); alloc_round.cuh's radix select, 32-candidate
// excess descent and paired row sums take ~25 a round.
//
// Design: one thread block of 512 threads per OST row, the whole round in
// one launch.  The round is alloc_round.cuh's adaptbf_round, shared with
// the window megakernel (window_mega.cu).  Thread t owns lanes t + i *
// THREADS; lanes past J are absent from every sum and count (J is not
// padded: padded lanes would enter the top-k counts).  A reduction is a
// warp butterfly and one shared slot per warp behind one barrier
// (common.cuh), and every thread receives the same total, so each search's
// branches are uniform across the block.
//
// One wave.  The chain of ~25 barriers leaves an SM idle while its one
// block waits, so the kernel is built for two blocks an SM (at J <= 4096:
// 264 slots for the main path's 256 rows, which then run in one wave
// instead of two, each row's barriers overlapped by the other row's work).
// That caps a thread at 64 registers.  The round's four live lane arrays
// and the row's demand live in thread-private lanes of dynamic shared
// memory (SmemRound: 5 x 16 KB a block at J = 4096, beside 18 KB of
// reduction slots and search tables), lane masks are bits of a word, and
// derived values are recomputed instead of held (alloc_round.cuh);
// ptxas's registers and spills: PERF.md.  Rows wider than 4096 run one
// block an SM.
//
// Rows wider than 8192 jobs (up to 65536) run on a thread-block cluster of
// c = 2, 4 or 8 blocks a row (common.cuh: RowBlock<true>), each block the
// round over its slice with the cluster's reductions and searches
// (alloc_round.cuh); one block an SM at 16 lanes a thread.  Rows of
// J <= 8192 run the one-block case, unchanged.
//
// What crosses the cluster: each block pushes its partials into every
// peer's shared memory before a cluster barrier and reads only its own
// after it; the DSMEM bytes a block writes a reduction and a search pass,
// at c = 2, 4 and 8, are given beside the code (common.cuh: reductions;
// alloc_round.cuh: the top-k search and the excess descent).
//
// A batch of F independent fleets (storage/tenants.py) is F * O rows of one
// launch: the round reads no rates and nothing of a row's place, so a row
// gives the same bits launched alone or in a batch.
//
// Numerics: see alloc_round.cuh.  The integer path is bitwise with the
// reference; float row sums accumulate in double and round once, as the
// plain version's do, in other orders, so the two agree to a float32 ulp
// (in practice bitwise); against the reference's float32 sums, shares
// differ by ulps.
#include "alloc_round.cuh"

namespace {

using namespace repro;

// dynamic shared memory a block: the round's lanes, then the demand's
template <int LPT>
__host__ __device__ constexpr int smem_bytes() {
  return SmemRound<LPT>::BYTES + LPT * THREADS * 4;
}

template <int LPT, bool WIDE>
__global__ void __launch_bounds__(THREADS, LPT <= 8 ? 2 : 1)
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
  RowBlock<WIDE> rb(s, n_jobs);
  search_init(s);
  const int n = rb.n;  // this block's lanes, from lane rb.first of the row
  const size_t row = static_cast<size_t>(rb.index()) * n_jobs + rb.first;

  SmemLanes<LPT, SmemRound<LPT>::ARRAYS> demand;  // after the round's
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    demand[i] = j < n ? demand_g[row + j] : 0.0f;
  }
  adaptbf_round<LPT>(demand, nodes_g + row, record_g + row,
                     remainder_g + row, prev_g + row, cap_g[rb.index()],
                     u_max, /*integer_tokens=*/true, n, rb.red,
                     [&](int i, float alloc, float record, float rem) {
                       const int j = lane_of(i);
                       if (j < n) {
                         alloc_out[row + j] = alloc;
                         record_out[row + j] = record;
                         remainder_out[row + j] = rem;
                       }
                     });
  rb.done();
}

}  // namespace

// demand/nodes/record/remainder/alloc_prev: [O, J]; capacity: [O]; outputs
// [O, J]; J <= MAX_ROW_J (a cluster a row past MAX_J).  Launches on
// `stream`, does not synchronise, allocates nothing; returns the launch's
// cudaError_t.
extern "C" int adaptbf_alloc(const float* demand, const float* nodes,
                             const float* record, const float* remainder,
                             const float* alloc_prev, const float* capacity,
                             float* alloc_out, float* record_out,
                             float* remainder_out, int n_ost, int n_jobs,
                             float u_max, void* stream) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0 || n_ost < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c > 1)
    return static_cast<int>(
        launch_clusters<adaptbf_alloc_kernel<MAX_LPT, true>,
                        smem_bytes<MAX_LPT>()>(
            n_ost, c, st, demand, nodes, record, remainder, alloc_prev,
            capacity, alloc_out, record_out, remainder_out, n_jobs, u_max));
  REPRO_DISPATCH_LPT(n_jobs, return static_cast<int>(
      launch_rows<adaptbf_alloc_kernel<LPT, false>, smem_bytes<LPT>()>(
          n_ost, st, demand, nodes, record, remainder, alloc_prev, capacity,
          alloc_out, record_out, remainder_out, n_jobs, u_max)));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the kernel resident on an SM at row width n_jobs, or past
// MAX_J the clusters resident on the card (-1 on error); its dynamic shared
// memory a block into *smem.
extern "C" int adaptbf_alloc_occupancy(int n_jobs, int* smem) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0) return -1;
  if (c > 1) {
    *smem = smem_bytes<MAX_LPT>();
    return clusters_per_card<adaptbf_alloc_kernel<MAX_LPT, true>,
                             smem_bytes<MAX_LPT>()>(c);
  }
  REPRO_DISPATCH_LPT(n_jobs, *smem = smem_bytes<LPT>();
                     return blocks_per_sm<adaptbf_alloc_kernel<LPT, false>,
                                          smem_bytes<LPT>()>());
  return -1;
}
