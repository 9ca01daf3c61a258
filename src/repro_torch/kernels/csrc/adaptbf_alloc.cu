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
// Rows of at most 32 jobs (common.cuh: WARP_J; the small tenants' J=8) run
// one warp a row, WARP_ROWS = 16 rows a block (RowWarp): the row's
// reductions are warp butterflies, the top-k search a direct rank over
// shuffles and the excess descent's sums shuffled lane by lane
// (alloc_round.cuh's WarpRed overloads), with no barrier anywhere, so a
// block's rows run apart and a warp past the last row returns at once.  A
// block of 512 threads a row left 504 threads of an 8-job row idle and
// cost a chain of ~25 block barriers a row, in ~16 waves at 4096 rows;
// 4096 warp rows are 256 blocks, one wave.  16 rows a block was measured
// against 4 (PERF.md).  The one-block instance stays for J of 33 to 8192
// (adaptbf_alloc_one_block launches it at any J <= 8192, to time the two).
//
// Rows wider than 8192 jobs (up to 65536) run on a thread-block cluster of
// c = 2, 4 or 8 blocks a row (common.cuh: RowBlock<true>), each block the
// round over its slice with the cluster's reductions and searches
// (alloc_round.cuh); one block an SM at 16 lanes a thread.  Rows of
// 33 to 8192 jobs run the one-block case, unchanged.
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

// Row: RowBlock<false> (one block a row), RowBlock<true> (a cluster) or
// RowWarp<WARP_ROWS> (one warp a row at LPT 1; held to 64 registers, 1024
// threads an SM, as the one-block rows at LPT <= 8).  Only the warp rows
// take the row count (Rows: int; empty otherwise, so the other instances
// keep their parameters and machine code).
template <int LPT, class Row, class... Rows>
__global__ void __launch_bounds__(Row::THREADS,
                                  Row::WARP ? 1024 / Row::THREADS
                                            : (LPT <= 8 ? 2 : 1))
adaptbf_alloc_kernel(const float* __restrict__ demand_g,
                     const float* __restrict__ nodes_g,
                     const float* __restrict__ record_g,
                     const float* __restrict__ remainder_g,
                     const float* __restrict__ prev_g,
                     const float* __restrict__ cap_g,
                     float* __restrict__ alloc_out,
                     float* __restrict__ record_out,
                     float* __restrict__ remainder_out,
                     int n_jobs, float u_max, Rows... n_rows) {
  if constexpr (Row::WARP) {
    if (Row::outside(n_rows...)) return;  // a warp past the last row
  }
  __shared__ Scratch s;
  Row rb(s, n_jobs);
  if constexpr (!Row::WARP) search_init(s);
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

LayoutLaunches layout_launches;

// The launch at row width n_jobs: its layout by row_layout, or the one-block
// layout at any J <= MAX_J when `narrow` is false.
int launch(const float* demand, const float* nodes, const float* record,
           const float* remainder, const float* alloc_prev,
           const float* capacity, float* alloc_out, float* record_out,
           float* remainder_out, int n_ost, int n_jobs, float u_max,
           cudaStream_t st, bool narrow) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0 || n_ost < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (narrow && row_layout(n_jobs) == ROW_WARP)
    return static_cast<int>(layout_launches.count(ROW_WARP,
        launch_warp_rows<adaptbf_alloc_kernel<1, RowWarp<WARP_ROWS>, int>,
                         smem_bytes<1>(), WARP_ROWS>(
            n_ost, st, demand, nodes, record, remainder, alloc_prev, capacity,
            alloc_out, record_out, remainder_out, n_jobs, u_max, n_ost)));
  if (c > 1)
    return static_cast<int>(layout_launches.count(ROW_CLUSTER,
        launch_clusters<adaptbf_alloc_kernel<MAX_LPT, RowBlock<true>>,
                        smem_bytes<MAX_LPT>()>(
            n_ost, c, st, demand, nodes, record, remainder, alloc_prev,
            capacity, alloc_out, record_out, remainder_out, n_jobs, u_max)));
  REPRO_DISPATCH_LPT(n_jobs, return static_cast<int>(layout_launches.count(ROW_BLOCK,
      launch_rows<adaptbf_alloc_kernel<LPT, RowBlock<false>>, smem_bytes<LPT>()>(
          n_ost, st, demand, nodes, record, remainder, alloc_prev, capacity,
          alloc_out, record_out, remainder_out, n_jobs, u_max))));
  return static_cast<int>(cudaErrorInvalidValue);
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
  return launch(demand, nodes, record, remainder, alloc_prev, capacity,
                alloc_out, record_out, remainder_out, n_ost, n_jobs, u_max,
                static_cast<cudaStream_t>(stream), true);
}

// adaptbf_alloc with rows of J <= WARP_J on the one-block instance (a block
// of THREADS a row) instead of their warp rows: what ran them before the
// warp layout, for timing the two in one process (chip_smoke.py).  The
// wrappers never call it.
extern "C" int adaptbf_alloc_one_block(const float* demand, const float* nodes,
                                       const float* record,
                                       const float* remainder,
                                       const float* alloc_prev,
                                       const float* capacity, float* alloc_out,
                                       float* record_out, float* remainder_out,
                                       int n_ost, int n_jobs, float u_max,
                                       void* stream) {
  return launch(demand, nodes, record, remainder, alloc_prev, capacity,
                alloc_out, record_out, remainder_out, n_ost, n_jobs, u_max,
                static_cast<cudaStream_t>(stream), false);
}

// The launches this library has made in row layout `layout` (ROW_WARP,
// ROW_BLOCK or ROW_CLUSTER of common.cuh; -1 for another value).
extern "C" int adaptbf_alloc_layout_launches(int layout) {
  return layout_launches.get(layout);
}

// Rows a block of the warp-row instance (common.cuh: WARP_ROWS).
extern "C" int adaptbf_alloc_warp_rows() { return WARP_ROWS; }

// Blocks of the kernel resident on an SM at row width n_jobs (of WARP_ROWS
// warp rows each at J <= WARP_J), or past MAX_J the clusters resident on
// the card (-1 on error); its dynamic shared memory a block into *smem.
extern "C" int adaptbf_alloc_occupancy(int n_jobs, int* smem) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0) return -1;
  if (row_layout(n_jobs) == ROW_WARP) {
    *smem = smem_bytes<1>();
    return warp_blocks_per_sm<adaptbf_alloc_kernel<1, RowWarp<WARP_ROWS>, int>,
                              smem_bytes<1>(), WARP_ROWS>();
  }
  if (c > 1) {
    *smem = smem_bytes<MAX_LPT>();
    return clusters_per_card<adaptbf_alloc_kernel<MAX_LPT, RowBlock<true>>,
                             smem_bytes<MAX_LPT>()>(c);
  }
  REPRO_DISPATCH_LPT(n_jobs, *smem = smem_bytes<LPT>();
                     return blocks_per_sm<adaptbf_alloc_kernel<LPT, RowBlock<false>>,
                                          smem_bytes<LPT>()>());
  return -1;
}
