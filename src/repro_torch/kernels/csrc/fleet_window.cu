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
// Under the byte bound sits a latency chain and an instruction stream:
// each tick needs row sums before the next can start (want1 and want2 in
// one reduction, s1 in a second, each behind one barrier: common.cuh), and
// the next tick's rate row is loaded while they run (serve.cuh).
//
// Design: one thread block per OST row (rows never mix; that is the paper's
// decentralization).  The per-lane state (queue, vol_left, budget, backlog
// cap, served accumulator) stays in registers across all W ticks; only the
// tick's rate row is read, coalesced, each tick, and only the window
// results are written.  The tick loop is serve.cuh's serve_window, shared
// with the window megakernel (window_mega.cu).  At 92 registers one block
// fits an SM, so 256 rows run in two waves; one wave (two blocks an SM, at
// 64 registers with this loop, or with the rate rows brought by 1-d bulk
// copies into a shared-memory ring) was measured and was no faster: the
// tick is bound by its instruction stream on the SM, not by residency or
// bytes in flight.  So the tick is cut to fewer instructions, with the same
// bits (serve.cuh's lean tick; PERF.md counts them by class): it forms its
// second row sum (a float-to-double conversion and a double add a lane,
// two butterflies and a barrier) only when phase 1 overflowed the capacity
// while an unruled job waits, the fleets' rows in a quarter of their ticks
// or fewer; a block's reductions drop a butterfly step that adds only
// zeros; and a block whose lanes all hold jobs (J = LPT * 512, a cluster
// row's slices of 8192) runs the tick without its lane tests.  The window
// megakernel keeps the tick as it was (serve.cuh).
//
// Rows of at most 32 jobs (common.cuh: WARP_J; the small tenants' J=8) run
// one warp a row, WARP_ROWS = 16 rows a block (RowWarp): a row's
// reductions are warp butterflies (WarpRed), with no barrier anywhere, so
// a block's rows run apart and a warp past the last row returns at once.
// The body (loads, serve_window, stores) is the one-block code on the
// warp's slice from lane -32 w (common.cuh).  A block of 512 threads a row
// left 504 threads of an 8-job row idle and cost two block barriers a tick;
// 4096 warp rows are 256 blocks, one wave.  The one-block instance stays
// for J of 33 to 8192 (fleet_window_one_block launches it at any J <= 8192,
// to time the two).
//
// Rows wider than 8192 jobs (up to 65536) run on a thread-block cluster of
// c = 2, 4 or 8 blocks a row (common.cuh: RowBlock<true>): each block serves
// its slice of the row with the same loop, its rate rows offset by the
// slice, and the tick's row sums are the cluster's (each warp's partial
// pushed into every block before the cluster barrier: common.cuh).
//
// A batch of F independent fleets (storage/tenants.py) is F * O rows in one
// launch: row slot r serves row o = r % O of fleet f = r / O, whose rates
// start f * fleet_rows * J floats into the rate block (fleet_rows = 0 when
// every fleet reads one shared trace, T * O for a [F, T, O, J] trace) with
// ticks O * J apart.  Nothing else in a row's arithmetic depends on its
// place, so a row gives the same bits launched alone or in a batch.
//
// Numerics: see serve.cuh.  Row sums accumulate in double and round once,
// as the plain version's do; in other orders, so the two agree to a float32
// ulp (in practice bitwise); against the reference's float32 sums, values
// differ by ulps.
#include "serve.cuh"

namespace {

using namespace repro;

// Row: RowBlock<false> (one block a row), RowBlock<true> (a cluster) or
// RowWarp<WARP_ROWS> (one warp a row at LPT 1; held to 64 registers, 1024
// threads an SM, as B2's and B3's warp rows).  Only the warp rows take the
// row count (Rows: int; empty otherwise).
template <int LPT, class Row, class... Rows>
__global__ void __launch_bounds__(Row::THREADS,
                                  Row::WARP ? 1024 / Row::THREADS : 1)
fleet_window_kernel(const float* __restrict__ queue_in,
                    const float* __restrict__ vol_in,
                    const float* __restrict__ budget_in,
                    const float* __restrict__ backlog,
                    const float* __restrict__ rates,
                    const float* __restrict__ cap_tick,
                    float* __restrict__ queue_out,
                    float* __restrict__ vol_out,
                    float* __restrict__ served_out,
                    int n_jobs, int n_ticks, int rows_per_fleet,
                    int fleet_rows, Rows... n_rows) {
  if constexpr (Row::WARP) {
    if (Row::outside(n_rows...)) return;  // a warp past the last row
  }
  __shared__ Scratch scratch;
  Row rb(scratch, n_jobs);
  const int o = rb.index();
  const int n = rb.n;  // this block's lanes, from lane rb.first of the row
  const int fleet = o / rows_per_fleet;
  const size_t row = static_cast<size_t>(o) * n_jobs + rb.first;
  const float cap = cap_tick[o];
  const float* rate_row =
      rates + (static_cast<size_t>(fleet) * fleet_rows + o -
               fleet * rows_per_fleet) * n_jobs + rb.first;

  float q[LPT], v[LPT], b[LPT], bl[LPT], acc[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = threadIdx.x + i * THREADS;
    const bool in = j < n;
    q[i] = in ? queue_in[row + j] : 0.0f;
    v[i] = in ? vol_in[row + j] : 0.0f;
    b[i] = in ? budget_in[row + j] : 0.0f;
    bl[i] = in ? backlog[row + j] : 0.0f;
    acc[i] = 0.0f;
  }

  const size_t tick_stride = static_cast<size_t>(rows_per_fleet) * n_jobs;
  if (Row::WARP || n < LPT * THREADS)
    serve_window<LPT>(q, v, b, bl, acc, rate_row, tick_stride, n_ticks, cap,
                      n, rb.red);
  else  // every lane of the block holds a job: no lane tests
    serve_window<LPT, true, !Row::WARP>(q, v, b, bl, acc, rate_row,
                                        tick_stride, n_ticks, cap, n, rb.red);

#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = threadIdx.x + i * THREADS;
    if (j < n) {
      queue_out[row + j] = q[i];
      vol_out[row + j] = v[i];
      served_out[row + j] = acc[i];
    }
  }
  rb.done();
}

LayoutLaunches layout_launches;

// The launch at row width n_jobs: its layout by row_layout, or the one-block
// layout at any J <= MAX_J when `narrow` is false.
int launch(const float* queue, const float* vol, const float* budget,
           const float* backlog, const float* rates, const float* cap_tick,
           float* queue_out, float* vol_out, float* served_out, int n_rows,
           int n_jobs, int n_ticks, int rows_per_fleet, int fleet_rows,
           cudaStream_t s, bool narrow) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0 || n_rows < 1 || n_ticks < 0 || rows_per_fleet < 1 ||
      n_rows % rows_per_fleet || fleet_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (narrow && row_layout(n_jobs) == ROW_WARP)
    return static_cast<int>(layout_launches.count(ROW_WARP,
        launch_warp_rows<fleet_window_kernel<1, RowWarp<WARP_ROWS>, int>, 0,
                         WARP_ROWS>(
            n_rows, s, queue, vol, budget, backlog, rates, cap_tick,
            queue_out, vol_out, served_out, n_jobs, n_ticks, rows_per_fleet,
            fleet_rows, n_rows)));
  if (c > 1)
    return static_cast<int>(layout_launches.count(ROW_CLUSTER,
        launch_clusters<fleet_window_kernel<MAX_LPT, RowBlock<true>>, 0>(
            n_rows, c, s, queue, vol, budget, backlog, rates, cap_tick,
            queue_out, vol_out, served_out, n_jobs, n_ticks, rows_per_fleet,
            fleet_rows)));
  REPRO_DISPATCH_LPT(n_jobs, return static_cast<int>(layout_launches.count(
      ROW_BLOCK, launch_rows<fleet_window_kernel<LPT, RowBlock<false>>, 0>(
          n_rows, s, queue, vol, budget, backlog, rates, cap_tick, queue_out,
          vol_out, served_out, n_jobs, n_ticks, rows_per_fleet,
          fleet_rows))));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// queue/vol/budget/backlog: [R, J] with R = F * O rows (F fleets of
// rows_per_fleet = O rows); rates: [F, W, O, J] with fleet f's block
// f * fleet_rows * J floats from the base; cap_tick: [R]; outputs [R, J];
// J <= MAX_ROW_J (one warp a row to WARP_J, a block to MAX_J, a cluster
// past it).  Launches on `stream`, does not synchronise, allocates nothing;
// returns the launch's cudaError_t.
extern "C" int fleet_window(const float* queue, const float* vol,
                            const float* budget, const float* backlog,
                            const float* rates, const float* cap_tick,
                            float* queue_out, float* vol_out,
                            float* served_out, int n_rows, int n_jobs,
                            int n_ticks, int rows_per_fleet, int fleet_rows,
                            void* stream) {
  return launch(queue, vol, budget, backlog, rates, cap_tick, queue_out,
                vol_out, served_out, n_rows, n_jobs, n_ticks, rows_per_fleet,
                fleet_rows, static_cast<cudaStream_t>(stream), true);
}

// fleet_window with rows of J <= WARP_J on the one-block instance (a block
// of THREADS a row) instead of their warp rows: what ran them before the
// warp layout, for timing the two in one process (chip_smoke.py).  The
// wrappers never call it.
extern "C" int fleet_window_one_block(const float* queue, const float* vol,
                                      const float* budget,
                                      const float* backlog, const float* rates,
                                      const float* cap_tick, float* queue_out,
                                      float* vol_out, float* served_out,
                                      int n_rows, int n_jobs, int n_ticks,
                                      int rows_per_fleet, int fleet_rows,
                                      void* stream) {
  return launch(queue, vol, budget, backlog, rates, cap_tick, queue_out,
                vol_out, served_out, n_rows, n_jobs, n_ticks, rows_per_fleet,
                fleet_rows, static_cast<cudaStream_t>(stream), false);
}

// The launches this library has made in row layout `layout` (ROW_WARP,
// ROW_BLOCK or ROW_CLUSTER of common.cuh; -1 for another value).
extern "C" int fleet_window_layout_launches(int layout) {
  return layout_launches.get(layout);
}

// Rows a block of the warp-row instance (common.cuh: WARP_ROWS).
extern "C" int fleet_window_warp_rows() { return WARP_ROWS; }

// Blocks of the kernel resident on an SM at row width n_jobs (of WARP_ROWS
// warp rows each at J <= WARP_J), or past MAX_J the clusters resident on
// the card (-1 on error); its dynamic shared memory a block (none) into
// *smem.
extern "C" int fleet_window_occupancy(int n_jobs, int* smem) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0) return -1;
  *smem = 0;
  if (row_layout(n_jobs) == ROW_WARP)
    return warp_blocks_per_sm<fleet_window_kernel<1, RowWarp<WARP_ROWS>, int>,
                              0, WARP_ROWS>();
  if (c > 1)
    return clusters_per_card<fleet_window_kernel<MAX_LPT, RowBlock<true>>, 0>(c);
  REPRO_DISPATCH_LPT(n_jobs, return blocks_per_sm<
      fleet_window_kernel<LPT, RowBlock<false>>, 0>());
  return -1;
}
