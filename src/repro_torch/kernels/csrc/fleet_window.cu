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
// Under the byte bound sits a latency chain: each tick needs three row
// sums before the next can start; want1 and want2 share one reduction, s1
// takes a second, each behind one barrier (common.cuh), and the next
// tick's rate row is loaded while they run (serve.cuh).
//
// Design: one thread block per OST row (rows never mix; that is the paper's
// decentralization).  The per-lane state (queue, vol_left, budget, backlog
// cap, served accumulator) stays in registers across all W ticks; only the
// tick's rate row is read, coalesced, each tick, and only the window
// results are written.  The tick loop is serve.cuh's serve_window, shared
// with the window megakernel (window_mega.cu).  At 86 registers one block
// fits an SM, so 256 rows run in two waves; one wave (two blocks an SM, at
// 64 registers with this loop, or with the rate rows brought by 1-d bulk
// copies into a shared-memory ring) was measured and was no faster: the
// tick is bound by its instruction stream on the SM, not by residency or
// bytes in flight (PERF.md).
//
// Rows wider than 8192 jobs (up to 65536) run on a thread-block cluster of
// c = 2, 4 or 8 blocks a row (common.cuh: RowBlock<true>): each block serves
// its slice of the row with the same loop, its rate rows offset by the
// slice, and the tick's row sums are the cluster's (each warp's partial
// pushed into every block before the cluster barrier: common.cuh).  Rows
// of J <= 8192 run the one-block case, unchanged.
//
// A batch of F independent fleets (storage/tenants.py) is F * O rows in one
// launch: block r serves row o = r % O of fleet f = r / O, whose rates start
// f * fleet_rows * J floats into the rate block (fleet_rows = 0 when every
// fleet reads one shared trace, T * O for a [F, T, O, J] trace) with ticks
// O * J apart.  Nothing else in a row's arithmetic depends on its place, so
// a row gives the same bits launched alone or in a batch.
//
// Numerics: see serve.cuh.  Row sums accumulate in double and round once,
// as the plain version's do; in other orders, so the two agree to a float32
// ulp (in practice bitwise); against the reference's float32 sums, values
// differ by ulps.
#include "serve.cuh"

namespace {

using namespace repro;

template <int LPT, bool WIDE>
__global__ void __launch_bounds__(THREADS)
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
                    int fleet_rows) {
  __shared__ Scratch scratch;
  RowBlock<WIDE> rb(scratch, n_jobs);
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

  serve_window<LPT>(q, v, b, bl, acc, rate_row,
                    static_cast<size_t>(rows_per_fleet) * n_jobs, n_ticks, cap,
                    n, rb.red);

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

}  // namespace

// queue/vol/budget/backlog: [R, J] with R = F * O rows (F fleets of
// rows_per_fleet = O rows); rates: [F, W, O, J] with fleet f's block
// f * fleet_rows * J floats from the base; cap_tick: [R]; outputs [R, J];
// J <= MAX_ROW_J (a cluster a row past MAX_J).  Launches on `stream`, does
// not synchronise, allocates nothing; returns the launch's cudaError_t.
extern "C" int fleet_window(const float* queue, const float* vol,
                            const float* budget, const float* backlog,
                            const float* rates, const float* cap_tick,
                            float* queue_out, float* vol_out,
                            float* served_out, int n_rows, int n_jobs,
                            int n_ticks, int rows_per_fleet, int fleet_rows,
                            void* stream) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0 || n_rows < 1 || n_ticks < 0 || rows_per_fleet < 1 ||
      n_rows % rows_per_fleet || fleet_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c > 1)
    return static_cast<int>(launch_clusters<fleet_window_kernel<MAX_LPT, true>, 0>(
        n_rows, c, s, queue, vol, budget, backlog, rates, cap_tick, queue_out,
        vol_out, served_out, n_jobs, n_ticks, rows_per_fleet, fleet_rows));
  REPRO_DISPATCH_LPT(n_jobs, return static_cast<int>(
      launch_rows<fleet_window_kernel<LPT, false>, 0>(
          n_rows, s, queue, vol, budget, backlog, rates, cap_tick, queue_out,
          vol_out, served_out, n_jobs, n_ticks, rows_per_fleet,
          fleet_rows)));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the kernel resident on an SM at row width n_jobs, or past
// MAX_J the clusters resident on the card (-1 on error); its dynamic shared
// memory a block (none) into *smem.
extern "C" int fleet_window_occupancy(int n_jobs, int* smem) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0) return -1;
  *smem = 0;
  if (c > 1) return clusters_per_card<fleet_window_kernel<MAX_LPT, true>, 0>(c);
  REPRO_DISPATCH_LPT(n_jobs, return blocks_per_sm<fleet_window_kernel<LPT, false>, 0>());
  return -1;
}
