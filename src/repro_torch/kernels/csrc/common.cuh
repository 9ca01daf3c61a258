// Shared pieces of the per-row kernels (fleet_window.cu, adaptbf_alloc.cu,
// window_mega.cu; serve.cuh and alloc_round.cuh build on them).  A row runs
// on one warp (J <= 32, RowWarp), one block (J <= 8192,
// RowBlock<false>) or a cluster (J <= 65536, RowBlock<true>): row_layout.
//
// A row of J <= 8192 jobs runs on one thread block (RowBlock<false>): thread
// t owns the lanes j = t + i * THREADS (i < LPT) of the row in registers;
// lanes at or past J are absent from every sum and count.  What bounds
// these kernels on the H100 beside their bytes is the chain of dependent
// row reductions, so a reduction costs one barrier: a warp butterfly, one
// shared slot per warp, __syncthreads, and a second butterfly over the
// slots, in which every thread comes out with the same total (the same
// order in every warp), so block-uniform branches on it stay uniform.
// Reductions alternate between two slot sets: reduction n writes set n & 1,
// and the set it overwrites was last read in reduction n - 2, which every
// thread finished before it reached reduction n - 1's barrier.  n counts the
// reductions run, so a reduction the row skips (serve.cuh skips the s1 sum
// on a branch over row totals, which every thread takes alike) is counted
// by no thread and the argument stands.  Independent
// sums of one step ride in one reduction (block_sum2, block_sum_count).
//
// A wider row (8192 < J <= 65536) runs on a thread-block cluster of c
// blocks (RowBlock<true>; c = cluster_blocks(J), the fewest of 2, 4 and 8
// with c * 8192 >= J), co-scheduled on one GPC.  Block rank q owns the
// slice of S = ceil(J / c) lanes from q * S, laid out in it as a row of its
// own (so lane index order is rank, then lane slot, warp, lane).  Peers
// share partials by push: in a reduction each warp writes its partial
// into slot (rank, warp) of every block's ClusterScratch through
// distributed shared memory (DSMEM), and one cluster barrier
// (arrive.release / wait.acquire) publishes them; after it every thread
// sums the c x WARPS slots of its own block's shared memory in a fixed
// order (lane l: slots l, l + 32, ... of the rank-major list, then a
// butterfly), so every thread of every block gets the same total and
// cluster-uniform branches stay uniform.  A block thus sends its 16 slots
// to each of the c blocks: c x 256 B of DSMEM a block a reduction (512 B,
// 1 KiB, 2 KiB at c = 2, 4, 8), whatever the number of warps reading them.
// The two-set argument carries over:
// the peers write a block's slot set n & 1 in reduction n before its
// barrier, the block reads it after that barrier and before it arrives at
// the next, and no peer writes the set again before it has passed that
// next barrier.  A reduction skipped on a branch over cluster totals
// (serve.cuh) is skipped by every thread of every block, since each reads
// the same totals, so all blocks run the same reductions in the same
// order, push into the same sets and meet at the same barriers.  A peer's shared memory is written only once it has
// started: each block arrives (relaxed) at a cluster barrier as it starts
// (RowBlock<true>) and waits for it just before its first push, so the
// wait overlaps the row's loads (PERF.md compares it with a whole barrier
// at the start).  Every other barrier publishes data read right after it,
// so it stays whole.  Each block waits at one last cluster barrier before
// it exits (RowBlock<true>::done), after which no peer touches its shared
// memory.
//
// A narrow row (J <= WARP_J = 32) runs on one warp (RowWarp<ROWS>): warp w
// of block b is row slot b * ROWS + w and lane l holds job l (one lane a
// thread).  The warp presents its row as a slice from lane first = -32 w
// of n = J + 32 w lanes, so that thread t's lane t - 32 w sits at
// row + lane_of(0) as in a block's row: the one-block code (serve.cuh,
// alloc_round.cuh's round, the kernels' loads and stores) runs on it
// unchanged, its lane tests j < n true exactly for the row's J lanes.  A
// reduction is the warp butterfly alone (WarpRed): no shared
// slot and no barrier anywhere on the path, since warps past the last row
// return at once and the rows of a block diverge.  The butterfly gives every
// lane the same total (each step adds the same two partials, in either
// order), and for J <= 32 it is the sum the one-block layout formed in its
// first warp (the other warps' slots add 0.0), so the two layouts agree
// bitwise.
//
// Float row sums accumulate in double and round once to float, as the plain
// PyTorch versions do (kernels/numerics.py::row_sum).  The kernel reduces in
// another order, so the double sums may differ in their last bit and, near a
// float32 rounding midpoint, round apart: kernel and plain version agree to
// a float32 ulp, in practice bitwise.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int THREADS = 512;        // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LPT = 16;         // lanes per thread: J <= 8192 a block
constexpr int MAX_J = THREADS * MAX_LPT;
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MAX_ROW_J = MAX_CLUSTER * MAX_J;  // 65536 jobs a row
constexpr int WARP_J = 32;          // rows of up to 32 jobs: one warp a row
constexpr int WARP_ROWS = 16;      // warp rows a block (16 against 4: PERF.md)

// Blocks a row of n_jobs runs on: 1 up to MAX_J, else the fewest of 2, 4
// and 8 with c * MAX_J >= n_jobs; 0 past MAX_ROW_J or below 1 (the host's
// rule: kernels/dispatch.py::cluster_size).
__host__ __device__ constexpr int cluster_blocks(int n_jobs) {
  return n_jobs < 1 ? 0
         : n_jobs <= MAX_J ? 1
         : n_jobs <= 2 * MAX_J ? 2
         : n_jobs <= 4 * MAX_J ? 4
         : n_jobs <= MAX_ROW_J ? 8 : 0;
}

// The layout a row of n_jobs runs on: one warp up to WARP_J, one block up
// to MAX_J, else a cluster (cluster_blocks); ROW_NONE past MAX_ROW_J or
// below 1 (the host's rule: kernels/dispatch.py::row_layout).
enum RowLayout : int { ROW_NONE = 0, ROW_WARP = 1, ROW_BLOCK = 2, ROW_CLUSTER = 3 };

__host__ __device__ constexpr int row_layout(int n_jobs) {
  return n_jobs < 1 ? ROW_NONE
         : n_jobs <= WARP_J ? ROW_WARP
         : n_jobs <= MAX_J ? ROW_BLOCK
         : n_jobs <= MAX_ROW_J ? ROW_CLUSTER : ROW_NONE;
}

struct Scratch {
  double f[2][WARPS][2];        // [slot set][warp][sum]
  int i[2][WARPS];              // [slot set][warp]
  // the allocation round's searches (alloc_round.cuh)
  int hist[2][4][256];          // radix digit counts: two sets of a table a pass
  int tie[MAX_LPT][WARPS];      // tied lanes a warp, per lane slot
  unsigned long long cand[2][WARPS][32];  // excess-descent candidate sums
};

// A block's reductions: its shared scratch and how many reductions and
// top-k searches it has run (the same counts in every thread, since every
// one is reached by the whole block).
struct Red {
  Scratch* s;
  int n;
  int searches;
};

// What the blocks of a row over a cluster write into each other's shared
// memory (only RowBlock<true> declares it, so the one-block instances keep
// their shared memory and code).  Slot or table set n & 1, as in Scratch.
struct ClusterScratch {
  double f[2][MAX_CLUSTER * WARPS][2];  // [set][rank * WARPS + warp][sum]
  int i[2][MAX_CLUSTER * WARPS];        // [set][rank * WARPS + warp]
  // the allocation round's searches (alloc_round.cuh)
  int hist[2][4][256];          // the row's digit counts: every rank adds its own
  int lower[2][256];            // last pass: the lower ranks' counts
  unsigned long long cand[2][MAX_CLUSTER][32];  // each block's candidate sums
};

// The reductions of a row over a cluster: as Red, with the tables the
// cluster shares, this block's rank, the cluster's blocks and the whole
// row's jobs (the block's own lanes are its slice).
struct ClusterRed {
  Scratch* s;
  ClusterScratch* cs;
  int n;
  int searches;
  int rank;
  int blocks;
  int row_jobs;
};

// The reductions and searches of a row on one warp: warp butterflies and
// shuffles only (a type of its own, so that every helper picks the warp
// overloads); `first`, the row's first lane in the warp's thread
// numbering (-32 * warp: RowWarp).
struct WarpRed {
  int first;
};

__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}

// The two halves of a cluster barrier: arrive without publishing anything,
// and wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The address p of this block's shared memory in the block of cluster rank
// `rank` (distributed shared memory).
template <class T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// A block's place in its row.  One block a row (false): block b is row
// slot b and holds all J lanes.  A row over a cluster (true): cluster r of
// the grid is row slot r, and the block of rank q holds the slice of
// S = ceil(J / c) lanes from q * S.  index() is the row slot, `first` the
// block's first lane in the row, `n` its lanes, `red` the row's reduction
// handle; done() ends the block's part in the row's reductions.
template <bool WIDE>
struct RowBlock;

template <>
struct RowBlock<false> {
  static constexpr int THREADS = repro::THREADS;
  static constexpr bool WARP = false, CLUSTER = false;
  static constexpr int first = 0;
  Red red;
  int n;
  __device__ __forceinline__ RowBlock(Scratch& s, int n_jobs)
      : red{&s, 0}, n(n_jobs) {}
  __device__ __forceinline__ static unsigned index() { return blockIdx.x; }
  __device__ __forceinline__ void done() {}
};

template <>
struct RowBlock<true> {
  static constexpr int THREADS = repro::THREADS;
  static constexpr bool WARP = false, CLUSTER = true;
  ClusterRed red;
  int first, n;
  // Arrives at the start barrier, which the first reduction (or done())
  // waits for: no block writes a peer's shared memory before the peer has
  // started.  Zeroes the search tables' first set (alloc_round.cuh), which
  // peers add into only after a later barrier.
  __device__ __forceinline__ RowBlock(Scratch& s, int n_jobs) {
    __shared__ ClusterScratch cs;
    cluster_arrive_relaxed();
    const cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    const int c = static_cast<int>(cl.num_blocks());
    const int q = static_cast<int>(cl.block_rank());
    const int slice = (n_jobs + c - 1) / c;
    for (int k = threadIdx.x; k < 4 * 256; k += THREADS) (&cs.hist[0][0][0])[k] = 0;
    for (int k = threadIdx.x; k < 256; k += THREADS) cs.lower[0][k] = 0;
    red = ClusterRed{&s, &cs, 0, 0, q, c, n_jobs};
    first = q * slice;
    n = min(slice, n_jobs - first);
  }
  __device__ __forceinline__ static unsigned index() {
    return blockIdx.x / cooperative_groups::this_cluster().num_blocks();
  }
  // no peer writes this block's shared memory once all have arrived here
  __device__ __forceinline__ void done() {
    if (red.n == 0) cluster_wait();  // no reduction waited for the start
    cluster_sync();
  }
};

// A warp's place: warp w of block b is row slot b * ROWS + w and holds all
// J <= WARP_J lanes, lane l job l; a block of ROWS warps.  As a slice its
// first lane is -32 w and it has n = J + 32 w lanes (thread t holds lane
// t + first), so the one-block code's row + t addresses job t - 32 w and
// its test t < n keeps lanes l < J.  The grid rounds the rows up to whole
// blocks: outside(rows) is true for a warp past the last row, which the
// kernel returns on before anything else (it waits for no one: no barrier
// on the path).  The Scratch handed over is unused.
template <int ROWS>
struct RowWarp {
  static_assert(ROWS * 32 <= repro::THREADS,
                "SmemLanes strides its lanes by THREADS threads");
  static constexpr int THREADS = ROWS * 32;
  static constexpr bool WARP = true, CLUSTER = false;
  WarpRed red;
  int first, n;
  __device__ __forceinline__ RowWarp(Scratch&, int n_jobs)
      : red{-static_cast<int>(threadIdx.x & ~31u)},
        first(red.first), n(n_jobs - first) {}
  __device__ __forceinline__ static unsigned index() {
    return blockIdx.x * ROWS + (threadIdx.x >> 5);
  }
  __device__ __forceinline__ static bool outside(int rows) {
    return index() >= static_cast<unsigned>(rows);
  }
  __device__ __forceinline__ void done() {}
};

// The kernel's dynamic shared memory (the allocation round's lane arrays,
// the megakernel's backlog caps).
extern __shared__ float4 dyn_smem[];

__device__ __forceinline__ float* dyn_floats() {
  return reinterpret_cast<float*>(dyn_smem);
}

// Lane array A of a kernel's dynamic shared memory: [A][i][thread], so a
// thread reads and writes only its own lanes (no barrier, no bank
// conflict).  Stands in for a float[LPT] register array.
template <int LPT, int A>
struct SmemLanes {
  __device__ __forceinline__ float& operator[](int i) const {
    return dyn_floats()[(A * LPT + i) * THREADS + threadIdx.x];
  }
};

// Bit i of a lane mask (bit i: lane slot i of this thread).
__device__ __forceinline__ bool bit(uint32_t m, int i) { return (m >> i) & 1u; }

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int warp_count(int x) {
  return static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(x)));
}

// NF double sums (NF <= 2) and NI int counts (NI <= 1) over the row, in
// place, behind one barrier.
template <int NF, int NI>
__device__ __forceinline__ void block_reduce(double (&f)[2], int& c, Red& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int set = r.n++ & 1;
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(f[k]);
  if (NI) c = warp_count(c);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NF; ++k) r.s->f[set][warp][k] = f[k];
    if (NI) r.s->i[set][warp] = c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NF; ++k)
    f[k] = warp_sum(lane < WARPS ? r.s->f[set][lane][k] : 0.0);
  if (NI) c = warp_count(lane < WARPS ? r.s->i[set][lane] : 0);
}

// The same over a cluster (an overload, so the one-block code above stays
// as it was): lane q of each warp writes the warp's partial into slot
// rank * WARPS + warp of block q; the cluster's barrier; then slot m of the
// rank-major list of the c x WARPS slots to lane m % 32, in increasing m.
// The first reduction first waits for every peer to have started
// (RowBlock<true>).
template <int NF, int NI>
__device__ __forceinline__ void block_reduce(double (&f)[2], int& c,
                                             ClusterRed& r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (r.n == 0) cluster_wait();
  const int set = r.n++ & 1;
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(f[k]);
  if (NI) c = warp_count(c);
  if (lane < r.blocks) {
    ClusterScratch* const to = peer(r.cs, lane);
    const int m = r.rank * WARPS + warp;
#pragma unroll
    for (int k = 0; k < NF; ++k) to->f[set][m][k] = f[k];
    if (NI) to->i[set][m] = c;
  }
  cluster_sync();
  double g[2] = {0.0, 0.0};
  int gc = 0;
#pragma unroll 1
  for (int m = lane; m < r.blocks * WARPS; m += 32) {
#pragma unroll
    for (int k = 0; k < NF; ++k) g[k] += r.cs->f[set][m][k];
    if (NI) gc += r.cs->i[set][m];
  }
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(g[k]);
  if (NI) c = warp_count(gc);
}

// The same on a warp row: the butterflies alone, every lane with the total.
template <int NF, int NI>
__device__ __forceinline__ void block_reduce(double (&f)[2], int& c, WarpRed&) {
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = warp_sum(f[k]);
  if (NI) c = warp_count(c);
}

// Row-wide sum of per-thread double partials, rounded once to float.
template <class R>
__device__ __forceinline__ float block_sum(double x, R& r) {
  double f[2] = {x, 0.0};
  int c = 0;
  block_reduce<1, 0>(f, c, r);
  return __double2float_rn(f[0]);
}

// Two independent row sums in one reduction.
template <class R>
__device__ __forceinline__ float2 block_sum2(double x, double y, R& r) {
  double f[2] = {x, y};
  int c = 0;
  block_reduce<2, 0>(f, c, r);
  return make_float2(__double2float_rn(f[0]), __double2float_rn(f[1]));
}

// A row sum and a row-wide int32 count in one reduction.
template <class R>
__device__ __forceinline__ void block_sum_count(double x, int c, R& r,
                                                float& sum, int& count) {
  double f[2] = {x, 0.0};
  block_reduce<1, 1>(f, c, r);
  sum = __double2float_rn(f[0]);
  count = c;
}

// Host side: kernel K (one instance of a kernel template) runs one block of
// THREADS a row, or a cluster of c such blocks a row, with SMEM bytes of
// dynamic shared memory a block.  Above 48 KB CUDA
// needs the kernel's own leave, asked once per kernel (a function-local
// static of each instance) for both the launch and the occupancy query.
template <auto K, int SMEM>
cudaError_t allow_smem() {
  static const cudaError_t err =
      SMEM > 0 ? cudaFuncSetAttribute(
                     K, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)
               : cudaSuccess;
  return err;
}

// Launch K over `rows` blocks on stream s; the launch's cudaError_t.
template <auto K, int SMEM, class... Args>
cudaError_t launch_rows(int rows, cudaStream_t s, Args... args) {
  const cudaError_t err = allow_smem<K, SMEM>();
  if (err != cudaSuccess) return err;
  K<<<rows, THREADS, SMEM, s>>>(args...);
  return cudaGetLastError();
}

// The launch of `rows` clusters of c blocks of K on stream s.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int rows, int c, int smem, cudaStream_t s) {
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * c);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Launches by row layout (index ROW_WARP, ROW_BLOCK, ROW_CLUSTER), counted
// on the host where a kernel's C entry picks the instance: each library
// keeps its own counts and exports them (<name>_layout_launches), so a test
// sees which instance a call ran.
struct LayoutLaunches {
  int n[4] = {0, 0, 0, 0};
  cudaError_t count(int layout, cudaError_t err) {
    if (err == cudaSuccess) ++n[layout];
    return err;
  }
  int get(int layout) const { return layout > 0 && layout < 4 ? n[layout] : -1; }
};

// Launch K, a kernel of one warp a row in blocks of ROWS warps, over `rows`
// rows on stream s; the launch's cudaError_t.
template <auto K, int SMEM, int ROWS, class... Args>
cudaError_t launch_warp_rows(int rows, cudaStream_t s, Args... args) {
  const cudaError_t err = allow_smem<K, SMEM>();
  if (err != cudaSuccess) return err;
  K<<<(rows + ROWS - 1) / ROWS, ROWS * 32, SMEM, s>>>(args...);
  return cudaGetLastError();
}

// Launch K over `rows` clusters of c blocks on stream s; the launch's
// cudaError_t.
template <auto K, int SMEM, class... Args>
cudaError_t launch_clusters(int rows, int c, cudaStream_t s, Args... args) {
  const cudaError_t err = allow_smem<K, SMEM>();
  if (err != cudaSuccess) return err;
  ClusterLaunch l(rows, c, SMEM, s);
  const cudaError_t launched = cudaLaunchKernelEx(&l.cfg, K, args...);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// Blocks of K resident on one SM, from CUDA's occupancy calculator (-1 on
// error).
template <auto K, int SMEM>
int blocks_per_sm() {
  int blocks = -1;
  if (allow_smem<K, SMEM>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K, THREADS,
                                                    SMEM) != cudaSuccess)
    return -1;
  return blocks;
}

// Blocks of K (ROWS warps each) resident on one SM (-1 on error).
template <auto K, int SMEM, int ROWS>
int warp_blocks_per_sm() {
  int blocks = -1;
  if (allow_smem<K, SMEM>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K, ROWS * 32,
                                                    SMEM) != cudaSuccess)
    return -1;
  return blocks;
}

// Clusters of c blocks of K resident on the card at once, from CUDA's
// occupancy calculator (-1 on error).
template <auto K, int SMEM>
int clusters_per_card(int c) {
  int clusters = -1;
  ClusterLaunch l(1, c, SMEM, nullptr);
  if (allow_smem<K, SMEM>() != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, K, &l.cfg) != cudaSuccess)
    return -1;
  return clusters;
}

}  // namespace repro

// Dispatch a kernel template on the lanes per thread a row of J jobs needs.
#define REPRO_DISPATCH_LPT(J, ...)                         \
  do {                                                     \
    const int lpt_ = ((J) + repro::THREADS - 1) / repro::THREADS; \
    if (lpt_ <= 1) { constexpr int LPT = 1; __VA_ARGS__; }   \
    else if (lpt_ <= 2) { constexpr int LPT = 2; __VA_ARGS__; } \
    else if (lpt_ <= 4) { constexpr int LPT = 4; __VA_ARGS__; } \
    else if (lpt_ <= 8) { constexpr int LPT = 8; __VA_ARGS__; } \
    else { constexpr int LPT = 16; __VA_ARGS__; }            \
  } while (0)
