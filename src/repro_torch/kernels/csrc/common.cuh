// Shared pieces of the per-row kernels (fleet_window.cu, adaptbf_alloc.cu,
// window_mega.cu; serve.cuh and alloc_round.cuh build on them).
//
// Every kernel runs one thread block per OST row.  Thread t owns the lanes
// j = t + i * THREADS (i < LPT) of the row in registers; lanes at or past J
// are absent from every sum and count.  What bounds these kernels on the
// H100 beside their bytes is the chain of dependent row reductions, so a
// reduction costs one barrier: a warp butterfly, one shared slot per warp,
// __syncthreads, and a second butterfly over the slots, in which every
// thread comes out with the same total (the same order in every warp), so
// block-uniform branches on it stay uniform.  Reductions alternate between
// two slot sets: reduction n writes set n & 1, and the set it overwrites
// was last read in reduction n - 2, which every thread finished before it
// reached reduction n - 1's barrier.  Independent sums of one step ride in
// one reduction (block_sum2, block_sum_count).
//
// Float row sums accumulate in double and round once to float, as the plain
// PyTorch versions do (kernels/numerics.py::row_sum).  The kernel reduces in
// another order, so the double sums may differ in their last bit and, near a
// float32 rounding midpoint, round apart: kernel and plain version agree to
// a float32 ulp, in practice bitwise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int THREADS = 512;        // threads per block (one block per row)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LPT = 16;         // lanes per thread: J <= 8192
constexpr int MAX_J = THREADS * MAX_LPT;

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

// Row-wide sum of per-thread double partials, rounded once to float.
__device__ __forceinline__ float block_sum(double x, Red& r) {
  double f[2] = {x, 0.0};
  int c = 0;
  block_reduce<1, 0>(f, c, r);
  return __double2float_rn(f[0]);
}

// Two independent row sums in one reduction.
__device__ __forceinline__ float2 block_sum2(double x, double y, Red& r) {
  double f[2] = {x, y};
  int c = 0;
  block_reduce<2, 0>(f, c, r);
  return make_float2(__double2float_rn(f[0]), __double2float_rn(f[1]));
}

// A row sum and a row-wide int32 count in one reduction.
__device__ __forceinline__ void block_sum_count(double x, int c, Red& r,
                                                float& sum, int& count) {
  double f[2] = {x, 0.0};
  block_reduce<1, 1>(f, c, r);
  sum = __double2float_rn(f[0]);
  count = c;
}

// Host side: kernel K (one instance of a kernel template) runs one block of
// THREADS a row with SMEM bytes of dynamic shared memory.  Above 48 KB CUDA
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
