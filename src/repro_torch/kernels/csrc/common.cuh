// Shared pieces of the per-row kernels (fleet_window.cu, adaptbf_alloc.cu,
// window_mega.cu; serve.cuh and alloc_round.cuh build on them).
//
// Every kernel runs one thread block per OST row.  Thread t owns the lanes
// j = t + i * THREADS (i < LPT) of the row in registers; lanes at or past J
// are absent from every sum and count.  A row reduction is a warp butterfly
// plus one shared-memory slot per warp, and every thread comes out with the
// same total (the same order in every warp), so block-uniform branches on it
// stay uniform.
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
  double f[WARPS];
  int i[WARPS];
};

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Row-wide sum of per-thread double partials, rounded once to float.  The
// leading barrier keeps this call's writes from overtaking the previous
// call's reads of the same slots.
__device__ __forceinline__ float block_sum(double x, Scratch& s) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) s.f[warp] = x;
  __syncthreads();
  return __double2float_rn(warp_sum(lane < WARPS ? s.f[lane] : 0.0));
}

// Row-wide int32 count of a per-thread partial count.
__device__ __forceinline__ int block_count(int x, Scratch& s) {
  x = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(x)));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) s.i[warp] = x;
  __syncthreads();
  const int v = lane < WARPS ? s.i[lane] : 0;
  return static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(v)));
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
