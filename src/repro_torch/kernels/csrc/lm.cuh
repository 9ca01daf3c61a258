// Shared pieces of the language-model kernels (flash_attention.cu,
// flash_decode.cu, ssd_scan.cu): element types and the rounding the
// reference does when it casts a float32 intermediate to the compute type.
//
// Inputs are float32 or bfloat16 (dtype code 0 or 1 from the wrapper);
// every product and sum runs in float32.  rnd<T>(x) rounds x to T and back
// (identity for float), where the reference writes `.astype(x.dtype)`.
// Products and sums use explicit fmaf where a dot product is accumulated:
// the build's --fmad=false stops the compiler from contracting, not an
// explicit fused multiply-add.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference's mask value, not -inf

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// The four products of a[0..3] x b[0..3] added into acc (a 4 x 4 register
// tile of an outer-product matrix multiply).
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// Sum and max over the 16 lanes of a half warp (lanes differing in bits 0-3).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace repro

// Run the statement with T the element type of dtype code `code`
// (0 float32, 1 bfloat16).
#define REPRO_DISPATCH_DTYPE(code, ...)                      \
  do {                                                       \
    if ((code) == 0) { using T = float; __VA_ARGS__; }       \
    else { using T = __nv_bfloat16; __VA_ARGS__; }           \
  } while (0)
