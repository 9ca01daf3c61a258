// One-token attention over a KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py:184
// flash_decode (body _decode_kernel:143): q [B,1,Hq,D] over the caches
// [B,T,Hkv,D] with kv head = h / (Hq / Hkv), positions at or past
// length[b] masked, o [B,1,Hq,D] in q's type.  Plain version:
// kernels/attention/ref.py::decode_attention.
//
// Bound: bytes (the K and V rows below each sequence's length, read once).
// One block of 8 warps per (head, sequence).  Warp w takes the keys
// w*U + 8*U*i (+ 0..U-1), U at a time so each warp keeps 2*U rows of D in
// flight; a lane holds the head dims lane + 32*c, a key's score is a warp
// sum.  Each warp runs its own online softmax; the eight partial (m, l,
// acc) are merged through shared memory at the end.  Keys at or past the
// length are never read.
//
// Layout: the model's tensors read by stride, D contiguous: the decode
// cache is the fused [B, T, Hkv * hd] buffer that attention_decode writes,
// seen as [B, T, Hkv, hd]; nothing is copied or padded.  Numerics follow
// the reference: mask -1e30f, p rounded to v's type before P V, l clamped
// at 1e-30f.  A sequence with length <= 0 has every key masked, and, as in
// the reference's softmax over an all-masked row, gets the mean of V over
// all T keys (every score is -1e30f, every weight exp(0)).
#include "lm.cuh"

namespace repro {

constexpr int FD_WARPS = 8;
constexpr int FD_U = 4;  // keys a warp loads per step

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* length;
  void* o;
  long long q_sb, q_sh;        // element strides: batch, head
  long long k_sb, k_st, k_sh;  // batch, position, head
  long long v_sb, v_st, v_sh;
  long long o_sb, o_sh;
  int B, T, Hq, Hkv, D, dtype;
  float scale;
};

// DM: the head dim rounded up to a multiple of 32 (<= 128).
template <typename T, int DM>
__global__ void __launch_bounds__(FD_WARPS * 32)
flash_decode_kernel(const DecodeParams p) {
  constexpr int NC = DM / 32;
  __shared__ float sm_m[FD_WARPS], sm_l[FD_WARPS];
  __shared__ float sm_acc[FD_WARPS][DM];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float qv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = lane + 32 * c;
    qv[c] = d < p.D ? to_f<T>(Q[d]) : 0.0f;
  }
  const int len = p.length[b];
  const bool none_valid = len <= 0;
  const int n = none_valid ? p.T : min(len, p.T);

  float m = NEG_INF, l = 0.0f, acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;

  for (int j0 = warp * FD_U; j0 < n; j0 += FD_WARPS * FD_U) {
    float kr[FD_U][NC], vr[FD_U][NC];
#pragma unroll
    for (int u = 0; u < FD_U; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        const bool in = j < n && d < p.D;
        kr[u][c] = in ? to_f<T>(K[j * p.k_st + d]) : 0.0f;
        vr[u][c] = in ? to_f<T>(V[j * p.v_st + d]) : 0.0f;
      }
    }
    float s[FD_U];
    float step_max = NEG_INF;
#pragma unroll
    for (int u = 0; u < FD_U; ++u) {
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) part = fmaf(qv[c], kr[u][c], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      s[u] = none_valid ? NEG_INF : part * p.scale;
      if (j0 + u < n) step_max = fmaxf(step_max, s[u]);
    }
    const float m_new = fmaxf(m, step_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
#pragma unroll
    for (int u = 0; u < FD_U; ++u) {
      if (j0 + u >= n) continue;  // not a key of this sequence
      const float e = expf(s[u] - m_new);
      l += e;
      const float pr = rnd<T>(e);  // p.astype(v.dtype)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(pr, vr[u][c], acc[c]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) sm_acc[warp][lane + 32 * c] = acc[c];
  __syncthreads();

  float m_all = NEG_INF;
#pragma unroll
  for (int w = 0; w < FD_WARPS; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float l_all = 0.0f, f[FD_WARPS];
#pragma unroll
  for (int w = 0; w < FD_WARPS; ++w) {
    f[w] = expf(sm_m[w] - m_all);
    l_all += sm_l[w] * f[w];
  }
  const float l_safe = fmaxf(l_all, 1e-30f);
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int d = threadIdx.x; d < p.D; d += FD_WARPS * 32) {
    float out = 0.0f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) out = fmaf(sm_acc[w][d], f[w], out);
    O[d] = from_f<T>(out / l_safe);
  }
}

template <typename T, int DM>
cudaError_t launch_decode(const DecodeParams& p, cudaStream_t s) {
  flash_decode_kernel<T, DM><<<dim3(p.Hq, p.B), FD_WARPS * 32, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

using repro::DecodeParams;

extern "C" int flash_decode(const DecodeParams* params, void* stream) {
  const DecodeParams& p = *params;
  if (p.B < 1 || p.T < 1 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || p.D < 1 ||
      p.D > 128 || p.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int dm = (p.D + 31) / 32 * 32;
  REPRO_DISPATCH_DTYPE(p.dtype, {
    switch (dm) {
      case 32: err = repro::launch_decode<T, 32>(p, s); break;
      case 64: err = repro::launch_decode<T, 64>(p, s); break;
      case 96: err = repro::launch_decode<T, 96>(p, s); break;
      default: err = repro::launch_decode<T, 128>(p, s); break;
    }
  });
  return static_cast<int>(err);
}
