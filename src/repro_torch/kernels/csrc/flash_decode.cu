// One-token attention over a KV cache for Hopper (sm_90a), split over keys.
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py:184
// flash_decode (body _decode_kernel:143): q [B,1,Hq,D] over the caches
// [B,T,Hkv,D] with kv head = h / (Hq / Hkv), positions at or past
// length[b] masked, o [B,1,Hq,D] in q's type.  Plain version:
// kernels/attention/ref.py::decode_attention.
//
// Bound: bytes (the K and V rows below each sequence's length, read once).
// A GEMV: no tensor cores, so float32 stays exact.  The design keeps bytes
// in flight on every SM:
// - Grid (key split, KV head x head group, sequence).  The split length
//   comes from the host (ops.py::decode_split_plan, from T, B, Hkv and the
//   SM count, never from the lengths); a split wholly past its sequence's
//   length exits at once.  One block serves up to 8 query heads of one KV
//   head, so K and V are read once a group.
// - Four warps a block; warp w takes the split's chunks w, w+4, ... of CW
//   keys (16 in bf16, 8 in float32: a key's row is shared by 32/CW lanes).
//   Each warp streams its chunks through a private ring of FD_STAGES
//   shared-memory stages with 16-byte cp.async copies (rows past the
//   length arrive as zeros), so three chunks a warp (~65 KB a block at
//   D=80, in either type) are in flight while it computes on the fourth,
//   with no block barrier in the loop.
// - Each warp runs an online softmax over its keys; the four (m, l, acc)
//   merge in shared memory at the end.  With one split the block writes o
//   directly (one launch, no scratch).  With several, each block writes its
//   partial (m, l, acc[D]) in float32 to scratch and flash_decode_merge
//   combines them in split order: deterministic, no atomics.
//
// Layout: the model's tensors read by stride, D contiguous: the decode
// cache is the fused [B, T, Hkv * hd] buffer that attention_decode writes,
// seen as [B, T, Hkv, hd]; nothing is copied or padded.  The cache rows
// must be 16-byte aligned (the wrapper checks).  Numerics follow the
// reference: mask -1e30f, p rounded to v's type before P V, l clamped at
// 1e-30f.  A sequence with length <= 0 has every key masked, and, as in
// the reference's softmax over an all-masked row, gets the mean of V over
// all T keys (every score is -1e30f, every weight exp(0)); an empty split
// or warp carries m = -1e30f and l = 0, so it weighs nothing in a merge
// with a live one and adds nothing to an all-masked one.
#include "lm.cuh"

namespace repro {

constexpr int FD_WARPS = 4;
constexpr int FD_STAGES = 4;  // chunks a warp has in its ring

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* length;
  void* o;
  float* part;                 // [B, Hq, n_split, D + 2] when n_split > 1
  long long q_sb, q_sh;        // element strides: batch, head
  long long k_sb, k_st, k_sh;  // batch, position, head
  long long v_sb, v_st, v_sh;
  long long o_sb, o_sh;
  int B, T, Hq, Hkv, D, dtype;
  int split_len, n_split, heads;  // the host's plan: keys a split, splits,
                                  // query heads a block (1, 2, 4 or 8)
  float scale;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Keys of sequence b that attention reads: all T when length <= 0 (every
// one masked), else the first min(length, T).
__device__ __forceinline__ int decode_keys(const DecodeParams& p, int b) {
  const int len = p.length[b];
  return len <= 0 ? p.T : min(len, p.T);
}

template <typename T>
__host__ __device__ constexpr int chunk_keys() {
  return sizeof(T) == 2 ? 16 : 8;
}

// NW: 32-bit words of a cache row a lane holds, rounded up to 32 lanes
// (ceil(D * sizeof(T) / 128)); G: query heads a block (p.heads).
template <typename T, int NW, int G>
__global__ void __launch_bounds__(FD_WARPS * 32)
flash_decode_kernel(const DecodeParams p) {
  constexpr int CW = chunk_keys<T>();      // keys a chunk
  constexpr int R = 32 / CW;               // lanes a key, in the scores
  constexpr int EW = 4 / sizeof(T);        // elements a 32-bit word
  constexpr int E16 = 16 / sizeof(T);      // elements a 16-byte piece
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);      // [G][D] float32
  uint8_t* ring = reinterpret_cast<uint8_t*>(qs + (G * p.D + 3) / 4 * 4);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = p.Hq / p.Hkv;
  const int n_hg = (group + G - 1) / G;
  const int hk = blockIdx.y / n_hg, h0 = hk * group + (blockIdx.y % n_hg) * G;
  const int heads = min(G, hk * group + group - h0);  // live heads here
  const int b = blockIdx.z;
  const int n = decode_keys(p, b);
  const bool none_valid = p.length[b] <= 0;
  const int lo = blockIdx.x * p.split_len;
  const int hi = min(lo + p.split_len, n);
  if (lo >= hi) return;  // wholly past the length: the merge skips it

  const int pitch = p.D * static_cast<int>(sizeof(T)) + 16;  // bytes a row
  const int pieces = p.D * static_cast<int>(sizeof(T)) / 16;  // 16 B a row
  const int words = p.D * static_cast<int>(sizeof(T)) / 4;
  const int stage_bytes = 2 * CW * pitch;                    // K then V
  uint8_t* my_ring = ring + warp * FD_STAGES * stage_bytes;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int n_chunks = (hi - lo + CW - 1) / CW;
  const int mine = (n_chunks - warp + FD_WARPS - 1) / FD_WARPS;  // may be 0

  // chunk number `it` of this warp -> ring stage it % FD_STAGES
  auto issue = [&](int it) {
    const int key0 = lo + (warp + it * FD_WARPS) * CW;
    const uint32_t dst0 = static_cast<uint32_t>(
        __cvta_generic_to_shared(my_ring + (it % FD_STAGES) * stage_bytes));
    for (int i = lane; i < 2 * CW * pieces; i += 32) {
      const int kv = i / (CW * pieces), rem = i % (CW * pieces);
      const int j = rem / pieces, pc = rem % pieces;
      const int key = key0 + j;
      const bool in = key < hi;
      const T* src = kv ? V : K;
      const long long st = kv ? p.v_st : p.k_st;
      cp_async16(dst0 + (kv * CW + j) * pitch + pc * 16,
                 src + (in ? key * st : 0) + pc * E16, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int it = 0; it < FD_STAGES - 1; ++it) {
    if (it < mine) issue(it);
    cp_async_commit();
  }

  // q of this block's heads, float32, while the first copies fly
  for (int i = threadIdx.x; i < G * p.D; i += FD_WARPS * 32) {
    const int g = i / p.D, d = i % p.D;
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + (h0 + g) * p.q_sh;
    qs[i] = g < heads ? to_f<T>(Q[d]) : 0.0f;
  }
  __syncthreads();

  float m[G], l[G], acc[G][NW][EW];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < NW; ++c)
#pragma unroll
      for (int e = 0; e < EW; ++e) acc[g][c][e] = 0.0f;
  }
  const int j = lane / R, r = lane % R;  // this lane's key and share of it

  for (int it = 0; it < mine; ++it) {
    if (it + FD_STAGES - 1 < mine) issue(it + FD_STAGES - 1);
    cp_async_commit();
    cp_async_wait<FD_STAGES - 1>();  // chunk `it` has landed (this lane's)
    __syncwarp();                    // ... and every lane's
    const uint8_t* kst = my_ring + (it % FD_STAGES) * stage_bytes;
    const uint8_t* vst = kst + CW * pitch;
    const int key = lo + (warp + it * FD_WARPS) * CW + j;
    const bool in = key < hi;

    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.0f;
    for (int pc = r; pc < pieces; pc += R) {
      const float4 raw = *reinterpret_cast<const float4*>(kst + j * pitch + pc * 16);
      const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < E16; ++e) {
        const float kx = to_f<T>(kv[e]);
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[g] = fmaf(qs[g * p.D + pc * E16 + e], kx, s[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int off = 1; off < R; off <<= 1)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      s[g] = (none_valid || !in) ? NEG_INF : s[g] * p.scale;
      float mx = in ? s[g] : NEG_INF;
#pragma unroll
      for (int off = R; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      const float e = in ? expf(s[g] - m_new) : 0.0f;
      l[g] = l[g] * alpha + (r == 0 ? e : 0.0f);  // one lane a key counts it
      m[g] = m_new;
      s[g] = rnd<T>(e);  // p.astype(v.dtype)
#pragma unroll
      for (int c = 0; c < NW; ++c)
#pragma unroll
        for (int x = 0; x < EW; ++x) acc[g][c][x] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < CW; ++jj) {
      float pj[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pj[g] = __shfl_sync(0xffffffffu, s[g], jj * R);
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        const int w = lane + 32 * c;
        if (w >= words) continue;
        const T* vv = reinterpret_cast<const T*>(vst + jj * pitch + w * 4);
#pragma unroll
        for (int x = 0; x < EW; ++x) {
          const float vx = to_f<T>(vv[x]);
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][c][x] = fmaf(pj[g], vx, acc[g][c][x]);
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before its refill
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: reuse them for the warps' merge

  // per warp: m[G], l[G], acc[G][D] -> shared memory
  float* wm = reinterpret_cast<float*>(ring);      // [WARPS][G]
  float* wl = wm + FD_WARPS * G;                   // [WARPS][G]
  float* wacc = wl + FD_WARPS * G;                 // [WARPS][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lw = l[g];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      lw += __shfl_xor_sync(0xffffffffu, lw, off);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = lw;
    }
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      const int w = lane + 32 * c;
      if (w >= words) continue;
#pragma unroll
      for (int x = 0; x < EW; ++x)
        wacc[(warp * G + g) * p.D + w * EW + x] = acc[g][c][x];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < heads * p.D; i += FD_WARPS * 32) {
    const int g = i / p.D, d = i % p.D;
    float m_all = NEG_INF;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) m_all = fmaxf(m_all, wm[w * G + g]);
    float l_all = 0.0f, out = 0.0f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      const float f = expf(wm[w * G + g] - m_all);
      l_all += wl[w * G + g] * f;
      out = fmaf(wacc[(w * G + g) * p.D + d], f, out);
    }
    const int h = h0 + g;
    if (p.n_split == 1) {
      T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
      O[d] = from_f<T>(out / fmaxf(l_all, 1e-30f));
    } else {
      float* part = p.part + ((static_cast<long long>(b) * p.Hq + h) * p.n_split
                              + blockIdx.x) * (p.D + 2);
      part[d] = out;
      if (d == 0) {
        part[p.D] = m_all;
        part[p.D + 1] = l_all;
      }
    }
  }
}

// o[b, h] from the partials of the splits that hold keys of sequence b, in
// split order.  One block of D threads (rounded up to a warp) per (h, b).
template <typename T>
__global__ void flash_decode_merge(const DecodeParams p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  if (d >= p.D) return;
  const int live = (decode_keys(p, b) + p.split_len - 1) / p.split_len;
  const float* part = p.part + (static_cast<long long>(b) * p.Hq + h) *
                                   p.n_split * (p.D + 2);
  float m_all = NEG_INF;
  for (int s = 0; s < live; ++s) m_all = fmaxf(m_all, part[s * (p.D + 2) + p.D]);
  float l_all = 0.0f, out = 0.0f;
  for (int s = 0; s < live; ++s) {
    const float* ps = part + s * (p.D + 2);
    const float f = expf(ps[p.D] - m_all);
    l_all += ps[p.D + 1] * f;
    out = fmaf(ps[d], f, out);
  }
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  O[d] = from_f<T>(out / fmaxf(l_all, 1e-30f));
}

template <typename T>
int decode_smem_bytes(const DecodeParams& p, int G) {
  const int ring = FD_WARPS * FD_STAGES * 2 * chunk_keys<T>() *
                   (p.D * static_cast<int>(sizeof(T)) + 16);
  const int merge = FD_WARPS * G * (p.D + 2) * 4;
  return (G * p.D + 4) * 4 + (ring > merge ? ring : merge);
}

template <typename T, int NW, int G>
cudaError_t launch_decode(const DecodeParams& p, cudaStream_t s) {
  const int bytes = decode_smem_bytes<T>(p, G);
  auto kernel = flash_decode_kernel<T, NW, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int group = p.Hq / p.Hkv;
  const dim3 grid(p.n_split, p.Hkv * ((group + G - 1) / G), p.B);
  kernel<<<grid, FD_WARPS * 32, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  flash_decode_merge<T><<<dim3(p.Hq, p.B), (p.D + 31) / 32 * 32, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int NW>
cudaError_t launch_heads(const DecodeParams& p, cudaStream_t s) {
  switch (p.heads) {
    case 8: return launch_decode<T, NW, 8>(p, s);
    case 4: return launch_decode<T, NW, 4>(p, s);
    case 2: return launch_decode<T, NW, 2>(p, s);
    default: return launch_decode<T, NW, 1>(p, s);
  }
}

}  // namespace repro

using repro::DecodeParams;

extern "C" int flash_decode(const DecodeParams* params, void* stream) {
  const DecodeParams& p = *params;
  const int row_bytes = p.D * (p.dtype == 0 ? 4 : 2);
  const int group = p.Hkv > 0 ? p.Hq / p.Hkv : 0;
  if (p.B < 1 || p.T < 1 || p.Hkv < 1 || p.Hq % p.Hkv != 0 || p.D < 1 ||
      p.D > 128 || row_bytes % 16 != 0 || p.B > 65535 || p.split_len < 1 ||
      p.n_split != (p.T + p.split_len - 1) / p.split_len ||
      (p.n_split > 1 && p.part == nullptr) || p.Hq > 65535 ||
      (p.heads != 1 && p.heads != 2 && p.heads != 4 && p.heads != 8) ||
      p.heads > group ||
      static_cast<long long>(p.Hkv) * ((group + p.heads - 1) / p.heads) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // 32-bit words a lane: 1..4 in float32, 1..2 in bfloat16 (D <= 128)
  const int nw = (row_bytes / 4 + 31) / 32;
  if (p.dtype == 0) {
    switch (nw) {
      case 1: err = repro::launch_heads<float, 1>(p, s); break;
      case 2: err = repro::launch_heads<float, 2>(p, s); break;
      case 3: err = repro::launch_heads<float, 3>(p, s); break;
      default: err = repro::launch_heads<float, 4>(p, s); break;
    }
  } else {
    err = nw == 1 ? repro::launch_heads<__nv_bfloat16, 1>(p, s)
                  : repro::launch_heads<__nv_bfloat16, 2>(p, s);
  }
  return static_cast<int>(err);
}
