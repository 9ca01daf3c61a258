// GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py:79
// flash_attention_bhsd (body _fwd_kernel:28): online-softmax attention of
// q [B,S,Hq,D] over k/v [B,T,Hkv,D], kv head = h / (Hq / Hkv), causal keys
// past the query row masked, returning o [B,S,Hq,D] in q's type and
// lse [B,S,Hq] float32.  Plain version: kernels/attention/ref.py::mha_lse.
//
// Bound: operations (2*B*Hq*S*T*D causal multiply-adds' worth; the bytes
// are q, k, v and o once).  This first version is right and simple: one
// block of 256 threads per (64 query rows, head, batch), a register tile of
// 4 x 4 scores a thread from float32 copies of the q and k tiles in shared
// memory (fmaf outer products, no tensor cores yet), online softmax over
// 64-key tiles with the row max and sum shared across the 16 threads of a
// row, and P V from shared memory into 4 rows x D/16 columns a thread.
// Causal blocks stop at the block's last row (tiles above the diagonal are
// never loaded); the heaviest query blocks start first.
//
// Layout: the model's own [B, S, H, D] tensors, read by stride (D
// contiguous); nothing is transposed or padded in device memory.  Rows past
// S, keys past T and the head dim past D are masked in shared memory.
// Numerics follow the reference: the mask value is -1e30f (not -inf), p is
// rounded to v's type before P V, l is clamped at 1e-30f and
// lse = m + log(l).
#include "lm.cuh"

namespace repro {

constexpr int FA_BQ = 64;        // query rows a block
constexpr int FA_BK = 64;        // keys a tile
constexpr int FA_THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 keys
constexpr int FA_LD = 68;        // pitch (floats) of the 64-wide tiles

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_ss, q_sh;  // element strides: batch, position, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, S, T, Hq, Hkv, D, causal, dtype;
  float scale;
};

template <int DM>
constexpr int fa_smem_floats() {
  // q^T [DM][LD], k^T [DM][LD], v [BK][DM], p^T [BK][LD]
  return 2 * DM * FA_LD + FA_BK * DM + FA_BK * FA_LD;
}

// DM: the head dim rounded up to a multiple of 16 (<= 128); columns past
// D are zeros in the tiles, so they add nothing to q.k.
template <typename T, int DM>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const FlashParams p) {
  constexpr int NC = DM / 16;  // output columns a thread: d = tx + 16 c
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kt = qt + DM * FA_LD;
  float* vs = kt + DM * FA_LD;
  float* pt = vs + FA_BK * DM;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qblk = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qblk * FA_BQ;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < FA_BQ * DM; i += FA_THREADS) {
    const int r = i / DM, d = i % DM;
    float x = 0.0f;
    if (q0 + r < p.S && d < p.D) x = to_f<T>(Q[(q0 + r) * p.q_ss + d]);
    qt[d * FA_LD + r] = x;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q0 + FA_BQ);
  for (int k0 = 0; k0 < kv_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile's reads of kt, vs and pt are done
    for (int i = tid; i < FA_BK * DM; i += FA_THREADS) {
      const int j = i / DM, d = i % DM;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + j < p.T && d < p.D) {
        kx = to_f<T>(K[(k0 + j) * p.k_ss + d]);
        vx = to_f<T>(V[(k0 + j) * p.v_ss + d]);
      }
      kt[d * FA_LD + j] = kx;
      vs[j * DM + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * FA_LD + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&kt[d * FA_LD + tx * 4]);
      fma4x4(s, a, bk);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx * 4 + c;
        const bool ok = j < p.T && (!p.causal || j <= r);
        s[i][c] = ok ? s[i][c] * p.scale : NEG_INF;
        row_max = fmaxf(row_max, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[i][c] - m_new);
        row_sum += e;
        s[i][c] = rnd<T>(e);  // p.astype(v.dtype)
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&pt[(tx * 4 + c) * FA_LD + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      const float4 pr = *reinterpret_cast<const float4*>(&pt[j * FA_LD + ty * 4]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[j * DM + tx + 16 * c];
        acc[0][c] = fmaf(pr.x, vv, acc[0][c]);
        acc[1][c] = fmaf(pr.y, vv, acc[1][c]);
        acc[2][c] = fmaf(pr.z, vv, acc[2][c]);
        acc[3][c] = fmaf(pr.w, vv, acc[3][c]);
      }
    }
  }

  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) O[r * p.o_ss + d] = from_f<T>(acc[i][c] / l_safe);
    }
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.S + r) * p.Hq + h] = m[i] + logf(l_safe);
  }
}

template <typename T, int DM>
cudaError_t launch_flash(const FlashParams& p, cudaStream_t s) {
  constexpr int bytes = fa_smem_floats<DM>() * 4;
  auto kernel = flash_attention_kernel<T, DM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + FA_BQ - 1) / FA_BQ, p.Hq, p.B);
  kernel<<<grid, FA_THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

using repro::FlashParams;

extern "C" int flash_attention(const FlashParams* params, void* stream) {
  const FlashParams& p = *params;
  if (p.B < 1 || p.S < 1 || p.T < 1 || p.Hkv < 1 || p.Hq % p.Hkv != 0 ||
      p.D < 1 || p.D > 128 || p.B > 65535 || p.Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int dm = (p.D + 15) / 16 * 16;
  REPRO_DISPATCH_DTYPE(p.dtype, {
    switch (dm) {
      case 16: err = repro::launch_flash<T, 16>(p, s); break;
      case 32: err = repro::launch_flash<T, 32>(p, s); break;
      case 48: err = repro::launch_flash<T, 48>(p, s); break;
      case 64: err = repro::launch_flash<T, 64>(p, s); break;
      case 80: err = repro::launch_flash<T, 80>(p, s); break;
      case 96: err = repro::launch_flash<T, 96>(p, s); break;
      case 112: err = repro::launch_flash<T, 112>(p, s); break;
      default: err = repro::launch_flash<T, 128>(p, s); break;
    }
  });
  return static_cast<int>(err);
}
