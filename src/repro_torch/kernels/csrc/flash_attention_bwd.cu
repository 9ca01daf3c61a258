// GQA flash-attention backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its attention with a
// hand-written recompute backward in plain XLA under jax.custom_vjp
// (src/repro/kernels/attention/ref.py:76 _bwd_impl), which this kernel
// computes for the training step.  From q [B,S,Hq,D], k/v [B,T,Hkv,D]
// (kv head = h / (Hq / Hkv)), the forward's o [B,S,Hq,D] and lse [B,S,Hq]
// float32, and the incoming gradient dO [B,S,Hq,D], it writes dq
// [B,S,Hq,D] and dk/dv [B,T,Hkv,D] (contiguous, in q's type), dK and dV of
// a KV head summed over its query group.  Plain version:
// kernels/attention/ref.py::_bwd_impl (on KV broadcast to the query heads,
// the group summed after).
//
// Bound: operations.  Five products of 2*B*Hq*S*T*D/2 (causal) -- S and dP
// twice (once in each kernel below), dV, dK and dQ once -- against the
// bytes of q, k, v, o, dO, dq, dk and dv once.
//
// Design, in the shape of FlashAttention-2, SIMT and exact in float32
// (tensor cores, TMA and a persistent schedule are later work):
//  * flash_bwd_delta: delta = sum_d dO * O per (row, head), one warp a row,
//    into float32 scratch the wrapper allocates;
//  * flash_bwd_dkdv: one block of 256 threads per (64 keys, KV head,
//    batch).  Its K and V tiles stay in shared memory while it walks the
//    group's query heads and, for each, the 64-row query blocks that see
//    the key block (causal: from the block holding row k0 on).  Per query
//    block: S = Q K^T and dP = dO V^T as 4 x 4 register tiles a thread
//    (fmaf outer products from transposed float32 copies of the tiles),
//    P = exp(S * scale - lse) with the causal and ragged masks, dS = P (dP
//    - delta) scale; P and dS go to shared memory and each thread adds
//    its 4 keys x D/16 columns of dV += P^T dO and dK += dS^T Q in
//    registers.  Each key's dK and dV are summed by one thread in one
//    order: no atomics, the result is the same on every run;
//  * flash_bwd_dq: one block per (64 query rows, query head, batch), the
//    heaviest causal blocks first.  Its Q and dO tiles stay in shared
//    memory while it walks the key blocks the rows see: S, dP and dS as
//    above, dS^T to shared memory, dQ += dS K in registers.
// Rounding: inputs are read in their type (float32 or bfloat16) and every
// product and sum runs in float32; P is rounded to dO's type before dV and
// dS to q's type before dQ and dK, where the reference casts.  Each output
// is rounded to q's type once (the reference's bfloat16 path rounds dq
// after each 1024-key block; its float32 path is the same as this one up
// to the order of the sums).
#include "lm.cuh"

namespace repro {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;    // [B,S,Hq] contiguous
  float* delta;        // [B,S,Hq] contiguous scratch
  void* dq;            // [B,S,Hq,D] contiguous
  void* dk;            // [B,T,Hkv,D] contiguous
  void* dv;            // [B,T,Hkv,D] contiguous
  long long q_sb, q_ss, q_sh;  // element strides: batch, position, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long dout_sb, dout_ss, dout_sh;
  int B, S, T, Hq, Hkv, D, causal, dtype;
  float scale;
};

constexpr int BW_BQ = 64;        // query rows a tile
constexpr int BW_BK = 64;        // keys a tile
constexpr int BW_THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 keys
constexpr int BW_LD = 68;        // pitch (floats) of the 64-wide tiles

// ------------------------------------------------------------------ delta

template <typename T>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_delta(const BwdParams p) {
  const long long row = static_cast<long long>(blockIdx.x) * (BW_THREADS / 32)
                        + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.B) * p.S * p.Hq) return;
  const int h = static_cast<int>(row % p.Hq);
  const long long bs = row / p.Hq;
  const int s = static_cast<int>(bs % p.S), b = static_cast<int>(bs / p.S);
  const T* O = static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
  const T* G = static_cast<const T*>(p.dout) + b * p.dout_sb + s * p.dout_ss
               + h * p.dout_sh;
  float acc = 0.0f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(to_f<T>(G[d]), to_f<T>(O[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// ------------------------------------------------------------- shared code

// Rows [r0, r0 + 64) of a [.., D] tile of `src` (row stride `ss`) into the
// transposed float32 tile dst[d * LD + r]; zeros past `n_rows` and past D.
template <typename T, int DM>
__device__ __forceinline__ void load_t(float* dst, const T* src, long long ss,
                                       int r0, int n_rows, int D) {
  for (int i = threadIdx.x; i < 64 * DM; i += BW_THREADS) {
    const int r = i / DM, d = i % DM;
    float x = 0.0f;
    if (r0 + r < n_rows && d < D) x = to_f<T>(src[(r0 + r) * ss + d]);
    dst[d * BW_LD + r] = x;
  }
}

// The 4 x 4 tiles S = Q K^T and dP = dO V^T of thread (ty, tx): rows
// ty*4 + i, keys tx*4 + c, from the transposed tiles.
template <int DM>
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4],
                                       const float* qt, const float* gt,
                                       const float* kt, const float* vt,
                                       int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DM; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&qt[d * BW_LD + ty * 4]);
    const float4 kk = *reinterpret_cast<const float4*>(&kt[d * BW_LD + tx * 4]);
    fma4x4(s, a, kk);
    const float4 g = *reinterpret_cast<const float4*>(&gt[d * BW_LD + ty * 4]);
    const float4 vv = *reinterpret_cast<const float4*>(&vt[d * BW_LD + tx * 4]);
    fma4x4(dp, g, vv);
  }
}

// S and dP of the tile at rows q0.., keys k0.. turned in place into P
// (rounded to T: p.astype(do.dtype)) and dS (rounded to T:
// ds.astype(q.dtype)); masked entries are 0.  lse_s/delta_s: the tile's
// rows.
template <typename T>
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const BwdParams& p, const float* lse_s,
                                      const float* delta_s, int q0, int k0,
                                      int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty * 4 + i, r = q0 + rl;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx * 4 + c;
      const bool ok = r < p.S && j < p.T && (!p.causal || j <= r);
      const float pr = ok ? expf(s[i][c] * p.scale - lse_s[rl]) : 0.0f;
      const float ds = pr * (dp[i][c] - delta_s[rl]) * p.scale;
      s[i][c] = rnd<T>(pr);
      dp[i][c] = rnd<T>(ds);
    }
  }
}

template <int DM>
constexpr int dkdv_smem_floats() {
  // q^T, dO^T, k^T, v^T [DM][LD]; P, dS [BQ][LD]; lse, delta [BQ]
  return 4 * DM * BW_LD + 2 * BW_BQ * BW_LD + 2 * BW_BQ;
}

template <int DM>
constexpr int dq_smem_floats() {
  // q^T, dO^T, k^T, v^T [DM][LD]; dS^T [BK][LD]; lse, delta [BQ]
  return 4 * DM * BW_LD + BW_BK * BW_LD + 2 * BW_BQ;
}

// ------------------------------------------------------------- dK and dV

// DM: the head dim rounded up to a multiple of 16 (<= 128).
template <typename T, int DM>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dkdv(const BwdParams p) {
  constexpr int NC = DM / 16;  // output columns a thread: d = tx + 16 c
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* gt = qt + DM * BW_LD;
  float* kt = gt + DM * BW_LD;
  float* vt = kt + DM * BW_LD;
  float* ps = vt + DM * BW_LD;     // P[r][j]
  float* dss = ps + BW_BQ * BW_LD;  // dS[r][j]
  float* lse_s = dss + BW_BQ * BW_LD;
  float* delta_s = lse_s + BW_BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BW_BK;
  const int group = p.Hq / p.Hkv;
  load_t<T, DM>(kt, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh,
                p.k_ss, k0, p.T, p.D);
  load_t<T, DM>(vt, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh,
                p.v_ss, k0, p.T, p.D);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  const int q_first = p.causal ? k0 / BW_BQ * BW_BQ : 0;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* G = static_cast<const T*>(p.dout) + b * p.dout_sb + h * p.dout_sh;
    for (int q0 = q_first; q0 < p.S; q0 += BW_BQ) {
      __syncthreads();  // the previous tile's reads of qt, gt, ps, dss are done
      load_t<T, DM>(qt, Q, p.q_ss, q0, p.S, p.D);
      load_t<T, DM>(gt, G, p.dout_ss, q0, p.S, p.D);
      if (tid < BW_BQ) {
        const int r = q0 + tid;
        const long long at = (static_cast<long long>(b) * p.S + r) * p.Hq + h;
        lse_s[tid] = r < p.S ? p.lse[at] : 0.0f;
        delta_s[tid] = r < p.S ? p.delta[at] : 0.0f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<DM>(s, dp, qt, gt, kt, vt, ty, tx);
      probs<T>(s, dp, p, lse_s, delta_s, q0, k0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(&ps[(ty * 4 + i) * BW_LD + tx * 4]) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        *reinterpret_cast<float4*>(&dss[(ty * 4 + i) * BW_LD + tx * 4]) =
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      }
      __syncthreads();

      // this thread's keys ty*4 + i, columns tx + 16 c
#pragma unroll 2
      for (int r = 0; r < BW_BQ; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(&ps[r * BW_LD + ty * 4]);
        const float4 dr = *reinterpret_cast<const float4*>(&dss[r * BW_LD + ty * 4]);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
        const float dsv[4] = {dr.x, dr.y, dr.z, dr.w};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float g = gt[(tx + 16 * c) * BW_LD + r];
          const float qv = qt[(tx + 16 * c) * BW_LD + r];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], g, dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* DK = static_cast<T*>(p.dk);
  T* DV = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = k0 + ty * 4 + i;
    if (j >= p.T) continue;
    const long long row = ((static_cast<long long>(b) * p.T + j) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) {
        DK[row + d] = from_f<T>(dk[i][c]);
        DV[row + d] = from_f<T>(dv[i][c]);
      }
    }
  }
}

// ------------------------------------------------------------------- dQ

template <typename T, int DM>
__global__ void __launch_bounds__(BW_THREADS)
flash_bwd_dq(const BwdParams p) {
  constexpr int NC = DM / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* gt = qt + DM * BW_LD;
  float* kt = gt + DM * BW_LD;
  float* vt = kt + DM * BW_LD;
  float* dst = vt + DM * BW_LD;     // dS^T[j][r]
  float* lse_s = dst + BW_BK * BW_LD;
  float* delta_s = lse_s + BW_BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qblk = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qblk * BW_BQ;
  load_t<T, DM>(qt, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh,
                p.q_ss, q0, p.S, p.D);
  load_t<T, DM>(gt, static_cast<const T*>(p.dout) + b * p.dout_sb + h * p.dout_sh,
                p.dout_ss, q0, p.S, p.D);
  if (tid < BW_BQ) {
    const int r = q0 + tid;
    const long long at = (static_cast<long long>(b) * p.S + r) * p.Hq + h;
    lse_s[tid] = r < p.S ? p.lse[at] : 0.0f;
    delta_s[tid] = r < p.S ? p.delta[at] : 0.0f;
  }
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.0f;

  int kv_end = p.T;
  if (p.causal) kv_end = min(kv_end, q0 + BW_BQ);
  for (int k0 = 0; k0 < kv_end; k0 += BW_BK) {
    __syncthreads();  // the previous tile's reads of kt, vt and dst are done
    load_t<T, DM>(kt, K, p.k_ss, k0, p.T, p.D);
    load_t<T, DM>(vt, V, p.v_ss, k0, p.T, p.D);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<DM>(s, dp, qt, gt, kt, vt, ty, tx);
    probs<T>(s, dp, p, lse_s, delta_s, q0, k0, ty, tx);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&dst[(tx * 4 + c) * BW_LD + ty * 4]) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    __syncthreads();

    // this thread's rows ty*4 + i, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < BW_BK; ++j) {
      const float4 dr = *reinterpret_cast<const float4*>(&dst[j * BW_LD + ty * 4]);
      const float dsv[4] = {dr.x, dr.y, dr.z, dr.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = kt[(tx + 16 * c) * BW_LD + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(dsv[i], kv, dq[i][c]);
      }
    }
  }

  T* DQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.S) continue;
    const long long row = ((static_cast<long long>(b) * p.S + r) * p.Hq + h) * p.D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < p.D) DQ[row + d] = from_f<T>(dq[i][c]);
    }
  }
}

template <typename T, int DM>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t s) {
  const long long rows = static_cast<long long>(p.B) * p.S * p.Hq;
  const int per_block = BW_THREADS / 32;
  flash_bwd_delta<T><<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                       BW_THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int kv_bytes = dkdv_smem_floats<DM>() * 4;
  auto dkdv = flash_bwd_dkdv<T, DM>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.T + BW_BK - 1) / BW_BK, p.Hkv, p.B), BW_THREADS, kv_bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_bytes = dq_smem_floats<DM>() * 4;
  auto dq = flash_bwd_dq<T, DM>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return err;
  dq<<<dim3((p.S + BW_BQ - 1) / BW_BQ, p.Hq, p.B), BW_THREADS, q_bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dm(const BwdParams& p, cudaStream_t s) {
  switch ((p.D + 15) / 16 * 16) {
    case 16: return launch_bwd<T, 16>(p, s);
    case 32: return launch_bwd<T, 32>(p, s);
    case 48: return launch_bwd<T, 48>(p, s);
    case 64: return launch_bwd<T, 64>(p, s);
    case 80: return launch_bwd<T, 80>(p, s);
    case 96: return launch_bwd<T, 96>(p, s);
    case 112: return launch_bwd<T, 112>(p, s);
    default: return launch_bwd<T, 128>(p, s);
  }
}

}  // namespace repro

using repro::BwdParams;

// Launches the delta, dK/dV and dQ kernels in turn on `stream`; returns
// the first launch error (cudaSuccess: all three were queued).
extern "C" int flash_attention_bwd(const BwdParams* params, void* stream) {
  const BwdParams& p = *params;
  if (p.B < 1 || p.S < 1 || p.T < 1 || p.Hkv < 1 || p.Hq % p.Hkv != 0 ||
      p.D < 1 || p.D > 128 || p.B > 65535 || p.Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.dtype == 1)
    err = repro::launch_bwd_dm<__nv_bfloat16>(p, s);
  else
    err = repro::launch_bwd_dm<float>(p, s);
  return static_cast<int>(err);
}
