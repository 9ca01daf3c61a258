// Mamba-2 chunked SSD scan for Hopper (sm_90a) [arXiv:2405.21060].
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py:78
// ssd_pallas_bhcqp (body _ssd_kernel:26, wrapper ssd_pallas:111).  Per
// (sequence, head) the kernel walks the chunks of Q = 64 positions in
// order, carrying the state h [N, P] in float32 shared memory; per chunk:
//   cum      = prefix sum of dt * a                         (within the chunk)
//   w[i][j]  = (C_i . B_j) * exp(min(cum_i - cum_j, 0)),  j <= i, else 0
//   y        = w (x dt) + (C exp(cum)) h + x d_skip
//   h        = h exp(cum_Q) + (B exp(cum_Q - cum))^T (x dt)
// and after the last chunk writes h as state [B, H, N, P] float32.
// Plain version: kernels/ssd/ref.py::ssd_chunked.
//
// Bound: operations, NC (2 Q^2 N + 2 Q^2 P + 4 Q N P) a (sequence, head)
// against the bytes of x, dt, B, C and y.  One block of 256 threads per
// (sequence, head); the four products of a chunk are 64-row matrix
// products from float32 tiles in shared memory, a 4 x 4 register tile a
// thread (fmaf, no tensor cores yet).  The cumulative decay is a warp
// prefix sum, not the TPU kernel's triangular matmul.
//
// Layout: the model's x [B,S,H,P], dt [B,S,H] and B/C [B,S,N] read by
// stride (last axis contiguous); positions past S load as zeros with
// dt = 0 (no-op steps, as the reference pads), so nothing is padded in
// device memory.  N <= 128 and P <= 64; smaller dims are zeros in the
// tiles.  Numerics follow the reference: the decay clamp
// exp(min(cum_i - cum_j, 0)); in bfloat16, x dt, w, C exp(cum), h and
// B exp(cum_Q - cum) round to bfloat16 where the reference casts; y is
// written in x's type.
#include "lm.cuh"

namespace repro {

constexpr int SSD_Q = 64;         // chunk length
constexpr int SSD_PM = 64;        // largest head dim P
constexpr int SSD_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int SSD_LD = 68;        // pitch (floats) of the 64-wide tiles

struct SsdParams {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* d_skip;
  void* y;
  float* state;
  long long x_sb, x_ss, x_sh;  // element strides: batch, position, head
  long long dt_sb, dt_ss;      // batch, position (head stride 1)
  long long b_sb, b_ss;        // batch, position (state dim stride 1)
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
  int B, S, H, P, N, dtype;
};

template <int NM>
constexpr int ssd_smem_floats() {
  // ct [NM][LD], bt [NM][LD], bn [Q][NM+4], xw [Q][LD], wt [Q][LD],
  // hs [NM][LD], cum [Q], warp total
  return 3 * NM * SSD_LD + SSD_Q * (NM + 4) + 2 * SSD_Q * SSD_LD + SSD_Q + 4;
}

// out[4][4] += sum_k At[k][r0 + i] * Bk[k][c0 + j]  (At, Bk: float rows of
// pitch lda / ldb in shared memory, 16-byte aligned).
__device__ __forceinline__ void mm_tile(float (&out)[4][4], const float* At,
                                        int lda, const float* Bk, int ldb,
                                        int kdim, int r0, int c0) {
#pragma unroll 8
  for (int k = 0; k < kdim; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&At[k * lda + r0]);
    const float4 b = *reinterpret_cast<const float4*>(&Bk[k * ldb + c0]);
    fma4x4(out, a, b);
  }
}

// NM: the state dim rounded up to 64 or 128.
template <typename T, int NM>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_scan_kernel(const SsdParams p) {
  extern __shared__ float4 smem4[];
  float* ct = reinterpret_cast<float*>(smem4);  // C^T [n][i], then C exp(cum)
  float* bt = ct + NM * SSD_LD;                 // B^T [n][j]
  float* hs = bt + NM * SSD_LD;                 // state h [n][p]
  float* bn = hs + NM * SSD_LD;                 // B [j][n], then B exp(cum_Q - cum)
  float* xw = bn + SSD_Q * (NM + 4);            // x dt [j][p]
  float* wt = xw + SSD_Q * SSD_LD;              // w^T [j][i]
  float* cum = wt + SSD_Q * SSD_LD;             // [Q]
  float* wtot = cum + SSD_Q;                    // warp 0's scan total
  constexpr int LDN = NM + 4;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* X = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* DT = p.dt + b * p.dt_sb + h;
  const T* Bm = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* Cm = static_cast<const T*>(p.cm) + b * p.c_sb;
  T* Y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const float a = p.a[h];
  const float dskip = p.d_skip[h];

  for (int i = tid; i < NM * SSD_LD; i += SSD_THREADS) hs[i] = 0.0f;

  const int n_chunks = (p.S + SSD_Q - 1) / SSD_Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * SSD_Q;
    __syncthreads();  // the previous chunk is done with every tile

    // dt and the within-chunk prefix sum of dt * a (warps 0 and 1)
    if (tid < SSD_Q) {
      float v = c0 + tid < p.S ? DT[(c0 + tid) * p.dt_ss] * a : 0.0f;
      const int lane = tid & 31;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      if (tid == 31) *wtot = v;
      cum[tid] = v;
    }
    __syncthreads();
    if (tid >= 32 && tid < SSD_Q) cum[tid] += *wtot;

    // x dt (x's type), B and C tiles
    for (int i = tid; i < SSD_Q * SSD_PM; i += SSD_THREADS) {
      const int j = i / SSD_PM, pp = i % SSD_PM;
      float v = 0.0f;
      if (c0 + j < p.S && pp < p.P) {
        const float dtr = rnd<T>(DT[(c0 + j) * p.dt_ss]);  // dt.astype(x.dtype)
        v = rnd<T>(to_f<T>(X[(c0 + j) * p.x_ss + pp]) * dtr);
      }
      xw[j * SSD_LD + pp] = v;
    }
    for (int i = tid; i < SSD_Q * NM; i += SSD_THREADS) {
      const int j = i / NM, n = i % NM;
      float bv = 0.0f, cv = 0.0f;
      if (c0 + j < p.S && n < p.N) {
        bv = to_f<T>(Bm[(c0 + j) * p.b_ss + n]);
        cv = to_f<T>(Cm[(c0 + j) * p.c_ss + n]);
      }
      bt[n * SSD_LD + j] = bv;
      bn[j * LDN + n] = bv;
      ct[n * SSD_LD + j] = cv;
    }
    __syncthreads();

    // w = mask(C B^T * decay), stored transposed, in x's type
    {
      float s[4][4] = {};
      mm_tile(s, ct, SSD_LD, bt, SSD_LD, NM, ty * 4, tx * 4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx * 4 + c;
        float col[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty * 4 + r;
          col[r] = j <= i
              ? rnd<T>(s[r][c] * expf(fminf(cum[i] - cum[j], 0.0f)))
              : 0.0f;
        }
        *reinterpret_cast<float4*>(&wt[j * SSD_LD + ty * 4]) =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
    __syncthreads();

    // C exp(cum) and B exp(cum_Q - cum), in place, in x's type
    const float seg = cum[SSD_Q - 1];
    for (int i = tid; i < NM * SSD_Q; i += SSD_THREADS) {
      const int n = i / SSD_Q, j = i % SSD_Q;
      ct[n * SSD_LD + j] = rnd<T>(ct[n * SSD_LD + j] * rnd<T>(expf(cum[j])));
    }
    for (int i = tid; i < SSD_Q * NM; i += SSD_THREADS) {
      const int j = i / NM, n = i % NM;
      bn[j * LDN + n] = rnd<T>(bn[j * LDN + n] * rnd<T>(expf(seg - cum[j])));
    }
    __syncthreads();

    // y = w (x dt) + (C exp(cum)) h + x d_skip
    {
      float y[4][4] = {};
      mm_tile(y, wt, SSD_LD, xw, SSD_LD, SSD_Q, ty * 4, tx * 4);
      float yi[4][4] = {};
#pragma unroll 4
      for (int n = 0; n < NM; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&ct[n * SSD_LD + ty * 4]);
        const float4 hv = *reinterpret_cast<const float4*>(&hs[n * SSD_LD + tx * 4]);
        fma4x4(yi, cv, make_float4(rnd<T>(hv.x), rnd<T>(hv.y), rnd<T>(hv.z),
                                   rnd<T>(hv.w)));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        if (c0 + i >= p.S) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tx * 4 + c;
          if (pp >= p.P) continue;
          const float xv = to_f<T>(X[(c0 + i) * p.x_ss + pp]);
          Y[(c0 + i) * p.y_ss + pp] = from_f<T>(y[r][c] + yi[r][c] + xv * dskip);
        }
      }
    }
    __syncthreads();  // every read of h is done

    // h = h exp(seg) + (B exp(cum_Q - cum))^T (x dt)
    const float gamma = expf(seg);
#pragma unroll
    for (int n0 = 0; n0 < NM; n0 += 64) {
      float hn[4][4] = {};
      mm_tile(hn, bn, LDN, xw, SSD_LD, SSD_Q, n0 + ty * 4, tx * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* row = reinterpret_cast<float4*>(&hs[(n0 + ty * 4 + r) * SSD_LD + tx * 4]);
        const float4 o = *row;
        *row = make_float4(o.x * gamma + hn[r][0], o.y * gamma + hn[r][1],
                           o.z * gamma + hn[r][2], o.w * gamma + hn[r][3]);
      }
    }
  }
  __syncthreads();

  float* st = p.state + (static_cast<long long>(b) * p.H + h) * p.N * p.P;
  for (int i = tid; i < p.N * p.P; i += SSD_THREADS) {
    const int n = i / p.P, pp = i % p.P;
    st[i] = hs[n * SSD_LD + pp];
  }
}

template <typename T, int NM>
cudaError_t launch_ssd(const SsdParams& p, cudaStream_t s) {
  constexpr int bytes = ssd_smem_floats<NM>() * 4;
  auto kernel = ssd_scan_kernel<T, NM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H, p.B), SSD_THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

using repro::SsdParams;

extern "C" int ssd_scan(const SsdParams* params, void* stream) {
  const SsdParams& p = *params;
  if (p.B < 1 || p.B > 65535 || p.S < 1 || p.H < 1 || p.P < 1 ||
      p.P > repro::SSD_PM || p.N < 1 || p.N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  REPRO_DISPATCH_DTYPE(p.dtype, {
    err = p.N <= 64 ? repro::launch_ssd<T, 64>(p, s)
                    : repro::launch_ssd<T, 128>(p, s);
  });
  return static_cast<int>(err);
}
