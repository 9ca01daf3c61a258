// Backward of the Mamba-2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its chunked scan
// (src/repro/kernels/ssd/ref.py:26 ssd_chunked) by autodiff in XLA, and
// its Pallas kernel (src/repro/kernels/ssd/kernel.py:78) has no backward.
// This kernel computes that gradient for the training step, in float32,
// from x [B,S,H,P], dt [B,S,H], a [H], B/C [B,S,N] (one group), d_skip
// [H], the warm start h0 [B,H,P,N] and the incoming gradients gy
// [B,S,H,P] and gstate [B,H,P,N] (either may be absent: zeros).  Plain
// version: kernels/ssd/ref.py::ssd_chunked_bwd, op for op the algorithm
// below.
//
// Bound: at the zamba2 training shape (B=4, S=2048, H=80, P=64, N=64)
// about 2.5 times the forward's operations, against ~0.26 GB of inputs and
// outputs (bytes set the floor on the card).  Here every product is a SIMT
// float32 product from shared memory, so the shared-memory loads bound it:
// each is a register tile of 2 rows x up to 8 columns a thread (`mm`), two
// loads of A and eight of B for sixteen multiply-adds (the first version,
// one output a thread, made two loads a multiply-add and ran 2.5x slower;
// PERF.md).
//
// Design, simple and exact in float32 (the tensor cores are later work):
//  * ssd_bwd_scan: one block of 512 threads per (head, sequence).  First a
//    forward walk over the chunks of Q = 64 positions recomputes the state
//    entering each chunk (h0 rounded to x's type, then h = h exp(cum_Q) +
//    (B exp(cum_Q - cum))^T (x dt)) into a float32 scratch [B,H,nc,P,N].
//    Then a reverse walk carries dh (from gstate) in shared memory; per
//    chunk, from the chunk's x, gy, B, C and dt and its entering state in
//    shared memory:
//      - every pair j <= i: the scores C_i.B_j, dw_ij = <gy_i, x_j dt_j>,
//        the decay exp(min(cum_i - cum_j, 0)), w = scores x decay, dS = dw x
//        decay and, below the diagonal where the clamp passes its
//        gradient, dw x w (into dcum_i and -dcum_j);
//      - per row: dC_i = sum_j dS_ij B_j + exp(cum_i) h^T gy_i and
//        dcum_i's share <C_i h, gy_i>; dB_j = sum_i dS_ij C_i + exp(cum_Q -
//        cum_j) dh^T (x_j dt_j) and its dcum share; d(xw)_j = sum_i w_ij
//        gy_i + exp(cum_Q - cum_j) dh B_j, which gives dx_j = d(xw)_j dt_j +
//        D gy_j and <d(xw)_j, x_j>;
//      - dseg = <dh, h> exp(cum_Q) + the dcum shares of the state decay,
//        then dh = dh exp(cum_Q) + sum_i exp(cum_i) gy_i C_i^T;
//      - one thread: dcum, its reverse cumsum dA, ddt = dA a + <d(xw), x>
//        and the head's share of da = sum dA dt.
//    dB and dC leave as per-head partials [B,H,S,N] and da, dD as
//    per-(sequence, head) partials; dh after the first chunk is dh0.
//  * ssd_bwd_reduce: dB and dC summed over the heads and da, dD over the
//    sequences, each in one fixed order (no atomics anywhere: two calls
//    are bitwise equal, as the trainer's bitwise restore needs).
// Positions past S load as zeros with dt = 0 and gy = 0, as the forward
// pads.  P <= 64 and N <= 128, as the forward kernel takes.  Outputs: dx in
// x's type, dB and dC in B's type, ddt, da, dD and dh0 in float32.
#include "lm.cuh"

namespace repro {

struct SsdBwdParams {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* d_skip;  // [H]; null: zeros
  const float* h0;      // [B,H,P,N] contiguous; null: zeros
  const void* gy;       // [B,S,H,P] contiguous, x's type; null: zeros
  const float* gstate;  // [B,H,P,N] contiguous; null: zeros
  float* states;        // scratch [B,H,nc,P,N]
  void* dx;             // [B,S,H,P] contiguous, x's type
  float* ddt;           // [B,S,H] contiguous
  float* db_part;       // scratch [B,H,S,N]
  float* dc_part;       // scratch [B,H,S,N]
  float* da_part;       // scratch [B,H]
  float* dd_part;       // scratch [B,H]
  float* dh0;           // [B,H,P,N] contiguous; null: not wanted
  void* db;             // [B,S,N] contiguous, B's type
  void* dc;             // [B,S,N] contiguous, C's type
  float* da;            // [H]
  float* dd;            // [H]
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
  int B, S, H, P, N, dtype;
};

constexpr int SB_Q = 64;          // chunk length
constexpr int SB_THREADS = 512;
constexpr int SB_LDQ = SB_Q + 1;  // pitch of the [Q][Q] tiles

// Shared memory of ssd_bwd_scan, in floats, at head dim p and state dim n
// (rows padded by one float: the products below read them by row and by
// column without bank conflicts).
__host__ __device__ inline int sb_smem_floats(int p, int n) {
  return 2 * SB_Q * (p + 1) + 2 * SB_Q * (n + 1) + 2 * p * (n + 1) +
         3 * SB_Q * SB_LDQ + 9 * SB_Q + 32 + 8;
}

// A product tile from shared memory: acc[r][c] += sum_k A(i_r, k) ks[k]
// B(k, j_c) over k < K, for this thread's rows i_r = 2 (tid / 16) + r (r <
// 2, i_r < M) and columns j_c = tid % 16 + 16 c (c < 8, j_c < Nn), with
// A(i, k) = A[i a_i + k a_k] and B(k, j) = B[k b_k + j b_j]; ks may be null
// (ones).  M <= 64 and Nn <= 128 fit one pass of 512 threads.  Two loads
// of A and up to eight of B feed sixteen multiply-adds.
__device__ __forceinline__ void mm(float (&acc)[2][8], int M, int Nn, int K,
                                   const float* A, int a_i, int a_k,
                                   const float* ks, const float* B, int b_k,
                                   int b_j) {
  const int i0 = (threadIdx.x >> 4) * 2, j0 = threadIdx.x & 15;
  if (i0 >= M) return;
  const bool two = i0 + 1 < M;
  for (int k = 0; k < K; ++k) {
    float a0 = A[i0 * a_i + k * a_k];
    float a1 = two ? A[(i0 + 1) * a_i + k * a_k] : 0.0f;
    if (ks) {
      const float sk = ks[k];
      a0 *= sk;
      a1 *= sk;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + 16 * c;
      if (j < Nn) {
        const float bv = B[k * b_k + j * b_j];
        acc[0][c] = fmaf(a0, bv, acc[0][c]);
        acc[1][c] = fmaf(a1, bv, acc[1][c]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][8]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
}

// Sum over the 16 threads that share a tile row (neighbouring lanes).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sum over the block, in a fixed order; `red` holds SB_THREADS / 32
// floats.  Every thread gets the sum.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < SB_THREADS / 32; ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(SB_THREADS, 1)
ssd_bwd_scan(const SsdBwdParams p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int P = p.P, N = p.N, LP = P + 1, LN = N + 1;
  const int nc = (p.S + SB_Q - 1) / SB_Q;
  const int tid = threadIdx.x;
  const int i0 = (tid >> 4) * 2, j0 = tid & 15;  // this thread's tile (mm)
  extern __shared__ float smem[];
  float* xs = smem;                   // [Q][LP] x
  float* gs = xs + SB_Q * LP;         // [Q][LP] gy
  float* bs = gs + SB_Q * LP;         // [Q][LN] B
  float* cs = bs + SB_Q * LN;         // [Q][LN] C
  float* hp = cs + SB_Q * LN;         // [P][LN] the state entering the chunk
  float* dh = hp + P * LN;            // [P][LN] the gradient of the state leaving it
  float* wt = dh + P * LN;            // [Q][LDQ] w
  float* dst = wt + SB_Q * SB_LDQ;    // [Q][LDQ] dS
  float* gg = dst + SB_Q * SB_LDQ;    // [Q][LDQ] dw x w below the diagonal
  float* dts = gg + SB_Q * SB_LDQ;    // [Q] dt
  float* cum = dts + SB_Q;            // [Q] prefix sums of dt a
  float* ex = cum + SB_Q;             // [Q] exp(cum)
  float* sd = ex + SB_Q;              // [Q] exp(cum_Q - cum)
  float* ks = sd + SB_Q;              // [Q] a product's per-k scale
  float* de = ks + SB_Q;              // [Q] dcum shares of y_inter
  float* dsd = de + SB_Q;             // [Q] dcum shares of the state decay
  float* xdot = dsd + SB_Q;           // [Q] <d(xw), x>
  float* rg = xdot + SB_Q;            // [Q] dcum shares of the pairs
  float* red = rg + SB_Q;             // [32] block sums
  float* misc = red + 32;             // [0] gamma, [1] <dh, h> gamma

  const T* X = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* DT = p.dt + b * p.dt_sb + h;
  const T* Bm = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* Cm = static_cast<const T*>(p.cm) + b * p.c_sb;
  const T* GY = p.gy ? static_cast<const T*>(p.gy) +
                           (static_cast<long long>(b) * p.S * p.H + h) * P
                     : nullptr;
  const float a = p.a[h];
  const float dskip = p.d_skip ? p.d_skip[h] : 0.0f;
  const long long bh = static_cast<long long>(b) * p.H + h;
  float* states = p.states + bh * nc * P * N;

  // x, dt and B of chunk c (and gy and C when `all`); zeros past S
  auto load = [&](int c, bool all) {
    const int r0 = c * SB_Q;
    for (int i = tid; i < SB_Q * P; i += SB_THREADS) {
      const int r = i / P, d = i % P, row = r0 + r;
      const bool in = row < p.S;
      xs[r * LP + d] = in ? to_f<T>(X[row * p.x_ss + d]) : 0.0f;
      if (all)
        gs[r * LP + d] = in && GY ? to_f<T>(GY[static_cast<long long>(row) * p.H * P + d])
                                  : 0.0f;
    }
    for (int i = tid; i < SB_Q * N; i += SB_THREADS) {
      const int r = i / N, n = i % N, row = r0 + r;
      const bool in = row < p.S;
      bs[r * LN + n] = in ? to_f<T>(Bm[row * p.b_ss + n]) : 0.0f;
      if (all) cs[r * LN + n] = in ? to_f<T>(Cm[row * p.c_ss + n]) : 0.0f;
    }
    if (tid < SB_Q) dts[tid] = r0 + tid < p.S ? DT[(r0 + tid) * p.dt_ss] : 0.0f;
  };
  // cum, exp(cum), exp(cum_Q - cum) and gamma of the loaded chunk
  auto decays = [&]() {
    if (tid == 0) {
      float run = 0.0f;
      for (int i = 0; i < SB_Q; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
      misc[0] = expf(run);
    }
    __syncthreads();
    if (tid < SB_Q) {
      ex[tid] = expf(cum[tid]);
      sd[tid] = expf(cum[SB_Q - 1] - cum[tid]);
    }
    __syncthreads();
  };

  float acc[2][8], acc2[2][8];

  // ---- 1. the forward walk: the state entering each chunk
  for (int i = tid; i < P * N; i += SB_THREADS)
    hp[(i / N) * LN + i % N] = p.h0 ? rnd<T>(p.h0[bh * P * N + i]) : 0.0f;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous chunk's reads are done
    load(c, false);
    __syncthreads();
    decays();
    const float gamma = misc[0];
    if (tid < SB_Q) ks[tid] = dts[tid] * sd[tid];
    __syncthreads();
    // h_chunk[p][n] = sum_j x_j[p] dt_j exp(cum_Q - cum_j) B_j[n]
    zero(acc);
    mm(acc, P, N, SB_Q, xs, 1, LP, ks, bs, LN, 1);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int d = i0 + r, n = j0 + 16 * cc;
        if (d < P && n < N) {
          states[static_cast<long long>(c) * P * N + d * N + n] = hp[d * LN + n];
          hp[d * LN + n] = hp[d * LN + n] * gamma + acc[r][cc];
        }
      }
  }

  // ---- 2. the reverse walk
  for (int i = tid; i < P * N; i += SB_THREADS)
    dh[(i / N) * LN + i % N] = p.gstate ? p.gstate[bh * P * N + i] : 0.0f;
  float dd_acc = 0.0f, da_acc = 0.0f;
  T* DX = static_cast<T*>(p.dx) + (static_cast<long long>(b) * p.S * p.H + h) * P;
  for (int c = nc - 1; c >= 0; --c) {
    const int r0 = c * SB_Q;
    __syncthreads();  // the previous chunk's reads are done
    load(c, true);
    for (int i = tid; i < P * N; i += SB_THREADS)
      hp[(i / N) * LN + i % N] = states[static_cast<long long>(c) * P * N + i];
    __syncthreads();
    decays();
    const float gamma = misc[0];

    // every pair (i, j): the scores C_i.B_j and dw_ij = dt_j <gy_i, x_j>,
    // then w, dS and the clamp's share dw x w
    zero(acc);
    mm(acc, SB_Q, SB_Q, N, cs, LN, 1, nullptr, bs, 1, LN);
    zero(acc2);
    mm(acc2, SB_Q, SB_Q, P, gs, LP, 1, nullptr, xs, 1, LP);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = i0 + r, j = j0 + 16 * cc;
        float w = 0.0f, ds = 0.0f, g = 0.0f;
        if (j <= i) {
          const float dw = acc2[r][cc] * dts[j];
          const float u = cum[i] - cum[j];
          const float dec = expf(fminf(u, 0.0f));
          w = acc[r][cc] * dec;
          ds = dw * dec;
          if (j < i && u <= 0.0f) g = dw * w;
        }
        wt[i * SB_LDQ + j] = w;
        dst[i * SB_LDQ + j] = ds;
        gg[i * SB_LDQ + j] = g;
      }
    __syncthreads();

    // dC_i = sum_j dS_ij B_j + exp(cum_i) h^T gy_i, and <C_i h, gy_i>
    zero(acc);
    mm(acc, SB_Q, N, SB_Q, dst, SB_LDQ, 1, nullptr, bs, LN, 1);
    zero(acc2);
    mm(acc2, SB_Q, N, P, gs, LP, 1, nullptr, hp, LN, 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r, row = r0 + i;
      float part = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int n = j0 + 16 * cc;
        if (n < N) {
          part = fmaf(cs[i * LN + n], acc2[r][cc], part);
          if (row < p.S)
            p.dc_part[(bh * p.S + row) * N + n] = acc[r][cc] + ex[i] * acc2[r][cc];
        }
      }
      part = row_sum(part);
      if (j0 == 0) de[i] = ex[i] * part;
    }
    // dB_j = sum_i dS_ij C_i + exp(cum_Q - cum_j) dt_j dh^T x_j, and its
    // dcum share
    zero(acc);
    mm(acc, SB_Q, N, SB_Q, dst, 1, SB_LDQ, nullptr, cs, LN, 1);
    zero(acc2);
    mm(acc2, SB_Q, N, P, xs, LP, 1, nullptr, dh, LN, 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = i0 + r, row = r0 + j;
      float part = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int n = j0 + 16 * cc;
        if (n < N) {
          const float t2 = acc2[r][cc] * dts[j];
          part = fmaf(t2, bs[j * LN + n], part);
          if (row < p.S)
            p.db_part[(bh * p.S + row) * N + n] = acc[r][cc] + sd[j] * t2;
        }
      }
      part = row_sum(part);
      if (j0 == 0) dsd[j] = part * sd[j];
    }
    // d(xw)_j = sum_i w_ij gy_i + exp(cum_Q - cum_j) dh B_j: dx_j,
    // <d(xw)_j, x_j> and dD's share
    zero(acc);
    mm(acc, SB_Q, P, SB_Q, wt, 1, SB_LDQ, nullptr, gs, LP, 1);
    zero(acc2);
    mm(acc2, SB_Q, P, N, bs, LN, 1, nullptr, dh, 1, LN);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = i0 + r, row = r0 + j;
      float part = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int d = j0 + 16 * cc;
        if (d < P) {
          const float dxw = acc[r][cc] + sd[j] * acc2[r][cc];
          const float xv = xs[j * LP + d], gv = gs[j * LP + d];
          part = fmaf(dxw, xv, part);
          dd_acc = fmaf(xv, gv, dd_acc);
          if (row < p.S)
            DX[static_cast<long long>(row) * p.H * P + d] =
                from_f<T>(dxw * dts[j] + dskip * gv);
        }
      }
      part = row_sum(part);
      if (j0 == 0) xdot[j] = part;
    }
    // the pairs' dcum shares: row sums less column sums
    if (tid < SB_Q) {
      float s = 0.0f, t = 0.0f;
      for (int j = 0; j < SB_Q; ++j) s += gg[tid * SB_LDQ + j];
      for (int i = 0; i < SB_Q; ++i) t += gg[i * SB_LDQ + tid];
      rg[tid] = s - t;
    } else if (tid < 2 * SB_Q) {
      ks[tid - SB_Q] = ex[tid - SB_Q];
    }
    // <dh, h> gamma, then (every read of dh done) dh's update:
    // dh = dh gamma + sum_k exp(cum_k) gy_k C_k^T
    {
      float part = 0.0f;
      for (int i = tid; i < P * N; i += SB_THREADS) {
        const int at = (i / N) * LN + i % N;
        part = fmaf(dh[at], hp[at], part);
      }
      const float tot = block_sum(part, red);  // its barriers order dh's reads
      if (tid == 0) misc[1] = tot * gamma;
    }
    zero(acc);
    mm(acc, P, N, SB_Q, gs, 1, LP, ks, cs, LN, 1);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int d = i0 + r, n = j0 + 16 * cc;
        if (d < P && n < N) dh[d * LN + n] = dh[d * LN + n] * gamma + acc[r][cc];
      }
    __syncthreads();  // de, dsd, xdot, rg and misc[1] are in
    if (tid == 0) {
      float dseg = misc[1];
      for (int j = 0; j < SB_Q; ++j) dseg += dsd[j];
      float dcum[SB_Q];
      for (int i = 0; i < SB_Q; ++i) dcum[i] = rg[i] + de[i] - dsd[i];
      dcum[SB_Q - 1] += dseg;
      float run = 0.0f;
      for (int k = SB_Q - 1; k >= 0; --k) {
        run += dcum[k];  // dA_k
        da_acc = fmaf(run, dts[k], da_acc);
        if (r0 + k < p.S)
          p.ddt[(static_cast<long long>(b) * p.S + r0 + k) * p.H + h] = run * a + xdot[k];
      }
    }
  }

  if (p.dh0)
    for (int i = tid; i < P * N; i += SB_THREADS)
      p.dh0[bh * P * N + i] = dh[(i / N) * LN + i % N];
  const float dd_tot = block_sum(dd_acc, red);
  if (tid == 0) {
    p.dd_part[bh] = dd_tot;
    p.da_part[bh] = da_acc;
  }
}

// dB and dC summed over the heads, da and dD over the sequences, each in
// order h = 0.. (b = 0..).
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce(const SsdBwdParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long sn = static_cast<long long>(p.S) * p.N;
  if (i < p.B * sn) {
    const long long b = i / sn, rest = i % sn;
    float sb = 0.0f, sc = 0.0f;
    for (int h = 0; h < p.H; ++h) {
      const long long at = (b * p.H + h) * sn + rest;
      sb += p.db_part[at];
      sc += p.dc_part[at];
    }
    static_cast<T*>(p.db)[i] = from_f<T>(sb);
    static_cast<T*>(p.dc)[i] = from_f<T>(sc);
  }
  if (i < p.H) {
    float sa = 0.0f, sd = 0.0f;
    for (int b = 0; b < p.B; ++b) {
      sa += p.da_part[static_cast<long long>(b) * p.H + i];
      sd += p.dd_part[static_cast<long long>(b) * p.H + i];
    }
    p.da[i] = sa;
    p.dd[i] = sd;
  }
}

template <typename T>
cudaError_t launch_bwd(const SsdBwdParams& p, cudaStream_t s) {
  const int bytes = sb_smem_floats(p.P, p.N) * 4;
  auto scan = ssd_bwd_scan<T>;
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  scan<<<dim3(p.H, p.B), SB_THREADS, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(p.B) * p.S * p.N;
  const long long total = n > p.H ? n : p.H;
  ssd_bwd_reduce<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

using repro::SsdBwdParams;

// Dynamic shared memory of the scan kernel at head dim p and state dim n.
extern "C" int ssd_scan_bwd_smem(int p, int n) {
  return repro::sb_smem_floats(p, n) * 4;
}

// Launches the scan and the reduction in turn on `stream`; returns the
// first launch error.
extern "C" int ssd_scan_bwd(const SsdBwdParams* params, void* stream) {
  const SsdBwdParams& p = *params;
  if (p.B < 1 || p.B > 65535 || p.S < 1 || p.H < 1 || p.H > 65535 ||
      p.P < 1 || p.P > 64 || p.N < 1 || p.N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.dtype == 1)
    err = repro::launch_bwd<__nv_bfloat16>(p, s);
  else
    err = repro::launch_bwd<float>(p, s);
  return static_cast<int>(err);
}
