// Backward of the Mamba-2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its chunked scan
// (src/repro/kernels/ssd/ref.py:26 ssd_chunked) by autodiff in XLA, and
// its Pallas kernel (src/repro/kernels/ssd/kernel.py:78) has no backward.
// This file computes that gradient for the training step from x [B,S,H,P],
// dt [B,S,H], a [H], B/C [B,S,N] (one group), d_skip [H], the warm start
// h0 [B,H,P,N] and the incoming gradients gy [B,S,H,P] and gstate
// [B,H,P,N] (either may be absent: zeros).  Plain version:
// kernels/ssd/ref.py::ssd_chunked_bwd (float32, op for op the SIMT kernel
// below); the bfloat16 kernels' rounding: ref.py::ssd_bwd_model.
//
// The algorithm, per (sequence, head) and chunk of Q = 64 positions, from
// the state entering the chunk h_c and the gradient of the state leaving
// it dh_c (cum: the within-chunk prefix sums of dt a; x dt written xw):
//   every pair j <= i: the scores C_i.B_j, dw_ij = <gy_i, xw_j>, the decay
//   exp(min(cum_i - cum_j, 0)), w = scores x decay, dS = dw x decay and,
//   below the diagonal where the clamp passes its gradient, dw x w (into
//   dcum_i and -dcum_j);
//   dC = dS B + exp(cum) gy h_c and its dcum share; dB = dS^T C +
//   exp(cum_Q - cum) xw dh_c and its dcum share; d(xw) = w^T gy +
//   exp(cum_Q - cum) B dh_c^T, which gives dx = d(xw) dt + D gy and
//   <d(xw), x>; dseg = <dh_c, h_c> exp(cum_Q) + the state decay's shares;
//   dA = the reverse cumsum of dcum (dseg at the chunk's last position),
//   ddt = dA a + <d(xw), x>, the chunk's share of da = sum dA dt and of
//   dD = sum <x, gy>;
// the carries: h_{c+1} = h_c exp(cum_Q) + (B exp(cum_Q - cum))^T xw from
// h0 (rounded to x's type), dh_{c-1} = dh_c exp(cum_Q) + (C exp(cum))^T gy
// from gstate; dh after chunk 0 is dh0.  dB and dC are summed over the
// heads, da and dD over sequences and chunks, every cross-block sum in a
// second pass in one fixed pairwise order (no atomics anywhere: two calls
// are bitwise equal, as the trainer's bitwise restore needs).  Positions
// past S load as zeros with dt = 0 and gy = 0, as the forward pads.  P <=
// 64 and N <= 128.  Outputs: dx in x's type, dB and dC in B's type, ddt,
// da, dD and dh0 in float32.
//
// Bound: bytes.  At the zamba2 training shape (B=4, S=2048, H=80, P=64,
// N=64, bf16) the function reads x, gy, B, C, dt and writes dx, dB, dC,
// ddt once: 261 MB (0.078 ms at 3.35 TB/s) against 53.7 G operations
// (0.054 ms on the bf16 tensor cores).
//
// bfloat16 -- three kernels, every product on wgmma (64-row tiles, bf16
// operands, float32 accumulators), x, gy, B and C by TMA into rings a
// producer warp keeps full (hopper.cuh; the forward's ssd_scan_tc shape).
// Against the one-block-a-(head, sequence) SIMT kernel that ran bf16
// before (PERF.md, PR 21: 8.69 ms at the training shape, 112x its bound):
// (1) its ten SIMT float32 products a chunk are wgmma products; (2) its
// 320 blocks of 512 threads, one an SM in 2.4 waves, become persistent
// consumers over 10240 (head, chunk) items; (3) its two serial walks over
// the 32 chunks, ~12 barriers a chunk, shrink to the carries alone, one
// product and an element-wise update a chunk; (4) its ~1.2 GB of float32
// scratch traffic falls to ~0.85 GB (below).
//  * ssd_bwd_walk_tc: the carries, one item per (sequence, head,
//    direction), persistent blocks of three consumer warpgroups (two at N
//    > 64), a launch of 2 B H items (640 at the training shape: two rounds
//    on 396 consumers; both directions of a (sequence, head) in one
//    consumer, one round, ran slower: PERF.md, PR 22).  The forward
//    direction streams x and B, the reverse gy and C; per chunk one
//    product into the state kept in float32 registers, A = the B (C) tile
//    transposed by ldmatrix.trans and scaled a position at a time by
//    exp(cum_Q - cum) dt (exp(cum)), B = the x (gy) tile as it arrived;
//    before each update the state is stored rounded to bf16, rows n of 64
//    p, into scratch [B, H, nc, NM, 64] (NM: N rounded up to 64 or 128).
//    The chunks' own state terms are products inside the walk, so they
//    never leave the SM.  cum, the in-order running sum, is formed here
//    and the forward direction keeps it in scratch [B, H, nc, 64] for the
//    chunk kernel.
//  * ssd_bwd_chunk_tc: everything else, one work unit per (sequence, chunk,
//    group of GROUP heads), B nc ceil(H / GROUP) units (1280 at the
//    training shape) over persistent blocks of two consumer warpgroups,
//    one unit each at a time (4.85 units a consumer on 132 SMs: the last
//    round keeps 85% of them busy).  Per head, x, gy, B, C, h_c and dh_c
//    arrive by TMA (the states through a 2-d view of the scratch), dt and
//    the walk's cum by plain loads.  Ten products: S = C B^T and gy x^T,
//    then S^T = B C^T and x gy^T (B4-bwd's trick: the transposed
//    orientation's accumulator rows are the positions j, so w^T and dS^T
//    pack straight into the register A operand, and the clamp's column
//    sums are its row sums, a sum inside each quad of lanes); dC += dS B
//    and t1 = gy h_c; dB += dS^T C and t2 = x dh_c; z = w^T gy and v = B
//    dh_c^T (B by ldmatrix).  x dt is never rounded: dt scales the float32
//    results of the products of x (dw, t2), as exp(cum) and exp(cum_Q -
//    cum) scale t1, t2 and v.  dC and dB stay in float32 registers across
//    the unit's heads, added in head order, and leave once a unit:
//    partials [B, H / GROUP, S, N].  Every per-position sum lands on the
//    threads that hold that position's accumulator rows; dcum meets the
//    reverse cumsum through shared memory (one named barrier a head),
//    where the state decay's share of dcum enters dA as the sum of its
//    values before each position (the same sum as adding their total at
//    the chunk's end and subtracting them again, without that
//    cancellation).  The decay matrix takes one ex2 an element an
//    orientation.
//  * ssd_bwd_reduce: dB and dC over the head groups and da, dD over the
//    (sequence, chunk) partials, pairwise.
//  Rounded to bf16 (ref.py::ssd_bwd_model): the walks' scaled B and C,
//  h_c and dh_c (their carries stay float32), dS, dS^T and w^T.
//  Bytes at the training shape: the walk reads x and gy (168 MB) and writes
//  h_c and dh_c (168 MB); the chunk kernel reads x, gy, h_c, dh_c (336
//  MB) and writes dx (84 MB), ddt and the dB/dC partials (42 MB, GROUP =
//  8); the reduction reads those and writes dB, dC: ~0.85 GB a call.  The
//  state round trip (336 MB) is what the chunk-parallel design pays for
//  its independent (head, chunk) items.  GROUP is 8 at N <= 64 and 1 at N
//  <= 128, where the persistent dB and dC accumulators (128 registers) do
//  not fit beside the products; N <= 128 also runs a one-stage ring (two
//  consumers' two stages would not fit in shared memory).
//
// float32 -- the exact SIMT path (TF32 would miss float32's tolerance):
//  * ssd_bwd_scan: one block of 512 threads per (head, sequence).  A
//    forward walk recomputes the state entering each chunk into a float32
//    scratch [B,H,nc,P,N]; a reverse walk carries dh in shared memory and
//    computes the terms above from float32 tiles in shared memory, each
//    product a 2 x 8 register tile a thread (`mm`: two loads of A and
//    eight of B for sixteen multiply-adds).  dB and dC leave as per-head
//    partials [B,H,S,N], da and dD as per-(sequence, chunk, head) ones.
//  * ssd_bwd_reduce as above, over the heads.
#include "hopper.cuh"
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
  const void* gy;       // [B,S,H,P] contiguous, x's type; null: zeros (float32)
  const float* gstate;  // [B,H,P,N] contiguous; null: zeros
  float* states;        // float32: scratch [B,H,nc,P,N]
  float* cums;          // bfloat16: each chunk's cum, scratch [B,H,nc,64]
  void* hs;             // bfloat16: h_c, scratch [B,H,nc,NM,64]
  void* dhs;            // bfloat16: dh_c, the same
  void* dx;             // [B,S,H,P] contiguous, x's type
  float* ddt;           // [B,S,H] contiguous
  float* db_part;       // scratch [B,groups,S,N]
  float* dc_part;       // scratch [B,groups,S,N]
  float* da_part;       // scratch [B,nc,H]
  float* dd_part;       // scratch [B,nc,H]
  float* dh0;           // [B,H,P,N] contiguous; null: not wanted
  void* db;             // [B,S,N] contiguous, B's type
  void* dc;             // [B,S,N] contiguous, C's type
  float* da;            // [H]
  float* dd;            // [H]
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
  int B, S, H, P, N, dtype, groups;  // groups: head groups of the dB/dC partials
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

  const float* X = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* DT = p.dt + b * p.dt_sb + h;
  const float* Bm = static_cast<const float*>(p.bm) + b * p.b_sb;
  const float* Cm = static_cast<const float*>(p.cm) + b * p.c_sb;
  const float* GY = p.gy ? static_cast<const float*>(p.gy) +
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
      xs[r * LP + d] = in ? X[row * p.x_ss + d] : 0.0f;
      if (all)
        gs[r * LP + d] = in && GY ? GY[static_cast<long long>(row) * p.H * P + d] : 0.0f;
    }
    for (int i = tid; i < SB_Q * N; i += SB_THREADS) {
      const int r = i / N, n = i % N, row = r0 + r;
      const bool in = row < p.S;
      bs[r * LN + n] = in ? Bm[row * p.b_ss + n] : 0.0f;
      if (all) cs[r * LN + n] = in ? Cm[row * p.c_ss + n] : 0.0f;
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
    hp[(i / N) * LN + i % N] = p.h0 ? p.h0[bh * P * N + i] : 0.0f;
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
  float* DX = static_cast<float*>(p.dx) + (static_cast<long long>(b) * p.S * p.H + h) * P;
  for (int c = nc - 1; c >= 0; --c) {
    const int r0 = c * SB_Q;
    __syncthreads();  // the previous chunk's reads are done
    load(c, true);
    for (int i = tid; i < P * N; i += SB_THREADS)
      hp[(i / N) * LN + i % N] = states[static_cast<long long>(c) * P * N + i];
    __syncthreads();
    decays();
    const float gamma = misc[0];
    float dd_c = 0.0f;  // this thread's share of the chunk's <x, gy>

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
          dd_c = fmaf(xv, gv, dd_c);
          if (row < p.S)
            DX[static_cast<long long>(row) * p.H * P + d] = dxw * dts[j] + dskip * gv;
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
      dd_c = block_sum(dd_c, red);
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
      float run = 0.0f, da_c = 0.0f;
      for (int k = SB_Q - 1; k >= 0; --k) {
        run += dcum[k];  // dA_k
        da_c = fmaf(run, dts[k], da_c);
        if (r0 + k < p.S)
          p.ddt[(static_cast<long long>(b) * p.S + r0 + k) * p.H + h] = run * a + xdot[k];
      }
      const long long at = (static_cast<long long>(b) * nc + c) * p.H + h;
      p.da_part[at] = da_c;
      p.dd_part[at] = dd_c;
    }
  }

  if (p.dh0)
    for (int i = tid; i < P * N; i += SB_THREADS)
      p.dh0[bh * P * N + i] = dh[(i / N) * LN + i % N];
}

// The sum of x(0), ..., x(n - 1) in one fixed pairwise order: runs of 2^k
// terms are added to their equal neighbours as they complete, the leftover
// runs from the last to the first.  Up to 16 terms the same sums run as a
// tree in registers (padded with zeros, which add exactly).
template <typename F>
__device__ float pairwise_sum(int n, F x) {
  if (n <= 16) {
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = i < n ? x(i) : 0.0f;
#pragma unroll
    for (int w = 1; w < 16; w *= 2)
#pragma unroll
      for (int i = 0; i + w < 16; i += 2 * w) v[i] += v[i + w];
    return v[0];
  }
  float run[32];
  int level[32], top = 0;
  for (int i = 0; i < n; ++i) {
    float v = x(i);
    int l = 0;
    while (top > 0 && level[top - 1] == l) {
      v = run[--top] + v;
      ++l;
    }
    run[top] = v;
    level[top++] = l;
  }
  float s = 0.0f;
  for (int k = top - 1; k >= 0; --k) s = k == top - 1 ? run[k] : run[k] + s;
  return s;
}

// dB and dC summed over the head groups (the first `bc_blocks` blocks, an
// element a thread), da and dD over the (sequence, chunk) partials (a block
// a head after them: each thread pairwise over rows tid, tid + 256, ...,
// then a tree over the threads), each in one fixed pairwise order.
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce(const SsdBwdParams p, int bc_blocks) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < bc_blocks) {
    const long long i = static_cast<long long>(blockIdx.x) * 256 + tid;
    const long long sn = static_cast<long long>(p.S) * p.N;
    if (i >= p.B * sn) return;
    const long long b = i / sn, rest = i % sn;
    const float* db = p.db_part + b * p.groups * sn + rest;
    const float* dc = p.dc_part + b * p.groups * sn + rest;
    static_cast<T*>(p.db)[i] = from_f<T>(pairwise_sum(p.groups, [&](int g) { return db[g * sn]; }));
    static_cast<T*>(p.dc)[i] = from_f<T>(pairwise_sum(p.groups, [&](int g) { return dc[g * sn]; }));
    return;
  }
  __shared__ float sa[256], sd[256];
  const int h = blockIdx.x - bc_blocks;
  const int rows = p.B * ((p.S + SB_Q - 1) / SB_Q);
  const int cnt = tid < rows ? (rows - tid + 255) / 256 : 0;
  auto at = [&](int k) { return static_cast<long long>(tid + 256 * k) * p.H + h; };
  sa[tid] = pairwise_sum(cnt, [&](int k) { return p.da_part[at(k)]; });
  sd[tid] = pairwise_sum(cnt, [&](int k) { return p.dd_part[at(k)]; });
  __syncthreads();
  for (int off = 128; off > 0; off >>= 1) {
    if (tid < off) {
      sa[tid] += sa[tid + off];
      sd[tid] += sd[tid + off];
    }
    __syncthreads();
  }
  if (tid == 0) {
    p.da[h] = sa[0];
    p.dd[h] = sd[0];
  }
}

// ------------------------------------------------- bfloat16: tensor cores

constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = 2^(x log2 e)

// v's two bf16 values times lo and hi, rounded to bf16.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo, float hi) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return sm90::pack_bf16(__low2float(x) * lo, __high2float(x) * hi);
}

// Byte offset of element pair (row, 8 c + 2 t) in a tile of 128-byte rows
// written with the 128-byte swizzle (16-byte chunk c moves to c ^ row % 8).
__device__ __forceinline__ uint32_t swz(int row, int c, int t) {
  return row * 128 + ((c ^ (row & 7)) << 4) + 4 * t;
}

// The two float values of the bf16 pair at `at`, or in `v`.
__device__ __forceinline__ float2 bf2(const uint8_t* at) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
}
__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Sum over the four lanes of a quad (the threads that share accumulator
// rows), the same bits in each.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// cum, the chunk's running sum of dt a over the 64 positions whose dt is in
// `dt`, added in order as the reference's cumsum adds it (the decays rest
// on differences of nearby running sums, which at |cum| in the thousands
// carry the sums' rounding: PERF.md, PR 21): every lane of the warp adds
// the same 64 products, broadcast by shuffles, and keeps positions lane
// (c_lo) and lane + 32 (c_hi).  Returns seg = cum_Q.
__device__ __forceinline__ float chunk_cum(const float* dt, float a, int lane,
                                           float& c_lo, float& c_hi) {
  const float p_lo = dt[lane] * a, p_hi = dt[lane + 32] * a;
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    run += __shfl_sync(0xffffffffu, p_lo, j);
    if (lane == j) c_lo = run;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    run += __shfl_sync(0xffffffffu, p_hi, j);
    if (lane == j) c_hi = run;
  }
  return run;
}

// Sizes of the walk kernel at state width NM (64 or 128): the forward's.
template <int NM>
struct Walk {
  static constexpr int CONS = NM == 64 ? 3 : 2;     // consumer warpgroups
  static constexpr int THREADS = 128 * (CONS + 1);
  static constexpr int PROD_REGS = NM == 64 ? 32 : 40;
  static constexpr int CONS_REGS = NM == 64 ? 160 : 232;
  static constexpr int X = SB_Q * 128;              // x or gy: 64 rows of 128 B
  static constexpr int BC = NM * 128;               // B or C: NM / 64 slabs of 8 KB
  static constexpr int STAGE = X + BC;
  static constexpr int TILES = 2 * STAGE;
  // dt and the scale table of both stages; full[2], empty[2]
  static constexpr int SMALL = 4 * SB_Q * 4 + 4 * 8;
  static constexpr int SMEM = CONS * (TILES + SMALL) + 1024;
};

// Item w: direction w & 1 (0: h forward from x and B; 1: dh in reverse
// from gy and C) of (sequence, head) w >> 1.
template <int NM>
__global__ void __launch_bounds__(Walk<NM>::THREADS, 1)
ssd_bwd_walk_tc(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_gy,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c, const SsdBwdParams p) {
  using namespace sm90;
  using K = Walk<NM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const int items = 2 * p.B * p.H;
  const int nc = (p.S + SB_Q - 1) / SB_Q;
  const int wg = threadIdx.x / 128;

  // consumer c: stage s at base + c * TILES + s * STAGE (x or gy, then B or
  // C); small area at base + CONS * TILES + c * SMALL: dt[2][64],
  // scale[2][64], full[2], empty[2]
  auto tiles = [&](int c) { return static_cast<uint32_t>(c * K::TILES); };
  auto small = [&](int c) {
    return static_cast<uint32_t>(K::CONS * K::TILES + c * K::SMALL);
  };
  auto dt_at = [&](int c, int s) {
    return reinterpret_cast<float*>(gbase + small(c) + s * SB_Q * 4);
  };
  auto full = [&](int c, int s) { return base + small(c) + 4 * SB_Q * 4 + 8 * s; };
  auto empty = [&](int c, int s) { return full(c, s) + 16; };

  if (threadIdx.x == 0) {
    for (int c = 0; c < K::CONS; ++c)
      for (int s = 0; s < 2; ++s) {
        mbar_init(full(c, s), 33);     // the TMA bytes' arrival + 32 lanes
        mbar_init(empty(c, s), 128);   // every consumer thread
      }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup: warp c fills consumer c's ring
    reg_dealloc<K::PROD_REGS>();
    const int c = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (c >= K::CONS) return;
    int it = 0;
    for (int w = blockIdx.x + gridDim.x * c; w < items;
         w += gridDim.x * K::CONS) {
      const int dir = w & 1, b = (w >> 1) / p.H, h = (w >> 1) % p.H;
      const float* DT = p.dt + b * p.dt_sb + h;
      for (int k = 0; k < nc; ++k, ++it) {
        const int ch = dir ? nc - 1 - k : k, s = it & 1;
        mbar_wait(empty(c, s), ((it >> 1) & 1) ^ 1);
        const uint32_t st = base + tiles(c) + s * K::STAGE;
        if (lane == 0) {
          mbar_expect_tx(full(c, s), K::STAGE);
          tma_load_4d(st, dir ? &tm_gy : &tm_x, full(c, s), 0, h, ch * SB_Q, b);
          for (int j = 0; j < NM / 64; ++j)
            tma_load_4d(st + K::X + j * 8192, dir ? &tm_c : &tm_b, full(c, s),
                        j * 64, 0, ch * SB_Q, b);
        }
        float* dts = dt_at(c, s);
        for (int r = lane; r < SB_Q; r += 32) {
          const int pos = ch * SB_Q + r;
          dts[r] = pos < p.S ? DT[static_cast<long long>(pos) * p.dt_ss] : 0.0f;
        }
        mbar_arrive(full(c, s));
      }
    }
    return;
  }

  // ---- consumer warpgroup c: one item at a time
  reg_alloc<K::CONS_REGS>();
  const int c = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int q = lane >> 3;                       // ldmatrix: this lane's matrix
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;  // accumulator rows
  const int bar = 1 + c;
  int it = 0;
  for (int w = blockIdx.x + gridDim.x * c; w < items; w += gridDim.x * K::CONS) {
    const int dir = w & 1, bh = w >> 1;
    const float a = p.a[bh % p.H];
    // the carry, sacc[m][4 cb + 2 rr + e] holding element (n = 64 m + (rr
    // ? r1 : r0), pp = 8 cb + 2 t + e): h from the warm start rounded to
    // bf16, dh from gstate, or zeros
    const float* const init = dir ? p.gstate : p.h0;
    float sacc[NM / 64][32];
#pragma unroll
    for (int m = 0; m < NM / 64; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int n = m * 64 + ((i & 2) ? r1 : r0);
        const int pp = 8 * (i >> 2) + 2 * t + (i & 1);
        float v = 0.0f;
        if (init && n < p.N && pp < p.P) {
          v = init[(static_cast<long long>(bh) * p.P + pp) * p.N + n];
          if (!dir) v = rnd<__nv_bfloat16>(v);
        }
        sacc[m][i] = v;
      }
    __nv_bfloat16* const out =
        static_cast<__nv_bfloat16*>(dir ? p.dhs : p.hs) +
        static_cast<long long>(bh) * nc * NM * 64;

    for (int k = 0; k < nc; ++k, ++it) {
      const int ch = dir ? nc - 1 - k : k, s = it & 1;
      const uint32_t sx = base + tiles(c) + s * K::STAGE, sbc = sx + K::X;
      const float* const dt = dt_at(c, s);
      float* const sc_t = dt_at(c, 2 + s);
      mbar_wait(full(c, s), (it >> 1) & 1);

      // the A operand's scale a position: exp(cum_Q - cum) dt (forward),
      // exp(cum) (reverse); each warp its quarter.  The forward direction
      // keeps cum for the chunk kernel.
      float c_lo, c_hi;
      const float seg = chunk_cum(dt, a, lane, c_lo, c_hi);
      if ((lane >> 4) == (warp & 1)) {
        const float cj = warp < 2 ? c_lo : c_hi;
        const int j = (warp < 2 ? 0 : 32) + lane;
        sc_t[j] = dir ? expf(cj) : expf(seg - cj) * dt[j];
      }
      if (!dir && warp == 0) {
        float* const cums = p.cums + (static_cast<long long>(bh) * nc + ch) * SB_Q;
        cums[lane] = c_lo;
        cums[lane + 32] = c_hi;
      }
      // the state entering chunk ch (forward) or the gradient of the one
      // leaving it (reverse), rounded to bf16: rows n of 64 pp
      __nv_bfloat16* const img = out + static_cast<long long>(ch) * NM * 64;
#pragma unroll
      for (int m = 0; m < NM / 64; ++m)
#pragma unroll
        for (int cb = 0; cb < 8; ++cb)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int n = m * 64 + (rr ? r1 : r0);
            *reinterpret_cast<uint32_t*>(img + n * 64 + 8 * cb + 2 * t) =
                pack_bf16(sacc[m][4 * cb + 2 * rr], sacc[m][4 * cb + 2 * rr + 1]);
          }
      named_barrier(bar, 128);   // the scale table is in

      // A = (B or C)^T [n x position] by ldmatrix.trans, scaled a position
      // at a time and rounded to bf16
      uint32_t bw[NM / 64][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 e = *reinterpret_cast<const float2*>(&sc_t[kk * 16 + 2 * t]);
        const float2 f = *reinterpret_cast<const float2*>(&sc_t[kk * 16 + 8 + 2 * t]);
        const int j = kk * 16 + (q >> 1) * 8 + (lane & 7);  // stored row
#pragma unroll
        for (int m = 0; m < NM / 64; ++m) {
          const int n = m * 64 + warp * 16 + (q & 1) * 8;   // stored column
          ldmatrix_x4_trans(bw[m][kk], sbc + (n / 64) * 8192 + swz(j, (n % 64) / 8, 0));
          bw[m][kk][0] = scale_bf16x2(bw[m][kk][0], e.x, e.y);
          bw[m][kk][1] = scale_bf16x2(bw[m][kk][1], e.x, e.y);
          bw[m][kk][2] = scale_bf16x2(bw[m][kk][2], f.x, f.y);
          bw[m][kk][3] = scale_bf16x2(bw[m][kk][3], f.x, f.y);
        }
      }
      const float gamma = expf(seg);
#pragma unroll
      for (int m = 0; m < NM / 64; ++m) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[m][i] *= gamma;
        fence_regs(sacc[m]);
        fence_regs(bw[m]);
      }
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < NM / 64; ++m)       // += (A scaled)^T (x or gy)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64>(sacc[m], bw[m][kk], slab_desc(sx + kk * 2048, K::X, 1024, 1));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < NM / 64; ++m) {
        fence_regs(sacc[m]);
        fence_regs(bw[m]);
      }
      mbar_arrive(empty(c, s));
    }

    if (dir && p.dh0) {   // the warm start's gradient [P, N] in float32
      float* const d0 = p.dh0 + static_cast<long long>(bh) * p.P * p.N;
#pragma unroll
      for (int m = 0; m < NM / 64; ++m)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int n = m * 64 + ((i & 2) ? r1 : r0);
          const int pp = 8 * (i >> 2) + 2 * t + (i & 1);
          if (n < p.N && pp < p.P) d0[pp * p.N + n] = sacc[m][i];
        }
    }
  }
}

// Sizes of the chunk kernel at state width NM (64 or 128).
template <int NM>
struct Chunk {
  static constexpr int CONS = 2;                    // consumer warpgroups
  static constexpr int THREADS = 128 * (CONS + 1);
  static constexpr int STAGES = NM == 64 ? 2 : 1;
  static constexpr int GROUP = NM == 64 ? 8 : 1;   // heads a unit
  static constexpr int X = SB_Q * 128;              // x, gy: 64 rows of 128 B
  static constexpr int T = NM * 128;                // B, C, h_c, dh_c
  static constexpr int STAGE = 2 * X + 4 * T;
  static constexpr int TILES = STAGES * STAGE;
  // dt and cum a stage; exp(cum), exp(cum_Q - cum), dcum, dsd; red[16];
  // full, empty a stage
  static constexpr int SMALL = 2 * STAGES * SB_Q * 4 + 4 * SB_Q * 4 + 16 * 4 +
                               STAGES * 16;
  static constexpr int SMEM = CONS * (TILES + SMALL) + 1024;
};

template <int NM>
__global__ void __launch_bounds__(Chunk<NM>::THREADS, 1)
ssd_bwd_chunk_tc(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_gy,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_dh, const SsdBwdParams p) {
  using namespace sm90;
  using K = Chunk<NM>;
  constexpr int NS = K::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const int nc = (p.S + SB_Q - 1) / SB_Q;
  const int units = p.B * nc * p.groups;
  const int wg = threadIdx.x / 128;

  // consumer c: stage s at base + c * TILES + s * STAGE (x, gy, B, C, h_c,
  // dh_c); small area at base + CONS * TILES + c * SMALL: dt[NS][64],
  // cum[NS][64], exp(cum), exp(cum_Q - cum), dcum, dsd [64] each,
  // red[16], full[NS], empty[NS]
  auto tiles = [&](int c) { return static_cast<uint32_t>(c * K::TILES); };
  auto small = [&](int c) {
    return static_cast<uint32_t>(K::CONS * K::TILES + c * K::SMALL);
  };
  auto fl = [&](int c, int i) {    // float i of consumer c's small area
    return reinterpret_cast<float*>(gbase + small(c)) + i;
  };
  constexpr int BARS = 2 * NS * SB_Q + 4 * SB_Q + 16;   // floats before the barriers
  auto full = [&](int c, int s) { return base + small(c) + BARS * 4 + 8 * s; };
  auto empty = [&](int c, int s) { return full(c, s) + 8 * NS; };
  // unit u: head group g of chunk ch of sequence b
  auto unit = [&](int u, int& b, int& ch, int& h_lo, int& h_hi) {
    const int g = u % p.groups, bc = u / p.groups;
    ch = bc % nc;
    b = bc / nc;
    h_lo = g * K::GROUP;
    h_hi = min(p.H, h_lo + K::GROUP);
  };

  if (threadIdx.x == 0) {
    for (int c = 0; c < K::CONS; ++c)
      for (int s = 0; s < NS; ++s) {
        mbar_init(full(c, s), 33);
        mbar_init(empty(c, s), 128);
      }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer warpgroup: warp c fills consumer c's ring
    reg_dealloc<24>();
    const int c = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (c >= K::CONS) return;
    int it = 0;
    for (int u = blockIdx.x + gridDim.x * c; u < units; u += gridDim.x * K::CONS) {
      int b, ch, h_lo, h_hi;
      unit(u, b, ch, h_lo, h_hi);
      for (int h = h_lo; h < h_hi; ++h, ++it) {
        const int s = it % NS;
        mbar_wait(empty(c, s), ((it / NS) & 1) ^ 1);
        const uint32_t st = base + tiles(c) + s * K::STAGE;
        if (lane == 0) {
          const uint32_t f = full(c, s);
          const int row = ((b * p.H + h) * nc + ch) * NM;   // of the state views
          mbar_expect_tx(f, K::STAGE);
          tma_load_4d(st, &tm_x, f, 0, h, ch * SB_Q, b);
          tma_load_4d(st + K::X, &tm_gy, f, 0, h, ch * SB_Q, b);
          for (int j = 0; j < NM / 64; ++j) {
            const uint32_t o = st + 2 * K::X + j * 8192;
            tma_load_4d(o, &tm_b, f, j * 64, 0, ch * SB_Q, b);
            tma_load_4d(o + K::T, &tm_c, f, j * 64, 0, ch * SB_Q, b);
            tma_load_4d(o + 2 * K::T, &tm_h, f, 0, 0, row + j * 64, 0);
            tma_load_4d(o + 3 * K::T, &tm_dh, f, 0, 0, row + j * 64, 0);
          }
        }
        const float* DT = p.dt + b * p.dt_sb + h;
        float* dts = fl(c, s * SB_Q);
        for (int r = lane; r < SB_Q; r += 32) {
          const int pos = ch * SB_Q + r;
          dts[r] = pos < p.S ? DT[static_cast<long long>(pos) * p.dt_ss] : 0.0f;
        }
        const float* CUM = p.cums + ((static_cast<long long>(b) * p.H + h) * nc + ch) * SB_Q;
        float* cms = fl(c, (NS + s) * SB_Q);
        cms[lane] = CUM[lane];
        cms[lane + 32] = CUM[lane + 32];
        mbar_arrive(full(c, s));
      }
    }
    return;
  }

  // ---- consumer warpgroup c: one unit at a time, its heads in order
  reg_alloc<240>();
  const int c = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int q = lane >> 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;  // accumulator rows
  float* const e_t = fl(c, 2 * NS * SB_Q);   // exp(cum)
  float* const sd_t = e_t + SB_Q;      // exp(cum_Q - cum)
  float* const dcum_t = sd_t + SB_Q;   // dcum but the state decay's share
  float* const dsd_t = dcum_t + SB_Q;  // the state decay's share
  float* const red = dsd_t + SB_Q;     // [warp][4]
  const int bar = 1 + c;
  int it = 0;
  for (int u = blockIdx.x + gridDim.x * c; u < units; u += gridDim.x * K::CONS) {
    int b, ch, h_lo, h_hi;
    unit(u, b, ch, h_lo, h_hi);
    // dC and dB of the unit's heads, rows r0, r1 (positions), columns n,
    // leaving as partials [B, groups, S, N] once a unit (GROUP 1: as soon
    // as each is complete, so that neither stays live beside the other's
    // products)
    float dcacc[NM / 2], dbacc[NM / 2];
    const long long part = ((static_cast<long long>(b) * p.groups + h_lo / K::GROUP) * p.S
                            + ch * SB_Q) * p.N;
    auto store_part = [&](const float (&acc)[NM / 2], float* dst) {
#pragma unroll
      for (int cb = 0; cb < NM / 8; ++cb) {
        const int n = 8 * cb + 2 * t;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int j = rr ? r1 : r0;
          if (ch * SB_Q + j < p.S && n < p.N)
            *reinterpret_cast<float2*>(dst + part + static_cast<long long>(j) * p.N + n) =
                make_float2(acc[4 * cb + 2 * rr], acc[4 * cb + 2 * rr + 1]);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < NM / 2; ++i) dcacc[i] = dbacc[i] = 0.0f;

    for (int h = h_lo; h < h_hi; ++h, ++it) {
      if constexpr (K::GROUP == 1) {
#pragma unroll
        for (int i = 0; i < NM / 2; ++i) dcacc[i] = dbacc[i] = 0.0f;
      }
      const int s = it % NS;
      const uint32_t sx = base + tiles(c) + s * K::STAGE, sgy = sx + K::X;
      const uint32_t sb = sgy + K::X, sc = sb + K::T, sh = sc + K::T, sdh = sh + K::T;
      const uint8_t* const x_g = gbase + tiles(c) + s * K::STAGE;
      const uint8_t* const gy_g = x_g + K::X;
      const uint8_t* const b_g = gy_g + K::X;
      const uint8_t* const c_g = b_g + K::T;
      const uint8_t* const h_g = c_g + K::T;
      const uint8_t* const dh_g = h_g + K::T;
      const float* const dt = fl(c, s * SB_Q);
      const float* const cum_t = fl(c, (NS + s) * SB_Q);
      const float a = p.a[h], dskip = p.d_skip ? p.d_skip[h] : 0.0f;
      mbar_wait(full(c, s), (it / NS) & 1);

      const float seg = cum_t[SB_Q - 1];
      if (lane < 16) {
        const int j = warp * 16 + lane;
        e_t[j] = expf(cum_t[j]);
        sd_t[j] = expf(seg - cum_t[j]);
      }
      const float gamma = expf(seg);
      named_barrier(bar, 128);   // the tables are in

      // 1. S = C B^T and gy x^T (dw = its column j times dt_j): rows i
      float sacc[32], wacc[32];
      fence_regs(sacc);
      fence_regs(wacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NM / 16; ++kk) {
        const uint32_t o = (kk / 4) * 8192 + (kk % 4) * 32;
        wgmma_ss<64>(sacc, slab_desc(sc + o, 16, 1024, 1),
                     slab_desc(sb + o, 16, 1024, 1), kk);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(wacc, slab_desc(sgy + kk * 32, 16, 1024, 1),
                     slab_desc(sx + kk * 32, 16, 1024, 1), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(wacc);
      // dS (j <= i) packed as the A operand of dS B; the clamp's share dw x
      // w (j < i where cum_i <= cum_j) summed along the rows.  Fragment
      // x[4 cb + e]: row (e & 2 ? r1 : r0), column 8 cb + 2 t + (e & 1).
      uint32_t dsf[4][4];
      float g0 = 0.0f, g1 = 0.0f;
      {
        const float ci[2] = {cum_t[r0], cum_t[r1]};
#pragma unroll
        for (int cb = 0; cb < 8; ++cb) {
          const int j = 8 * cb + 2 * t;
          const float2 cj = *reinterpret_cast<const float2*>(&cum_t[j]);
          const float2 dj = *reinterpret_cast<const float2*>(&dt[j]);
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (e & 2) ? r1 : r0, col = j + (e & 1);
            const float u_ = ci[e >> 1] - ((e & 1) ? cj.y : cj.x);
            const float dec = ex2(fminf(u_, 0.0f) * LOG2E);
            const float dw = wacc[4 * cb + e] * ((e & 1) ? dj.y : dj.x);
            ds[e] = col <= row ? dw * dec : 0.0f;
            if (col < row && u_ <= 0.0f) {
              const float gv = dw * (sacc[4 * cb + e] * dec);
              if (e & 2) g1 += gv; else g0 += gv;
            }
          }
          dsf[cb / 2][(cb & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
          dsf[cb / 2][(cb & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
      }

      // 2. S^T = B C^T and x gy^T: rows j
      fence_regs(sacc);
      fence_regs(wacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NM / 16; ++kk) {
        const uint32_t o = (kk / 4) * 8192 + (kk % 4) * 32;
        wgmma_ss<64>(sacc, slab_desc(sb + o, 16, 1024, 1),
                     slab_desc(sc + o, 16, 1024, 1), kk);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(wacc, slab_desc(sx + kk * 32, 16, 1024, 1),
                     slab_desc(sgy + kk * 32, 16, 1024, 1), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(wacc);
      // w^T and dS^T (i >= j) packed; the clamp's share summed along the
      // rows j (the column sums of the untransposed pairs)
      uint32_t wtf[4][4], dstf[4][4];
      float gt0 = 0.0f, gt1 = 0.0f;
      {
        const float cjr[2] = {cum_t[r0], cum_t[r1]};
        const float djr[2] = {dt[r0], dt[r1]};
#pragma unroll
        for (int cb = 0; cb < 8; ++cb) {
          const int i = 8 * cb + 2 * t;
          const float2 ci = *reinterpret_cast<const float2*>(&cum_t[i]);
          float wv[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (e & 2) ? r1 : r0, col = i + (e & 1);
            const float u_ = ((e & 1) ? ci.y : ci.x) - cjr[e >> 1];
            const float dec = ex2(fminf(u_, 0.0f) * LOG2E);
            const float dw = wacc[4 * cb + e] * djr[e >> 1];
            const float w = sacc[4 * cb + e] * dec;
            wv[e] = col >= row ? w : 0.0f;
            ds[e] = col >= row ? dw * dec : 0.0f;
            if (col > row && u_ <= 0.0f) {
              if (e & 2) gt1 += dw * w; else gt0 += dw * w;
            }
          }
          wtf[cb / 2][(cb & 1) * 2 + 0] = pack_bf16(wv[0], wv[1]);
          wtf[cb / 2][(cb & 1) * 2 + 1] = pack_bf16(wv[2], wv[3]);
          dstf[cb / 2][(cb & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
          dstf[cb / 2][(cb & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
      }

      // 3. dC += dS B and t1 = gy h_c: rows i, columns n
      float t1[NM / 2];
      fence_regs(dcacc);
      fence_regs(t1);
      fence_regs(dsf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<NM>(dcacc, dsf[kk], slab_desc(sb + kk * 2048, 8192, 1024, 1));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<NM>(t1, slab_desc(sgy + kk * 32, 16, 1024, 1),
                     slab_desc(sh + kk * 32, 16, 1024, 1), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dcacc);
      fence_regs(t1);
      fence_regs(dsf);
      // dC += exp(cum_i) t1; dcum_i += exp(cum_i) <C_i, t1_i>
      float de0 = 0.0f, de1 = 0.0f;
      {
        const float e0 = e_t[r0], e1 = e_t[r1];
#pragma unroll
        for (int cb = 0; cb < NM / 8; ++cb) {
          const float2 v0 = bf2(c_g + (cb / 8) * 8192 + swz(r0, cb % 8, t));
          const float2 v1 = bf2(c_g + (cb / 8) * 8192 + swz(r1, cb % 8, t));
          de0 = fmaf(v0.x, t1[4 * cb + 0], fmaf(v0.y, t1[4 * cb + 1], de0));
          de1 = fmaf(v1.x, t1[4 * cb + 2], fmaf(v1.y, t1[4 * cb + 3], de1));
          dcacc[4 * cb + 0] = fmaf(e0, t1[4 * cb + 0], dcacc[4 * cb + 0]);
          dcacc[4 * cb + 1] = fmaf(e0, t1[4 * cb + 1], dcacc[4 * cb + 1]);
          dcacc[4 * cb + 2] = fmaf(e1, t1[4 * cb + 2], dcacc[4 * cb + 2]);
          dcacc[4 * cb + 3] = fmaf(e1, t1[4 * cb + 3], dcacc[4 * cb + 3]);
        }
        de0 = quad_sum(de0) * e0;
        de1 = quad_sum(de1) * e1;
      }
      if constexpr (K::GROUP == 1) store_part(dcacc, p.dc_part);

      // 4. dB += dS^T C and t2 = x dh_c: rows j, columns n
      float t2[NM / 2];
      fence_regs(dbacc);
      fence_regs(t2);
      fence_regs(dstf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<NM>(dbacc, dstf[kk], slab_desc(sc + kk * 2048, 8192, 1024, 1));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<NM>(t2, slab_desc(sx + kk * 32, 16, 1024, 1),
                     slab_desc(sdh + kk * 32, 16, 1024, 1), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dbacc);
      fence_regs(t2);
      fence_regs(dstf);
      // dB += exp(cum_Q - cum_j) dt_j t2; the state decay's dcum share
      // dsd_j = exp(cum_Q - cum_j) dt_j <B_j, t2_j>
      float dsd0 = 0.0f, dsd1 = 0.0f;
      {
        const float f0 = sd_t[r0] * dt[r0], f1 = sd_t[r1] * dt[r1];
#pragma unroll
        for (int cb = 0; cb < NM / 8; ++cb) {
          const float2 v0 = bf2(b_g + (cb / 8) * 8192 + swz(r0, cb % 8, t));
          const float2 v1 = bf2(b_g + (cb / 8) * 8192 + swz(r1, cb % 8, t));
          dsd0 = fmaf(v0.x, t2[4 * cb + 0], fmaf(v0.y, t2[4 * cb + 1], dsd0));
          dsd1 = fmaf(v1.x, t2[4 * cb + 2], fmaf(v1.y, t2[4 * cb + 3], dsd1));
          dbacc[4 * cb + 0] = fmaf(f0, t2[4 * cb + 0], dbacc[4 * cb + 0]);
          dbacc[4 * cb + 1] = fmaf(f0, t2[4 * cb + 1], dbacc[4 * cb + 1]);
          dbacc[4 * cb + 2] = fmaf(f1, t2[4 * cb + 2], dbacc[4 * cb + 2]);
          dbacc[4 * cb + 3] = fmaf(f1, t2[4 * cb + 3], dbacc[4 * cb + 3]);
        }
        dsd0 = quad_sum(dsd0) * f0;
        dsd1 = quad_sum(dsd1) * f1;
      }
      if constexpr (K::GROUP == 1) store_part(dbacc, p.db_part);

      // 5. z = w^T gy and v = B dh_c^T: rows j, columns pp
      float z[32], v[32];
      uint32_t bfr[NM / 16][4];
      {
        const int row = warp * 16 + (q & 1) * 8 + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < NM / 16; ++kk) {
          const int k = kk * 16 + (q >> 1) * 8;
          ldmatrix_x4(bfr[kk], sb + (k / 64) * 8192 + swz(row, (k % 64) / 8, 0));
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) z[i] = v[i] = 0.0f;
      fence_regs(z);
      fence_regs(v);
      fence_regs(wtf);
      fence_regs(bfr);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<64>(z, wtf[kk], slab_desc(sgy + kk * 2048, 8192, 1024, 1));
#pragma unroll
      for (int kk = 0; kk < NM / 16; ++kk)
        wgmma_rs<64>(v, bfr[kk], slab_desc(sdh + kk * 2048, 8192, 1024, 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(z);
      fence_regs(v);
      fence_regs(wtf);
      fence_regs(bfr);
      // d(xw) = z + exp(cum_Q - cum_j) v; dx = d(xw) dt + D gy (bf16);
      // <d(xw)_j, x_j>; this thread's share of <x, gy>
      float xd0 = 0.0f, xd1 = 0.0f, xg = 0.0f;
      {
        const float s0 = sd_t[r0], s1 = sd_t[r1], d0 = dt[r0], d1 = dt[r1];
        __nv_bfloat16* const DX = static_cast<__nv_bfloat16*>(p.dx) +
            (static_cast<long long>(b) * p.S * p.H + h) * p.P;
#pragma unroll
        for (int cb = 0; cb < 8; ++cb) {
          const int pp = 8 * cb + 2 * t;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int j = rr ? r1 : r0;
            const float sj = rr ? s1 : s0, dj = rr ? d1 : d0;
            const float2 xv = bf2(x_g + swz(j, cb, t));
            const float2 gv = bf2(gy_g + swz(j, cb, t));
            const float a0 = fmaf(sj, v[4 * cb + 2 * rr], z[4 * cb + 2 * rr]);
            const float a1 = fmaf(sj, v[4 * cb + 2 * rr + 1], z[4 * cb + 2 * rr + 1]);
            float& xd = rr ? xd1 : xd0;
            xd = fmaf(a0, xv.x, fmaf(a1, xv.y, xd));
            xg = fmaf(xv.x, gv.x, fmaf(xv.y, gv.y, xg));
            const int pos = ch * SB_Q + j;
            if (pos < p.S && pp < p.P)
              *reinterpret_cast<__nv_bfloat162*>(
                  DX + static_cast<long long>(pos) * p.H * p.P + pp) =
                  __floats2bfloat162_rn(fmaf(a0, dj, dskip * gv.x),
                                        fmaf(a1, dj, dskip * gv.y));
          }
        }
        xd0 = quad_sum(xd0);
        xd1 = quad_sum(xd1);
      }
      // <dh_c, h_c> over the state tiles (the same layout)
      float hh = 0.0f;
      for (int i = tid; i < K::T / 16; i += 128) {
        const uint4 hv = reinterpret_cast<const uint4*>(h_g)[i];
        const uint4 dv = reinterpret_cast<const uint4*>(dh_g)[i];
        const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
        const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 hf = bf2(hw[k]), df = bf2(dw[k]);
          hh = fmaf(hf.x, df.x, fmaf(hf.y, df.y, hh));
        }
      }
      // the block's sums; dcum but the state decay's share, and that share
      {
        const float rs = warp_sum(hh);
        const float xs = warp_sum(xg);
        if (lane == 0) {
          red[warp * 4 + 0] = rs;
          red[warp * 4 + 1] = xs;
        }
        const float rg0 = quad_sum(g0), rg1 = quad_sum(g1);
        const float cg0 = quad_sum(gt0), cg1 = quad_sum(gt1);
        if (t == 0) {
          dcum_t[r0] = rg0 - cg0 + de0;
          dcum_t[r1] = rg1 - cg1 + de1;
          dsd_t[r0] = dsd0;
          dsd_t[r1] = dsd1;
        }
      }
      named_barrier(bar, 128);   // red, dcum and dsd are in
      {
        float hsum = red[0], xsum = red[1];
#pragma unroll
        for (int w = 1; w < 4; ++w) {
          hsum += red[w * 4 + 0];
          xsum += red[w * 4 + 1];
        }
        // dA_k = sum_{i >= k} dcum_i + dseg - sum_{j >= k} dsd_j, where the
        // chunk's decay dseg = <dh_c, h_c> exp(cum_Q) + sum_j dsd_j: so
        // dA_k = the reverse cumsum of dcum + <dh_c, h_c> exp(cum_Q) + the
        // sum of dsd_j over j < k, with no cancellation of dseg's sum.
        // Lane l holds positions l and l + 32.
        float v_lo = dcum_t[lane], v_hi = dcum_t[lane + 32];
        float w_lo = dsd_t[lane], w_hi = dsd_t[lane + 32];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float lo = __shfl_down_sync(0xffffffffu, v_lo, off);
          const float hi = __shfl_down_sync(0xffffffffu, v_hi, off);
          const float plo = __shfl_up_sync(0xffffffffu, w_lo, off);
          const float phi = __shfl_up_sync(0xffffffffu, w_hi, off);
          if (lane + off < 32) {
            v_lo += lo;
            v_hi += hi;
          }
          if (lane >= off) {
            w_lo += plo;
            w_hi += phi;
          }
        }
        v_lo += __shfl_sync(0xffffffffu, v_hi, 0);
        // the exclusive prefix sums of dsd from the inclusive ones
        const float tot_lo = __shfl_sync(0xffffffffu, w_lo, 31);
        float e_lo = __shfl_up_sync(0xffffffffu, w_lo, 1);
        float e_hi = __shfl_up_sync(0xffffffffu, w_hi, 1);
        e_lo = lane == 0 ? 0.0f : e_lo;
        e_hi = lane == 0 ? tot_lo : tot_lo + e_hi;
        const float hg = hsum * gamma;
        v_lo += e_lo + hg;
        v_hi += e_hi + hg;
        const long long at = (static_cast<long long>(b) * nc + ch) * p.H + h;
        if (warp == 0) {
          const float da = warp_sum(fmaf(v_lo, dt[lane], v_hi * dt[lane + 32]));
          if (lane == 0) {
            p.da_part[at] = da;
            p.dd_part[at] = xsum;
          }
        }
        const float a_lo0 = __shfl_sync(0xffffffffu, v_lo, r0 & 31);
        const float a_hi0 = __shfl_sync(0xffffffffu, v_hi, r0 & 31);
        const float a_lo1 = __shfl_sync(0xffffffffu, v_lo, r1 & 31);
        const float a_hi1 = __shfl_sync(0xffffffffu, v_hi, r1 & 31);
        const float dA0 = r0 < 32 ? a_lo0 : a_hi0, dA1 = r1 < 32 ? a_lo1 : a_hi1;
        float* const DDT = p.ddt + static_cast<long long>(b) * p.S * p.H + h;
        const int pos0 = ch * SB_Q + r0, pos1 = ch * SB_Q + r1;
        if (t == 0 && pos0 < p.S) DDT[static_cast<long long>(pos0) * p.H] = fmaf(dA0, a, xd0);
        if (t == 0 && pos1 < p.S) DDT[static_cast<long long>(pos1) * p.H] = fmaf(dA1, a, xd1);
      }
      mbar_arrive(empty(c, s));
    }

    if constexpr (K::GROUP > 1) {
      store_part(dcacc, p.dc_part);
      store_part(dbacc, p.db_part);
    }
  }
}

// Heads a unit of the chunk kernel sums dB and dC over at state dim n.
inline int tc_group(int n) {
  return n <= 64 ? Chunk<64>::GROUP : Chunk<128>::GROUP;
}

cudaError_t launch_reduce(const SsdBwdParams& p, cudaStream_t s) {
  const long long n = static_cast<long long>(p.B) * p.S * p.N;
  const int bc_blocks = static_cast<int>((n + 255) / 256);
  const unsigned grid = static_cast<unsigned>(bc_blocks + p.H);
  if (p.dtype == 1)
    ssd_bwd_reduce<__nv_bfloat16><<<grid, 256, 0, s>>>(p, bc_blocks);
  else
    ssd_bwd_reduce<float><<<grid, 256, 0, s>>>(p, bc_blocks);
  return cudaGetLastError();
}

cudaError_t launch_simt(const SsdBwdParams& p, cudaStream_t s) {
  if (p.groups != p.H) return cudaErrorInvalidValue;
  const int bytes = sb_smem_floats(p.P, p.N) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssd_bwd_scan<<<dim3(p.H, p.B), SB_THREADS, bytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(p, s);
}

template <int NM>
cudaError_t launch_tc(const SsdBwdParams& p, cudaStream_t s) {
  using W = Walk<NM>;
  using K = Chunk<NM>;
  const int nc = (p.S + SB_Q - 1) / SB_Q;
  const long long rows = static_cast<long long>(p.B) * p.H * nc * NM;
  if (p.groups != (p.H + K::GROUP - 1) / K::GROUP || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long g_sb = static_cast<long long>(p.S) * p.H * p.P;  // gy contiguous
  CUtensorMap tx, tgy, tb, tc, th, tdh;
  // B and C as [B, S, 1, N]; the state scratch as [1, rows, 1, 64]
  if (!sm90::tensor_map(&tx, p.x, p.B, p.S, p.H, p.P, p.x_sb, p.x_ss, p.x_sh,
                        SB_Q, 64) ||
      !sm90::tensor_map(&tgy, p.gy, p.B, p.S, p.H, p.P, g_sb,
                        static_cast<long long>(p.H) * p.P, p.P, SB_Q, 64) ||
      !sm90::tensor_map(&tb, p.bm, p.B, p.S, 1, p.N, p.b_sb, p.b_ss, p.b_ss,
                        SB_Q, 64) ||
      !sm90::tensor_map(&tc, p.cm, p.B, p.S, 1, p.N, p.c_sb, p.c_ss, p.c_ss,
                        SB_Q, 64) ||
      !sm90::tensor_map(&th, p.hs, 1, static_cast<int>(rows), 1, 64, rows * 64,
                        64, 64, 64, 64) ||
      !sm90::tensor_map(&tdh, p.dhs, 1, static_cast<int>(rows), 1, 64,
                        rows * 64, 64, 64, 64, 64))
    return cudaErrorInvalidValue;
  const int n_sm = sm90::sm_count();
  auto walk = ssd_bwd_walk_tc<NM>;
  cudaError_t err = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (err != cudaSuccess) return err;
  const int items = 2 * p.B * p.H;
  walk<<<items < n_sm ? items : n_sm, W::THREADS, W::SMEM, s>>>(tx, tgy, tb, tc, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto chunk = ssd_bwd_chunk_tc<NM>;
  err = cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::SMEM);
  if (err != cudaSuccess) return err;
  const int units = p.B * nc * p.groups;
  chunk<<<units < n_sm ? units : n_sm, K::THREADS, K::SMEM, s>>>(tx, tgy, tb, tc,
                                                                   th, tdh, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(p, s);
}

// Blocks of `kernel` resident on one SM at `smem` bytes of dynamic shared
// memory.
template <typename F>
int blocks_per_sm(F kernel, int threads, int smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace repro

using repro::SsdBwdParams;

// Head groups of the dB and dC partials (SsdBwdParams::groups) at h heads,
// state dim n and dtype code `dtype`.
extern "C" int ssd_scan_bwd_groups(int h, int n, int dtype) {
  if (dtype != 1) return h;
  const int g = repro::tc_group(n);
  return (h + g - 1) / g;
}

// Blocks an SM of the bfloat16 chunk kernel at state dim n; *smem: its
// dynamic shared memory.
extern "C" int ssd_scan_bwd_occupancy(int n, int* smem) {
  using namespace repro;
  if (n <= 64) {
    *smem = Chunk<64>::SMEM;
    return blocks_per_sm(ssd_bwd_chunk_tc<64>, Chunk<64>::THREADS, *smem);
  }
  *smem = Chunk<128>::SMEM;
  return blocks_per_sm(ssd_bwd_chunk_tc<128>, Chunk<128>::THREADS, *smem);
}

// The same for the bfloat16 walk kernel.
extern "C" int ssd_bwd_walk_occupancy(int n, int* smem) {
  using namespace repro;
  if (n <= 64) {
    *smem = Walk<64>::SMEM;
    return blocks_per_sm(ssd_bwd_walk_tc<64>, Walk<64>::THREADS, *smem);
  }
  *smem = Walk<128>::SMEM;
  return blocks_per_sm(ssd_bwd_walk_tc<128>, Walk<128>::THREADS, *smem);
}

// Launches the kernels of one call in turn on `stream`: bfloat16 the walk,
// the chunk kernel and the reduction, float32 the scan and the reduction;
// returns the first launch error.
extern "C" int ssd_scan_bwd(const SsdBwdParams* params, void* stream) {
  const SsdBwdParams& p = *params;
  if (p.B < 1 || p.B > 65535 || p.S < 1 || p.H < 1 || p.H > 65535 ||
      p.P < 1 || p.P > 64 || p.N < 1 || p.N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.dtype == 1)
    err = p.N <= 64 ? repro::launch_tc<64>(p, s) : repro::launch_tc<128>(p, s);
  else
    err = repro::launch_simt(p, s);
  return static_cast<int>(err);
}
