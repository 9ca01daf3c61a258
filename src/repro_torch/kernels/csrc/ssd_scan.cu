// Mamba-2 chunked SSD scan for Hopper (sm_90a) [arXiv:2405.21060].
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py:78
// ssd_pallas_bhcqp (body _ssd_kernel:26, wrapper ssd_pallas:111).  Per
// (sequence, head) the kernel walks the chunks of Q = 64 positions in
// order, carrying the state h [N, P] in float32; per chunk:
//   cum      = prefix sum of dt * a                         (within the chunk)
//   w[i][j]  = (C_i . B_j) * exp(min(cum_i - cum_j, 0)),  j <= i, else 0
//   y        = w (x dt) + (C exp(cum)) h + x d_skip
//   h        = h exp(cum_Q) + (B exp(cum_Q - cum))^T (x dt)
// and after the last chunk writes h as state [B, H, N, P] float32.  h
// starts from zeros or, warm-started, from the caller's state [B, H, P, N]
// rounded to x's type (the reference's oracle casts it so).
// Plain version: kernels/ssd/ref.py::ssd_chunked (the kernel's own order
// of rounding and summing: ref.py::ssd_scan_model).
//
// What bounds it on the H100: its bytes set the floor.  At the zamba2
// prefill (B=4, S=2048, H=80, P=64, N=64, bf16) it must move 178 MB (x and
// y dominate: B, C and dt are small) against 21.5 G operations, 53 us at
// 3.35 TB/s.  On the card the bf16 kernel runs at about three times that,
// held by its consumers' element-wise instructions (the decay, the
// fragments' scaling, the epilogue), not by the tensor cores or the loads
// (PERF.md).  Two kernels, chosen by the element type, never by a failure:
//
// bfloat16 -- ssd_scan_tc: the tensor cores.  Persistent blocks, one an SM,
// of one producer warpgroup and CONS consumer warpgroups (three at N <= 64,
// two at N <= 128: registers), each consumer owning one (sequence, head)
// at a time, so a launch of up to 396 items is one wave.  Producer warp c
// keeps consumer c's two-stage ring full: the chunk's x [64 x P], B and C
// [64 x N] tiles by TMA (the model's tensors read by stride, the 128-byte
// swizzle, rows past S and columns past P or N arriving as zeros) and its
// 64 dt values by ordinary loads (dt's position stride is H floats, below
// TMA's 16-byte box), every lane arriving on the stage's mbarrier.  A
// consumer's chunk is four wgmma products, 64-row tiles bf16 x bf16 into
// float32, in two commit groups:
//   scores = C B^T             A and B K-major from the stage;
//   y  = w (x dt)              w: the scores fragment masked, decayed and
//                              packed to bf16 in registers (the A operand);
//                              x dt written by the warpgroup in the x
//                              tile's swizzled layout (MN-major B);
//   y += (C exp(cum)) h        C by ldmatrix, scaled a row at a time in
//                              registers; h's bf16 copy in shared memory;
//   h  = h exp(cum_Q) + (B exp(cum_Q - cum))^T (x dt)
//                              B^T by ldmatrix.trans, scaled a position at
//                              a time; h is this product's accumulator,
//                              kept in registers across every chunk.
// exp(cum) and exp(cum_Q - cum) are computed once a position (64 a chunk,
// each warp a quarter of the table); the decay matrix takes one exp2 an
// element on the special-function unit.  y + x d_skip is written in bf16
// into a shared tile in the swizzled layout and leaves by one TMA store,
// issued at the next chunk's first barrier (N <= 64; at N <= 128 two
// consumers' tiles leave no room, and y is stored from registers).  The
// two y products share one float32 accumulator (the
// reference adds two float32 sums: the order differs by float32 ulps, below
// bf16's rounding of y; ref.py::ssd_scan_model checks the choice).  Two
// named barriers a chunk order the warpgroup's writes of x dt and h against
// the products that read them (each warp's share of a wgmma finishes on
// its own).
//
// float32 -- ssd_scan_kernel: the exact SIMT path (TF32 tensor cores would
// miss float32's tolerance): one block of 256 threads per (sequence, head),
// the state in float32 shared memory, the four products from float32 tiles
// in shared memory, a 4 x 4 register tile a thread (fmaf).  Its cum is the
// reference's running sum, added in order (the bfloat16 kernel's warp scan
// rounds cum otherwise, by far less than bfloat16's own rounding).
//
// Layout: x [B,S,H,P], dt [B,S,H] and B/C [B,S,N] read by stride (last
// axis contiguous); positions past S load as zeros with dt = 0 (no-op
// steps, as the reference pads), so nothing is padded in device memory.
// N <= 128 and P <= 64.  The bf16 kernel's TMA wants x, B, C and y 16-byte
// aligned with strides that are multiples of 16 bytes, so P a multiple of 8
// (the wrapper raises otherwise).  Numerics follow the reference: the decay clamp
// exp(min(cum_i - cum_j, 0)); in bfloat16, x dt, w, C exp(cum), h and
// B exp(cum_Q - cum) round to bfloat16 where the reference casts; y is
// written in x's type.
#include "hopper.cuh"
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
  const float* h0;             // warm start [B, H, P, N] float32, or null
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
  // hs [NM][LD], cum [Q]
  return 3 * NM * SSD_LD + SSD_Q * (NM + 4) + 2 * SSD_Q * SSD_LD + SSD_Q;
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

  // h from the warm start (rounded to x's type) or zeros; padding is zero
  const float* const H0 =
      p.h0 ? p.h0 + (static_cast<long long>(b) * p.H + h) * p.P * p.N : nullptr;
  for (int i = tid; i < NM * SSD_LD; i += SSD_THREADS) {
    const int n = i / SSD_LD, pp = i % SSD_LD;
    hs[i] = H0 && n < p.N && pp < p.P ? rnd<T>(H0[pp * p.N + n]) : 0.0f;
  }

  const int n_chunks = (p.S + SSD_Q - 1) / SSD_Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * SSD_Q;
    __syncthreads();  // the previous chunk is done with every tile

    // dt * a, then its within-chunk running sum, added in order by one
    // thread as the reference's cumsum adds it.  The decays exp(cum_i -
    // cum_j) rest on differences of nearby running sums, which at large
    // |cum| (thousands at the model's initial weights) carry the sums'
    // rounding: a tree scan rounds them otherwise and moved y by ~1e-4
    // relative from the reference's float32 sums (PERF.md).
    if (tid < SSD_Q) cum[tid] = c0 + tid < p.S ? DT[(c0 + tid) * p.dt_ss] * a : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int j = 0; j < SSD_Q; ++j) cum[j] = run += cum[j];
    }

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
cudaError_t launch_simt(const SsdParams& p, cudaStream_t s) {
  constexpr int bytes = ssd_smem_floats<NM>() * 4;
  auto kernel = ssd_scan_kernel<T, NM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.H, p.B), SSD_THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------- bfloat16: tensor cores

// Sizes of the tensor-core kernel at state width NM (64 or 128).
template <int NM>
struct Tc {
  static constexpr int CONS = NM == 64 ? 3 : 2;     // consumer warpgroups
  static constexpr int THREADS = 128 * (CONS + 1);
  static constexpr int PROD_REGS = NM == 64 ? 32 : 40;
  static constexpr int CONS_REGS = NM == 64 ? 160 : 232;
  static constexpr int X = SSD_Q * 128;             // x tile: 64 rows of 128 B
  static constexpr int BC = NM * 128;               // B or C: NM / 64 slabs of 8 KB
  static constexpr int STAGE = X + 2 * BC;          // x, B, C
  static constexpr int H = NM * 128;                // h in bf16: NM rows of 64 p
  // y leaves through shared memory and a TMA store where the tile fits
  // (N <= 64); at N <= 128 two consumers' tiles fill the SM without it
  static constexpr bool YS = NM == 64;
  static constexpr int TILES = 2 * STAGE + X + (YS ? X : 0) + H;  // + x dt, y
  // dt of both stages, cum, exp(cum), exp(cum_Q - cum), full[2], empty[2]
  static constexpr int SMALL = 2 * SSD_Q * 4 + 3 * SSD_Q * 4 + 4 * 8;
  static constexpr int SMEM = CONS * (TILES + SMALL) + 1024;
};

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

// h.astype(bf16) into the shared tile the next C h product reads (the
// 128-byte swizzle; NM rows of 64 columns, every byte written): this
// thread's accumulator rows r0, r0 + 8 of each 64-row slab.
template <int NM>
__device__ __forceinline__ void store_h_bf16(uint8_t* h_g,
                                             const float (&hacc)[NM / 64][32],
                                             int r0, int t) {
#pragma unroll
  for (int m = 0; m < NM / 64; ++m)
#pragma unroll
    for (int cb = 0; cb < 8; ++cb) {
      const int n0 = m * 64 + r0, n1 = n0 + 8;
      *reinterpret_cast<uint32_t*>(h_g + swz(n0, cb, t)) =
          sm90::pack_bf16(hacc[m][4 * cb + 0], hacc[m][4 * cb + 1]);
      *reinterpret_cast<uint32_t*>(h_g + swz(n1, cb, t)) =
          sm90::pack_bf16(hacc[m][4 * cb + 2], hacc[m][4 * cb + 3]);
    }
}

// WARM: h starts from p.h0 (a case of its own, so that the zero start keeps
// its registers: the warm start's loads raised the consumers' spills).
template <int NM, bool WARM>
__global__ void __launch_bounds__(Tc<NM>::THREADS, 1)
ssd_scan_tc(const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_c,
            const __grid_constant__ CUtensorMap tm_y, const SsdParams p) {
  using namespace sm90;
  using K = Tc<NM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // the same bytes, generic
  const int items = p.B * p.H;
  const int n_chunks = (p.S + SSD_Q - 1) / SSD_Q;
  const int wg = threadIdx.x / 128;

  // consumer c: tiles at base + c * TILES (stage s at + s * STAGE: x, B, C;
  // then x dt, y, h); small area at base + CONS * TILES + c * SMALL.
  auto tiles = [&](int c) { return static_cast<uint32_t>(c * K::TILES); };
  auto small = [&](int c) {
    return static_cast<uint32_t>(K::CONS * K::TILES + c * K::SMALL);
  };
  auto dt_at = [&](int c, int s) {
    return reinterpret_cast<float*>(gbase + small(c) + s * SSD_Q * 4);
  };
  auto full = [&](int c, int s) { return base + small(c) + 5 * SSD_Q * 4 + 8 * s; };
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
    int it = 0;  // chunks of consumer c so far
    for (int w = blockIdx.x + gridDim.x * c; w < items;
         w += gridDim.x * K::CONS) {
      const int b = w / p.H, h = w % p.H;
      const float* DT = p.dt + b * p.dt_sb + h;
      for (int ch = 0; ch < n_chunks; ++ch, ++it) {
        const int s = it & 1;
        mbar_wait(empty(c, s), ((it >> 1) & 1) ^ 1);
        const uint32_t st = base + tiles(c) + s * K::STAGE;
        if (lane == 0) {
          mbar_expect_tx(full(c, s), K::STAGE);
          tma_load_4d(st, &tm_x, full(c, s), 0, h, ch * SSD_Q, b);
          for (int j = 0; j < NM / 64; ++j) {
            tma_load_4d(st + K::X + j * 8192, &tm_b, full(c, s), j * 64, 0,
                        ch * SSD_Q, b);
            tma_load_4d(st + K::X + K::BC + j * 8192, &tm_c, full(c, s),
                        j * 64, 0, ch * SSD_Q, b);
          }
        }
        float* dts = dt_at(c, s);
        for (int r = lane; r < SSD_Q; r += 32) {
          const int pos = ch * SSD_Q + r;
          dts[r] = pos < p.S ? DT[static_cast<long long>(pos) * p.dt_ss] : 0.0f;
        }
        mbar_arrive(full(c, s));
      }
    }
    return;
  }

  // ---- consumer warpgroup c: one (sequence, head) at a time
  reg_alloc<K::CONS_REGS>();
  const int c = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q = lane >> 3;                       // ldmatrix: this lane's matrix
  const int r0 = warp * 16 + g, r1 = r0 + 8;     // this thread's accumulator rows
  const uint32_t xw_s = base + tiles(c) + 2 * K::STAGE, y_s = xw_s + K::X;
  const uint32_t h_s = y_s + (K::YS ? K::X : 0);
  uint8_t* const xw_g = gbase + tiles(c) + 2 * K::STAGE;
  uint8_t* const y_g = xw_g + K::X;
  uint8_t* const h_g = y_g + (K::YS ? K::X : 0);
  float* const cum_t = dt_at(c, 2);              // after the two dt stages
  float* const ec_t = cum_t + SSD_Q;             // bf16(exp(cum))
  float* const es_t = ec_t + SSD_Q;              // bf16(exp(cum_Q - cum))
  const bool pairs = p.P % 2 == 0;
  const int bar = 1 + c;
  // y tile written to y_g and not yet stored: its (b, h, chunk)
  int pend_b = 0, pend_h = 0, pend_ch = -1;

  int it = 0;
  for (int w = blockIdx.x + gridDim.x * c; w < items; w += gridDim.x * K::CONS) {
    const int b = w / p.H, h = w % p.H;
    const float a = p.a[h], dskip = p.d_skip[h];
    __nv_bfloat16* const Y =
        static_cast<__nv_bfloat16*>(p.y) + b * p.y_sb + h * p.y_sh;
    // h and its bf16 copy for the first chunk's C h (the previous item's
    // last products, which read h, are behind that chunk's closing
    // barrier): zeros, or the warm start [P, N] of this (b, h) rounded to
    // bf16, hacc[m][4 cb + 2 rr + e] holding h[n][pp], n = 64 m + (rr ? r1
    // : r0), pp = 8 cb + 2 t + e
    float hacc[NM / 64][32];
    if constexpr (WARM) {
      const float* const H0 =
          p.h0 + (static_cast<long long>(b) * p.H + h) * p.P * p.N;
#pragma unroll
      for (int m = 0; m < NM / 64; ++m)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int n = m * 64 + ((i & 2) ? r1 : r0);
          const int pp = 8 * (i >> 2) + 2 * t + (i & 1);
          hacc[m][i] = n < p.N && pp < p.P
                           ? rnd<__nv_bfloat16>(H0[pp * p.N + n]) : 0.0f;
        }
      store_h_bf16<NM>(h_g, hacc, r0, t);
    } else {
#pragma unroll
      for (int m = 0; m < NM / 64; ++m)
#pragma unroll
        for (int i = 0; i < 32; ++i) hacc[m][i] = 0.0f;
      for (int i = tid; i < K::H / 16; i += 128)
        reinterpret_cast<uint4*>(h_g)[i] = make_uint4(0u, 0u, 0u, 0u);
    }

    for (int ch = 0; ch < n_chunks; ++ch, ++it) {
      const int s = it & 1;
      const uint32_t sx = base + tiles(c) + s * K::STAGE;
      const uint32_t sb = sx + K::X, sc = sb + K::BC;
      const uint8_t* const x_g = gbase + tiles(c) + s * K::STAGE;
      const float* const dt = dt_at(c, s);
      mbar_wait(full(c, s), (it >> 1) & 1);

      // cum: every warp scans all 64 positions (lane l: l and l + 32) and
      // writes its quarter of the per-position tables
      float c_lo = dt[lane] * a, c_hi = dt[lane + 32] * a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float lo = __shfl_up_sync(0xffffffffu, c_lo, off);
        const float hi = __shfl_up_sync(0xffffffffu, c_hi, off);
        if (lane >= off) {
          c_lo += lo;
          c_hi += hi;
        }
      }
      c_hi += __shfl_sync(0xffffffffu, c_lo, 31);
      const float seg = __shfl_sync(0xffffffffu, c_hi, 31);
      if ((lane >> 4) == (warp & 1)) {
        const float cj = warp < 2 ? c_lo : c_hi;
        const int j = (warp < 2 ? 0 : 32) + lane;
        cum_t[j] = cj;
        ec_t[j] = rnd<__nv_bfloat16>(expf(cj));
        es_t[j] = rnd<__nv_bfloat16>(expf(seg - cj));
      }
      // x dt (dt.astype(x.dtype), the product rounded): 16-byte chunk v of
      // the swizzled tile lies in row v / 8, so it takes dt of that row
      for (int v = tid; v < K::X / 16; v += 128) {
        const float d = rnd<__nv_bfloat16>(dt[v >> 3]);
        uint4 u = reinterpret_cast<const uint4*>(x_g)[v];
        u.x = scale_bf16x2(u.x, d, d);
        u.y = scale_bf16x2(u.y, d, d);
        u.z = scale_bf16x2(u.z, d, d);
        u.w = scale_bf16x2(u.w, d, d);
        reinterpret_cast<uint4*>(xw_g)[v] = u;
      }
      fence_proxy_async();
      named_barrier(bar, 128);   // x dt, h, y and the tables are in
      if (K::YS && tid == 0 && pend_ch >= 0) {
        tma_store_4d(&tm_y, y_s, 0, pend_h, pend_ch * SSD_Q, pend_b);
        bulk_commit();
      }
      pend_ch = -1;

      // scores = C B^T
      float sacc[32];
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NM / 16; ++kk)
        wgmma_ss<64>(sacc,
                     slab_desc(sc + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024, 1),
                     slab_desc(sb + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024, 1),
                     kk);
      wgmma_commit();

      // while it runs: C exp(cum) (rows r0, r1; k = n) and
      // (B exp(cum_Q - cum))^T (rows = n, k = positions) as A fragments
      uint32_t cin[NM / 16][4];
      {
        const float e0 = ec_t[r0], e1 = ec_t[r1];
        const int row = warp * 16 + (q & 1) * 8 + (lane & 7);
#pragma unroll
        for (int kk = 0; kk < NM / 16; ++kk) {
          const int k = kk * 16 + (q >> 1) * 8;
          ldmatrix_x4(cin[kk], sc + (k / 64) * 8192 + swz(row, (k % 64) / 8, 0));
          cin[kk][0] = scale_bf16x2(cin[kk][0], e0, e0);
          cin[kk][1] = scale_bf16x2(cin[kk][1], e1, e1);
          cin[kk][2] = scale_bf16x2(cin[kk][2], e0, e0);
          cin[kk][3] = scale_bf16x2(cin[kk][3], e1, e1);
        }
      }
      uint32_t bw[NM / 64][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 e = *reinterpret_cast<const float2*>(&es_t[kk * 16 + 2 * t]);
        const float2 f = *reinterpret_cast<const float2*>(&es_t[kk * 16 + 8 + 2 * t]);
        const int j = kk * 16 + (q >> 1) * 8 + (lane & 7);  // stored row
#pragma unroll
        for (int m = 0; m < NM / 64; ++m) {
          const int n = m * 64 + warp * 16 + (q & 1) * 8;   // stored column
          ldmatrix_x4_trans(bw[m][kk], sb + (n / 64) * 8192 + swz(j, (n % 64) / 8, 0));
          bw[m][kk][0] = scale_bf16x2(bw[m][kk][0], e.x, e.y);
          bw[m][kk][1] = scale_bf16x2(bw[m][kk][1], e.x, e.y);
          bw[m][kk][2] = scale_bf16x2(bw[m][kk][2], f.x, f.y);
          bw[m][kk][3] = scale_bf16x2(bw[m][kk][3], f.x, f.y);
        }
      }

      wgmma_wait<0>();
      fence_regs(sacc);
      // w = where(j <= i, scores * exp(min(cum_i - cum_j, 0)), 0) in bf16,
      // exp by the special-function unit (2^-22 relative: far below bf16);
      // sacc[4 cb + e]: row (e & 2 ? r1 : r0), column 8 cb + 2 t + (e & 1)
      uint32_t wf[4][4];
      {
        const float ci0 = cum_t[r0], ci1 = cum_t[r1];
#pragma unroll
        for (int cb = 0; cb < 8; ++cb) {
          const int j = 8 * cb + 2 * t;
          const float2 cj = *reinterpret_cast<const float2*>(&cum_t[j]);
          const float v0 = j <= r0 ? sacc[4 * cb + 0] * ex2(fminf(ci0 - cj.x, 0.0f) * LOG2E) : 0.0f;
          const float v1 = j + 1 <= r0 ? sacc[4 * cb + 1] * ex2(fminf(ci0 - cj.y, 0.0f) * LOG2E) : 0.0f;
          const float v2 = j <= r1 ? sacc[4 * cb + 2] * ex2(fminf(ci1 - cj.x, 0.0f) * LOG2E) : 0.0f;
          const float v3 = j + 1 <= r1 ? sacc[4 * cb + 3] * ex2(fminf(ci1 - cj.y, 0.0f) * LOG2E) : 0.0f;
          wf[cb / 2][(cb & 1) * 2 + 0] = pack_bf16(v0, v1);
          wf[cb / 2][(cb & 1) * 2 + 1] = pack_bf16(v2, v3);
        }
      }
      const float gamma = expf(seg);
#pragma unroll
      for (int m = 0; m < NM / 64; ++m)
#pragma unroll
        for (int i = 0; i < 32; ++i) hacc[m][i] *= gamma;   // h exp(cum_Q)

      float yacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = 0.0f;
      fence_regs(yacc);
#pragma unroll
      for (int m = 0; m < NM / 64; ++m) fence_regs(hacc[m]);
      fence_regs(wf);
      fence_regs(cin);
#pragma unroll
      for (int m = 0; m < NM / 64; ++m) fence_regs(bw[m]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)          // y = w (x dt)
        wgmma_rs<64>(yacc, wf[kk], slab_desc(xw_s + kk * 2048, K::X, 1024, 1));
#pragma unroll
      for (int kk = 0; kk < NM / 16; ++kk)    // y += (C exp(cum)) h
        wgmma_rs<64>(yacc, cin[kk], slab_desc(h_s + kk * 2048, K::H, 1024, 1));
#pragma unroll
      for (int m = 0; m < NM / 64; ++m)       // h += (B exp(cum_Q - cum))^T (x dt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<64>(hacc[m], bw[m][kk], slab_desc(xw_s + kk * 2048, K::X, 1024, 1));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(yacc);
#pragma unroll
      for (int m = 0; m < NM / 64; ++m) fence_regs(hacc[m]);
      fence_regs(wf);
      fence_regs(cin);
#pragma unroll
      for (int m = 0; m < NM / 64; ++m) fence_regs(bw[m]);
      if (K::YS && tid == 0) bulk_wait_read<0>();  // y_g may be rewritten
      named_barrier(bar, 128);   // every warp's products are done with the tiles

      // y + x d_skip, in bf16; x from the stage, which is then released.
      // Into y_g in the x tile's swizzled layout (the next barrier hands it
      // to one TMA store, which drops rows past S and columns past P), or
      // straight to global memory.
#pragma unroll
      for (int cb = 0; cb < 8; ++cb) {
        const int pp = 8 * cb + 2 * t;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? r1 : r0;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(x_g + swz(i, cb, t));
          const float y0 = yacc[4 * cb + 2 * rr] + __low2float(xv) * dskip;
          const float y1 = yacc[4 * cb + 2 * rr + 1] + __high2float(xv) * dskip;
          if constexpr (K::YS) {
            *reinterpret_cast<__nv_bfloat162*>(y_g + swz(i, cb, t)) =
                __floats2bfloat162_rn(y0, y1);
            continue;
          }
          const int pos = ch * SSD_Q + i;
          if (pos >= p.S || pp >= p.P) continue;
          __nv_bfloat16* dst = Y + static_cast<long long>(pos) * p.y_ss + pp;
          if (pairs)
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
          else {
            dst[0] = __float2bfloat16_rn(y0);
            if (pp + 1 < p.P) dst[1] = __float2bfloat16_rn(y1);
          }
        }
      }
      pend_b = b;
      pend_h = h;
      pend_ch = ch;
      mbar_arrive(empty(c, s));
      // h.astype(x.dtype) for the next chunk's C h
      if (ch + 1 < n_chunks) store_h_bf16<NM>(h_g, hacc, r0, t);
    }

    // the final state [B, H, N, P] in float32
    float* const st = p.state + (static_cast<long long>(b) * p.H + h) * p.N * p.P;
#pragma unroll
    for (int m = 0; m < NM / 64; ++m)
#pragma unroll
      for (int cb = 0; cb < 8; ++cb) {
        const int pp = 8 * cb + 2 * t;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int n = m * 64 + (rr ? r1 : r0);
          if (n >= p.N || pp >= p.P) continue;
          st[n * p.P + pp] = hacc[m][4 * cb + 2 * rr];
          if (pp + 1 < p.P) st[n * p.P + pp + 1] = hacc[m][4 * cb + 2 * rr + 1];
        }
      }
  }
  if (K::YS && pend_ch >= 0) {  // the last item's last y tile
    fence_proxy_async();
    named_barrier(bar, 128);
    if (tid == 0) {
      tma_store_4d(&tm_y, y_s, 0, pend_h, pend_ch * SSD_Q, pend_b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

template <int NM>
cudaError_t launch_tc(const SsdParams& p, cudaStream_t s) {
  using K = Tc<NM>;
  CUtensorMap tx, tb, tc, ty;
  // B and C as [B, S, 1, N]: one "head" whose stride is never stepped
  if (!sm90::tensor_map(&tx, p.x, p.B, p.S, p.H, p.P, p.x_sb, p.x_ss, p.x_sh,
                        SSD_Q, 64) ||
      !sm90::tensor_map(&tb, p.bm, p.B, p.S, 1, p.N, p.b_sb, p.b_ss, p.b_ss,
                        SSD_Q, 64) ||
      !sm90::tensor_map(&tc, p.cm, p.B, p.S, 1, p.N, p.c_sb, p.c_ss, p.c_ss,
                        SSD_Q, 64) ||
      !sm90::tensor_map(&ty, p.y, p.B, p.S, p.H, p.P, p.y_sb, p.y_ss, p.y_sh,
                        SSD_Q, 64))
    return cudaErrorInvalidValue;
  auto kernel = p.h0 ? ssd_scan_tc<NM, true> : ssd_scan_tc<NM, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return err;
  const int items = p.B * p.H, n_sm = sm90::sm_count();
  const int grid = items < n_sm ? items : n_sm;   // one wave of items
  kernel<<<grid, K::THREADS, K::SMEM, s>>>(tx, tb, tc, ty, p);
  return cudaGetLastError();
}

}  // namespace repro

using repro::SsdParams;

// Dynamic shared memory of the bfloat16 kernel's block at state dim n.
extern "C" int ssd_scan_tc_smem(int n) {
  return n <= 64 ? repro::Tc<64>::SMEM : repro::Tc<128>::SMEM;
}

extern "C" int ssd_scan(const SsdParams* params, void* stream) {
  const SsdParams& p = *params;
  if (p.B < 1 || p.B > 65535 || p.S < 1 || p.H < 1 || p.P < 1 ||
      p.P > repro::SSD_PM || p.N < 1 || p.N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.dtype == 1)  // bfloat16: tensor cores
    err = p.N <= 64 ? repro::launch_tc<64>(p, s) : repro::launch_tc<128>(p, s);
  else               // float32: the exact SIMT kernel
    err = p.N <= 64 ? repro::launch_simt<float, 64>(p, s)
                    : repro::launch_simt<float, 128>(p, s);
  return static_cast<int>(err);
}
