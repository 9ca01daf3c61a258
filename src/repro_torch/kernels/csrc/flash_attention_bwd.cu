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
// Three kernels in the shape of FlashAttention-2/3, the heavy two in two
// versions chosen by the element type, never by a failure; none has an
// atomic, so two calls give the same bits (the trainer's restore is
// bitwise):
//  * flash_bwd_delta: delta = sum_d dO * O per (row, head), one warp a
//    row, into float32 scratch the wrapper allocates.  Both kernels below
//    read it.
//
// bfloat16 -- the tensor cores, in the forward's pattern
// (flash_attention.cu, flash_attention_tc; hopper.cuh): persistent blocks
// of three warpgroups, one an SM; warpgroup 0 the producer (TMA into
// mbarrier rings, its registers given to the consumers by setmaxnreg),
// warpgroups 1 and 2 the consumers, 64 rows each.  Tiles are bf16 slabs
// (64 columns with the 128-byte swizzle where 64 divides the head dim,
// else 16 with the 32-byte one), read by 4-d tensor maps {D, H, S, B} by
// stride; rows past S or T arrive as zeros and are masked.
//  * flash_bwd_dkdv_tc: a work item is 128 keys of one KV head and
//    sequence (64 a consumer).  K and V stay resident, loaded once by TMA;
//    the producer streams the Q and dO tiles of 64 rows of every query head
//    of the group, from the diagonal on when causal, through a two-stage
//    ring, with their lse (times log2 e) and delta by ordinary loads.  Per
//    tile: S^T = K Q^T and dP^T = V dO^T by wgmma (A = K or V, B = the Q or
//    dO tile, both K-major); P^T = exp2(S^T scale log2e - lse log2e), the
//    causal and ragged masks only where a tile crosses the diagonal or an
//    end; dS^T = P^T (dP^T - delta) scale; then dV += P^T dO and dK +=
//    dS^T Q with P^T and dS^T packed to bf16 in registers as the A operand
//    and the dO or Q tile as the MN-major B operand.  dK and dV stay in
//    float32 registers across the group and every tile, in one order.
//  * flash_bwd_dq_tc: a work item is 128 query rows of one query head and
//    sequence, heaviest causal items first.  Q and dO stay resident (their
//    lse and delta in registers); K and V tiles of 64 keys stream through
//    a three-stage ring.  Per tile: S = Q K^T and dP = dO V^T, dS, then dQ
//    += dS K (dS the register A operand, K the MN-major B operand).
//
// float32 -- the exact SIMT kernels (TF32 would miss float32's tolerance):
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
//    order;
//  * flash_bwd_dq: one block per (64 query rows, query head, batch), the
//    heaviest causal blocks first.  Its Q and dO tiles stay in shared
//    memory while it walks the key blocks the rows see: S, dP and dS as
//    above, dS^T to shared memory, dQ += dS K in registers.
// Rounding: every product and sum runs in float32 (bf16 x bf16 products
// into float32 on the tensor cores); P is rounded to dO's type before dV
// and dS to q's type before dQ and dK, where the reference casts.  Each
// output is rounded to q's type once (the reference's bfloat16 path
// rounds dq after each 1024-key block; its float32 path is the same as
// this one up to the order of the sums).
#include "hopper.cuh"
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

// ------------------------------------------------- bfloat16: tensor cores

constexpr int TB_THREADS = 384;   // producer warpgroup + two consumers
constexpr int KV_BK = 128;        // keys a dK/dV item (64 a consumer)
constexpr int KV_BQ = 64;         // query rows a streamed Q/dO tile
constexpr int KV_STAGES = 2;
constexpr int DQ_BQ = 128;        // query rows a dQ item (64 a consumer)
constexpr int DQ_BK = 64;         // keys a streamed K/V tile
constexpr int DQ_STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

// bf16 columns a slab: 64 (128-byte swizzle) where they divide the head
// dim, else 16 (32-byte swizzle)
template <int DM>
__host__ __device__ constexpr int bw_slab() {
  return DM % 64 == 0 ? 64 : 16;
}

template <int DM>
constexpr int dkdv_tc_smem() {
  // K, V [128 x DM]; Q and dO stages [64 x DM]; lse and delta [64] a
  // stage; barriers; 1 KB to align the tiles to the swizzle pattern
  return 2 * KV_BK * DM * 2 + 2 * KV_STAGES * KV_BQ * DM * 2 +
         2 * KV_STAGES * KV_BQ * 4 + 8 * (2 * KV_STAGES + 2) + 1024;
}

template <int DM>
constexpr int dq_tc_smem() {
  // Q, dO [128 x DM]; K and V stages [64 x DM]; barriers; alignment
  return 2 * DQ_BQ * DM * 2 + 2 * DQ_STAGES * DQ_BK * DM * 2 +
         8 * (2 * DQ_STAGES + 2) + 1024;
}

// Pack the float32 fragment x[4c + e] (row e & 2 ? r1 : r0, column 8c + 2t
// + (e & 1)) of a 64 x 64 accumulator into the bf16 A fragments of its four
// 16-column k-steps (the forward's P packing).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a[c / 2][(c & 1) * 2 + 0] = sm90::pack_bf16(x[4 * c + 0], x[4 * c + 1]);
    a[c / 2][(c & 1) * 2 + 1] = sm90::pack_bf16(x[4 * c + 2], x[4 * c + 3]);
  }
}

// Store a consumer's float32 accumulator (rows r0, r1; columns 8c + 2t,
// + 1) as bf16 rows of a contiguous [.., D] tensor at `base` (row pitch
// `pitch` elements); rows at or past `n_rows` are skipped.
template <int DM>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long pitch,
                                           const float (&acc)[DM / 2], int r0,
                                           int r1, int n_rows, int D, int t) {
  const bool pairs = D % 2 == 0;
#pragma unroll
  for (int c = 0; c < DM / 8; ++c) {
    const int d = 8 * c + 2 * t;
    if (d >= D) continue;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rr ? r1 : r0;
      if (r >= n_rows) continue;
      __nv_bfloat16* dst = base + r * pitch + d;
      const float x0 = acc[4 * c + 2 * rr], x1 = acc[4 * c + 2 * rr + 1];
      if (pairs)
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      else {
        dst[0] = __float2bfloat16_rn(x0);
        if (d + 1 < D) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// DM: the head dim rounded up to a multiple of 16 (<= 128).
template <int DM>
__global__ void __launch_bounds__(TB_THREADS, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const BwdParams p) {
  using namespace sm90;
  constexpr int SLAB = bw_slab<DM>();
  constexpr int RB = SLAB * 2;                // bytes a slab row
  constexpr int LT = SLAB == 64 ? 1 : 3;      // descriptor layout: B128, B32
  constexpr int NS = DM / SLAB;               // slabs a row
  constexpr int KV_SLAB = KV_BK * RB;         // bytes of a K (V) slab
  constexpr int KV_TILE = NS * KV_SLAB;
  constexpr int Q_SLAB = KV_BQ * RB;          // bytes of a Q (dO) slab
  constexpr int Q_TILE = NS * Q_SLAB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + KV_TILE;
  const uint32_t sq = sv + KV_TILE;                 // Q stage s at sq + s*Q_TILE
  const uint32_t sdo = sq + KV_STAGES * Q_TILE;
  const uint32_t sl = sdo + KV_STAGES * Q_TILE;     // lse [STAGES][64] floats
  float* lse_s = reinterpret_cast<float*>(smem_raw + (sl - raw));
  float* delta_s = lse_s + KV_STAGES * KV_BQ;
  const uint32_t bar = sl + 2 * KV_STAGES * KV_BQ * 4;
  // full[s] at bar + 8s, empty[s] at bar + 8 (STAGES + s), then K/V's
  const uint32_t kv_full = bar + 16 * KV_STAGES, kv_empty = kv_full + 8;
  const int group = p.Hq / p.Hkv;
  const int nkb = (p.T + KV_BK - 1) / KV_BK;
  const int items = nkb * p.Hkv * p.B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(bar + 8 * s, 1 + 128);                  // TMA + lse/delta loads
      mbar_init(bar + 8 * (KV_STAGES + s), 256);        // every consumer
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 256);
    mbar_fence_init();
  }
  __syncthreads();

  // item w: key block kb (lightest causal last), KV head hk, sequence b
  auto item = [&](int w, int& k0, int& hk, int& b, int& q_first, int& n_q) {
    const int kb = w % nkb, hb = w / nkb;
    hk = hb % p.Hkv;
    b = hb / p.Hkv;
    k0 = kb * KV_BK;
    q_first = p.causal ? k0 : 0;
    n_q = q_first < p.S ? (p.S - q_first + KV_BQ - 1) / KV_BQ : 0;
  };

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: thread 0 issues the copies, every thread
    // loads a share of lse and delta
    reg_dealloc<24>();
    const int tid = threadIdx.x;
    int tile = 0, n = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
      int k0, hk, b, q_first, n_q;
      item(w, k0, hk, b, q_first, n_q);
      if (tid == 0) {
        mbar_wait(kv_empty, (n & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * KV_TILE);
        for (int j = 0; j < NS; ++j) {
          tma_load_4d(sk + j * KV_SLAB, &tm_k, kv_full, j * SLAB, hk, k0, b);
          tma_load_4d(sv + j * KV_SLAB, &tm_v, kv_full, j * SLAB, hk, k0, b);
        }
      }
      for (int g = 0; g < group; ++g) {
        const int h = hk * group + g;
        for (int qi = 0; qi < n_q; ++qi, ++tile) {
          const int s = tile % KV_STAGES;
          const int q0 = q_first + qi * KV_BQ;
          const uint32_t full = bar + 8 * s;
          mbar_wait(bar + 8 * (KV_STAGES + s), ((tile / KV_STAGES) & 1) ^ 1);
          if (tid == 0) {
            mbar_expect_tx(full, 2 * Q_TILE);
            for (int j = 0; j < NS; ++j) {
              tma_load_4d(sq + s * Q_TILE + j * Q_SLAB, &tm_q, full, j * SLAB,
                          h, q0, b);
              tma_load_4d(sdo + s * Q_TILE + j * Q_SLAB, &tm_do, full,
                          j * SLAB, h, q0, b);
            }
          }
          const int r = q0 + (tid & 63);
          const long long at = (static_cast<long long>(b) * p.S + r) * p.Hq + h;
          if (tid < 64)
            lse_s[s * KV_BQ + tid] = r < p.S ? p.lse[at] * LOG2E : 0.0f;
          else
            delta_s[s * KV_BQ + tid - 64] = r < p.S ? p.delta[at] : 0.0f;
          mbar_arrive(full);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each
    reg_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int t = lane & 3;
    const float sl2 = p.scale * LOG2E;
    int tile = 0, n = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
      int k0, hk, b, q_first, n_q;
      item(w, k0, hk, b, q_first, n_q);
      const int kw0 = k0 + wg * 64;                       // this warpgroup's first key
      const int j0 = kw0 + warp * 16 + (lane >> 2), j1 = j0 + 8;  // this thread's keys
      float dk[DM / 2], dv[DM / 2];
#pragma unroll
      for (int i = 0; i < DM / 2; ++i) dk[i] = dv[i] = 0.0f;
      mbar_wait(kv_full, n & 1);
      const uint32_t ka = sk + wg * 64 * RB, va = sv + wg * 64 * RB;
      for (int g = 0; g < group; ++g) {
        for (int qi = 0; qi < n_q; ++qi, ++tile) {
          const int s = tile % KV_STAGES;
          const int q0 = q_first + qi * KV_BQ;
          const uint32_t qt = sq + s * Q_TILE, dot = sdo + s * Q_TILE;
          mbar_wait(bar + 8 * s, (tile / KV_STAGES) & 1);
          float st[32], dpt[32];
          fence_regs(st);
          fence_regs(dpt);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DM / 16; ++kk) {
            const uint32_t off = (kk * 16 / SLAB) * KV_SLAB + (kk * 16 % SLAB) * 2;
            const uint32_t offq = (kk * 16 / SLAB) * Q_SLAB + (kk * 16 % SLAB) * 2;
            wgmma_ss<64>(st, slab_desc(ka + off, 16, 8 * RB, LT),
                         slab_desc(qt + offq, 16, 8 * RB, LT), kk);
          }
#pragma unroll
          for (int kk = 0; kk < DM / 16; ++kk) {
            const uint32_t off = (kk * 16 / SLAB) * KV_SLAB + (kk * 16 % SLAB) * 2;
            const uint32_t offq = (kk * 16 / SLAB) * Q_SLAB + (kk * 16 % SLAB) * 2;
            wgmma_ss<64>(dpt, slab_desc(va + off, 16, 8 * RB, LT),
                         slab_desc(dot + offq, 16, 8 * RB, LT), kk);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(st);
          fence_regs(dpt);
          // P^T and dS^T: row = key j, column = query q0 + 8c + 2t + (e & 1)
          const bool edge = q0 + KV_BQ > p.S || kw0 + 64 > p.T ||
                            (p.causal && q0 < kw0 + 63);
          const float* ls = lse_s + s * KV_BQ;
          const float* dl = delta_s + s * KV_BQ;
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * c + 2 * t + (e & 1);
              float pr = ex2(fmaf(st[4 * c + e], sl2, -ls[col]));
              if (edge) {
                const int i = q0 + col, j = (e & 2) ? j1 : j0;
                if (i >= p.S || j >= p.T || (p.causal && j > i)) pr = 0.0f;
              }
              st[4 * c + e] = pr;
              dpt[4 * c + e] = pr * (dpt[4 * c + e] - dl[col]) * p.scale;
            }
          uint32_t pa[4][4], da[4][4];
          pack_a(pa, st);
          pack_a(da, dpt);
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(da);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KV_BQ / 16; ++kk)
            wgmma_rs<DM>(dv, pa[kk], slab_desc(dot + kk * 16 * RB, Q_SLAB, 8 * RB, LT));
#pragma unroll
          for (int kk = 0; kk < KV_BQ / 16; ++kk)
            wgmma_rs<DM>(dk, da[kk], slab_desc(qt + kk * 16 * RB, Q_SLAB, 8 * RB, LT));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(da);
          mbar_arrive(bar + 8 * (KV_STAGES + s));
        }
      }
      mbar_arrive(kv_empty);  // K and V are read for good
      const long long pitch = static_cast<long long>(p.Hkv) * p.D;
      const long long base = (static_cast<long long>(b) * p.T * p.Hkv + hk) * p.D;
      store_rows<DM>(static_cast<__nv_bfloat16*>(p.dk) + base, pitch, dk, j0, j1,
                     p.T, p.D, t);
      store_rows<DM>(static_cast<__nv_bfloat16*>(p.dv) + base, pitch, dv, j0, j1,
                     p.T, p.D, t);
    }
  }
}

template <int DM>
__global__ void __launch_bounds__(TB_THREADS, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const BwdParams p) {
  using namespace sm90;
  constexpr int SLAB = bw_slab<DM>();
  constexpr int RB = SLAB * 2;
  constexpr int LT = SLAB == 64 ? 1 : 3;
  constexpr int NS = DM / SLAB;
  constexpr int Q_SLAB = DQ_BQ * RB;          // bytes of a Q (dO) slab
  constexpr int Q_TILE = NS * Q_SLAB;
  constexpr int K_SLAB = DQ_BK * RB;          // bytes of a K (V) slab
  constexpr int K_TILE = NS * K_SLAB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sdo = sq + Q_TILE;
  const uint32_t sk = sdo + Q_TILE;                 // K stage s at sk + s*K_TILE
  const uint32_t sv = sk + DQ_STAGES * K_TILE;
  const uint32_t bar = sv + DQ_STAGES * K_TILE;
  const uint32_t q_full = bar + 16 * DQ_STAGES, q_empty = q_full + 8;
  const int n_qb = (p.S + DQ_BQ - 1) / DQ_BQ;
  const int items = n_qb * p.Hq * p.B;
  const int group = p.Hq / p.Hkv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (DQ_STAGES + s), 256);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);
    mbar_fence_init();
  }
  __syncthreads();

  // item w: query block (heaviest causal first), head h, sequence b
  auto item = [&](int w, int& q0, int& h, int& b, int& n_tiles) {
    const int hb = w / n_qb;
    q0 = (n_qb - 1 - w % n_qb) * DQ_BQ;
    h = hb % p.Hq;
    b = hb / p.Hq;
    const int kv_end = p.causal ? min(p.T, q0 + DQ_BQ) : p.T;
    n_tiles = (kv_end + DQ_BK - 1) / DQ_BK;
  };

  if (threadIdx.x < 128) {
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int tile = 0, n = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        int q0, h, b, n_tiles;
        item(w, q0, h, b, n_tiles);
        const int hk = h / group;
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * Q_TILE);
        for (int j = 0; j < NS; ++j) {
          tma_load_4d(sq + j * Q_SLAB, &tm_q, q_full, j * SLAB, h, q0, b);
          tma_load_4d(sdo + j * Q_SLAB, &tm_do, q_full, j * SLAB, h, q0, b);
        }
        for (int i = 0; i < n_tiles; ++i, ++tile) {
          const int s = tile % DQ_STAGES;
          mbar_wait(bar + 8 * (DQ_STAGES + s), ((tile / DQ_STAGES) & 1) ^ 1);
          const uint32_t full = bar + 8 * s;
          mbar_expect_tx(full, 2 * K_TILE);
          for (int j = 0; j < NS; ++j) {
            tma_load_4d(sk + s * K_TILE + j * K_SLAB, &tm_k, full, j * SLAB, hk,
                        i * DQ_BK, b);
            tma_load_4d(sv + s * K_TILE + j * K_SLAB, &tm_v, full, j * SLAB, hk,
                        i * DQ_BK, b);
          }
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int t = lane & 3;
    const float sl2 = p.scale * LOG2E;
    const uint32_t qa = sq + wg * 64 * RB, doa = sdo + wg * 64 * RB;
    int tile = 0, n = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
      int q0, h, b, n_tiles;
      item(w, q0, h, b, n_tiles);
      const int row_lo = q0 + wg * 64;
      const int r0 = row_lo + warp * 16 + (lane >> 2), r1 = r0 + 8;
      const long long at0 = (static_cast<long long>(b) * p.S + r0) * p.Hq + h;
      const long long at1 = at0 + 8LL * p.Hq;
      const float l0 = r0 < p.S ? p.lse[at0] * LOG2E : 0.0f;
      const float l1 = r1 < p.S ? p.lse[at1] * LOG2E : 0.0f;
      const float e0 = r0 < p.S ? p.delta[at0] : 0.0f;
      const float e1 = r1 < p.S ? p.delta[at1] : 0.0f;
      float dq[DM / 2];
#pragma unroll
      for (int i = 0; i < DM / 2; ++i) dq[i] = 0.0f;
      mbar_wait(q_full, n & 1);
      for (int i = 0; i < n_tiles; ++i, ++tile) {
        const int s = tile % DQ_STAGES;
        const int k0 = i * DQ_BK;
        const uint32_t kt = sk + s * K_TILE, vt = sv + s * K_TILE;
        mbar_wait(bar + 8 * s, (tile / DQ_STAGES) & 1);
        float sc[32], dp[32];
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DM / 16; ++kk) {
          const uint32_t offq = (kk * 16 / SLAB) * Q_SLAB + (kk * 16 % SLAB) * 2;
          const uint32_t offk = (kk * 16 / SLAB) * K_SLAB + (kk * 16 % SLAB) * 2;
          wgmma_ss<64>(sc, slab_desc(qa + offq, 16, 8 * RB, LT),
                       slab_desc(kt + offk, 16, 8 * RB, LT), kk);
        }
#pragma unroll
        for (int kk = 0; kk < DM / 16; ++kk) {
          const uint32_t offq = (kk * 16 / SLAB) * Q_SLAB + (kk * 16 % SLAB) * 2;
          const uint32_t offk = (kk * 16 / SLAB) * K_SLAB + (kk * 16 % SLAB) * 2;
          wgmma_ss<64>(dp, slab_desc(doa + offq, 16, 8 * RB, LT),
                       slab_desc(vt + offk, 16, 8 * RB, LT), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (i == n_tiles - 1) mbar_arrive(q_empty);  // Q and dO are read for good
        const bool edge = k0 + DQ_BK > p.T || (p.causal && k0 + DQ_BK - 1 > row_lo);
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 2;
            float pr = ex2(fmaf(sc[4 * c + e], sl2, hi ? -l1 : -l0));
            if (edge) {
              const int j = k0 + 8 * c + 2 * t + (e & 1);
              if (j >= p.T || (p.causal && j > (hi ? r1 : r0))) pr = 0.0f;
            }
            dp[4 * c + e] = pr * (dp[4 * c + e] - (hi ? e1 : e0)) * p.scale;
          }
        uint32_t da[4][4];
        pack_a(da, dp);
        fence_regs(dq);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_BK / 16; ++kk)
          wgmma_rs<DM>(dq, da[kk], slab_desc(kt + kk * 16 * RB, K_SLAB, 8 * RB, LT));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
        mbar_arrive(bar + 8 * (DQ_STAGES + s));
      }
      const long long pitch = static_cast<long long>(p.Hq) * p.D;
      const long long base = (static_cast<long long>(b) * p.S * p.Hq + h) * p.D;
      store_rows<DM>(static_cast<__nv_bfloat16*>(p.dq) + base, pitch, dq, r0, r1,
                     p.S, p.D, t);
    }
  }
}

template <int DM>
cudaError_t launch_bwd_tc(const BwdParams& p, cudaStream_t s) {
  using sm90::sm_count;
  using sm90::tensor_map;
  constexpr int slab = bw_slab<DM>();
  CUtensorMap k128, v128, q64, do64, q128, do128, k64, v64;
  if (!tensor_map(&k128, p.k, p.B, p.T, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, KV_BK, slab) ||
      !tensor_map(&v128, p.v, p.B, p.T, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, KV_BK, slab) ||
      !tensor_map(&q64, p.q, p.B, p.S, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, KV_BQ, slab) ||
      !tensor_map(&do64, p.dout, p.B, p.S, p.Hq, p.D, p.dout_sb, p.dout_ss, p.dout_sh,
                  KV_BQ, slab) ||
      !tensor_map(&q128, p.q, p.B, p.S, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, DQ_BQ, slab) ||
      !tensor_map(&do128, p.dout, p.B, p.S, p.Hq, p.D, p.dout_sb, p.dout_ss, p.dout_sh,
                  DQ_BQ, slab) ||
      !tensor_map(&k64, p.k, p.B, p.T, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, DQ_BK, slab) ||
      !tensor_map(&v64, p.v, p.B, p.T, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, DQ_BK, slab))
    return cudaErrorInvalidValue;
  const int sms = sm_count();

  constexpr int kv_bytes = dkdv_tc_smem<DM>();
  auto dkdv = flash_bwd_dkdv_tc<DM>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  const long long kv_items =
      static_cast<long long>((p.T + KV_BK - 1) / KV_BK) * p.Hkv * p.B;
  dkdv<<<static_cast<int>(kv_items < sms ? kv_items : sms), TB_THREADS, kv_bytes,
         s>>>(k128, v128, q64, do64, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int q_bytes = dq_tc_smem<DM>();
  auto dq = flash_bwd_dq_tc<DM>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return err;
  const long long q_items =
      static_cast<long long>((p.S + DQ_BQ - 1) / DQ_BQ) * p.Hq * p.B;
  dq<<<static_cast<int>(q_items < sms ? q_items : sms), TB_THREADS, q_bytes, s>>>(
      q128, do128, k64, v64, p);
  return cudaGetLastError();
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

template <typename T>
cudaError_t launch_delta(const BwdParams& p, cudaStream_t s) {
  const long long rows = static_cast<long long>(p.B) * p.S * p.Hq;
  const int per_block = BW_THREADS / 32;
  flash_bwd_delta<T><<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                       BW_THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t s) {
  cudaError_t err = launch_delta<T>(p, s);
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

cudaError_t launch_bwd_f32(const BwdParams& p, cudaStream_t s) {
  switch ((p.D + 15) / 16 * 16) {
    case 16: return launch_bwd<float, 16>(p, s);
    case 32: return launch_bwd<float, 32>(p, s);
    case 48: return launch_bwd<float, 48>(p, s);
    case 64: return launch_bwd<float, 64>(p, s);
    case 80: return launch_bwd<float, 80>(p, s);
    case 96: return launch_bwd<float, 96>(p, s);
    case 112: return launch_bwd<float, 112>(p, s);
    default: return launch_bwd<float, 128>(p, s);
  }
}

cudaError_t launch_bwd_bf16(const BwdParams& p, cudaStream_t s) {
  cudaError_t err = launch_delta<__nv_bfloat16>(p, s);
  if (err != cudaSuccess) return err;
  switch ((p.D + 15) / 16 * 16) {
    case 16: return launch_bwd_tc<16>(p, s);
    case 32: return launch_bwd_tc<32>(p, s);
    case 48: return launch_bwd_tc<48>(p, s);
    case 64: return launch_bwd_tc<64>(p, s);
    case 80: return launch_bwd_tc<80>(p, s);
    case 96: return launch_bwd_tc<96>(p, s);
    case 112: return launch_bwd_tc<112>(p, s);
    default: return launch_bwd_tc<128>(p, s);
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
  if (p.dtype == 1)  // bfloat16: the tensor cores
    err = repro::launch_bwd_bf16(p, s);
  else               // float32: the exact SIMT kernels
    err = repro::launch_bwd_f32(p, s);
  return static_cast<int>(err);
}
