// GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py:79
// flash_attention_bhsd (body _fwd_kernel:28): online-softmax attention of
// q [B,S,Hq,D] over k/v [B,T,Hkv,D], kv head = h / (Hq / Hkv), causal keys
// past the query row masked, returning o [B,S,Hq,D] in q's type and
// lse [B,S,Hq] float32.  Plain version: kernels/attention/ref.py::mha_lse.
//
// Bound: operations (2*B*Hq*S*T*D multiply-adds' worth, halved when
// causal; the bytes are q, k, v and o once).  Two kernels, chosen by the
// element type, never by a failure:
//
// bfloat16 -- flash_attention_tc: the tensor cores.  Persistent blocks of
// three warpgroups, one an SM, walk the work items (128 query rows of one
// head and sequence; the query blocks of a head next to each other,
// heaviest first).  Warpgroup 0 is the producer: one thread loads each
// item's Q tile and the K/V tiles of BK keys (128 for head dims up to 80,
// else 64, so that S, P and O fit in registers) into a three-stage ring by
// TMA, each stage guarded by a "full" and an "empty" mbarrier, and the
// warpgroup gives its registers to the consumers (setmaxnreg).
// Warpgroups 1 and 2 each own 64 query rows: S = Q K^T by wgmma from
// shared memory (D/16 k-steps) into float32 registers, the online softmax
// on the accumulator fragments (a row lives in the four threads of a quad:
// max and sum by __shfl_xor 1 and 2; exp2 on the special-function unit), p
// rounded to bf16 in registers and fed back as the register A operand of
// P V by wgmma (N = D).  Tile i's Q K^T is issued together with tile i-1's
// P V, so the softmax of tile i runs while the tensor cores finish P V.
// Tiles live in shared memory as bf16 slabs (hopper.cuh): 64 columns with
// the 128-byte swizzle where 64 divides the head dim, else 16 columns with
// the 32-byte swizzle, so a head dim of 80 is five slabs with no padding.
// TMA reads the model's tensors by stride through 4-d tensor maps
// {D, H, S, B}; rows past S or T arrive as zeros.  Causal items stop at
// their last row's tile (tiles above the diagonal are never loaded) and
// only tiles that cross the diagonal or T are masked.
//
// float32 -- flash_attention_kernel: the exact SIMT path (TF32 tensor
// cores would miss float32's tolerance): one block of 256 threads per (64
// query rows, head, batch), a register tile of 4 x 4 scores a thread from
// float32 copies of the q and k tiles in shared memory (fmaf outer
// products), online softmax over 64-key tiles with the row max and sum
// shared across the 16 threads of a row, and P V from shared memory into
// 4 rows x D/16 columns a thread.
//
// Numerics follow the reference in both: the mask value is -1e30f (not
// -inf), p is rounded to v's type before P V, l is clamped at 1e-30f and
// lse = m + log(l).
#include "hopper.cuh"
#include "lm.cuh"

namespace repro {

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

// ------------------------------------------------- bfloat16: tensor cores

constexpr int TC_BQ = 128;      // query rows a block (two consumers of 64)
constexpr int TC_STAGES = 3;    // K/V ring depth
constexpr int TC_THREADS = 384; // producer warpgroup + two consumers

// bf16 columns a slab: 64 (128-byte rows, 128-byte swizzle) where they
// divide the head dim, else 16 (32-byte rows, 32-byte swizzle)
template <int DM>
__host__ __device__ constexpr int tc_slab() {
  return DM % 64 == 0 ? 64 : 16;
}

// keys a K/V tile: 128, or 64 above a head dim of 80 (registers)
template <int DM>
__host__ __device__ constexpr int tc_bk() {
  return DM <= 80 ? 128 : 64;
}

template <int DM>
constexpr int tc_smem_bytes() {
  // Q [DM/slab slabs][128 rows][2 x slab B], K and V rings alike, the
  // barriers, and 1 KB to align the tiles to the swizzle pattern
  return TC_BQ * DM * 2 + 2 * TC_STAGES * tc_bk<DM>() * DM * 2 +
         8 * (2 * TC_STAGES + 2) + 1024;
}

// The work items of a launch: (128-row query block, head, sequence), the
// query blocks of one (head, sequence) next to each other, heaviest causal
// block first, so that items in flight together share their K/V in L2.
struct TcItem {
  int q0, h, b, n_tiles;
};

__device__ __forceinline__ TcItem tc_item(const FlashParams& p, int w, int bk) {
  const int n_qb = (p.S + TC_BQ - 1) / TC_BQ;
  const int hb = w / n_qb;
  TcItem it;
  it.q0 = (n_qb - 1 - w % n_qb) * TC_BQ;
  it.h = hb % p.Hq;
  it.b = hb / p.Hq;
  const int kv_end = p.causal ? min(p.T, it.q0 + TC_BQ) : p.T;
  it.n_tiles = (kv_end + bk - 1) / bk;
  return it;
}

// DM: the head dim rounded up to a multiple of 16 (<= 128).  Columns past D
// arrive as zeros, so they add nothing to Q K^T and give output columns
// that are never written.  Persistent: each block walks the work items
// blockIdx.x, blockIdx.x + gridDim.x, ...; the K/V ring and its phases run
// on across items, and the next item's Q loads as soon as the last Q K^T
// of the current one has read its Q, so loads overlap the epilogue.
template <int DM>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const FlashParams p) {
  using namespace sm90;
  constexpr int BK = tc_bk<DM>();
  constexpr int SLAB = tc_slab<DM>();
  constexpr int RB = SLAB * 2;                // bytes a slab row
  constexpr int LT = SLAB == 64 ? 1 : 3;      // descriptor layout: B128, B32
  constexpr int NS = DM / SLAB;               // slabs a row
  constexpr int Q_SLAB = TC_BQ * RB;          // bytes of one Q slab
  constexpr int KV_SLAB = BK * RB;            // bytes of one K or V slab
  constexpr int KV_TILE = NS * KV_SLAB;       // bytes of a K (or V) tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sk = sq + TC_BQ * DM * 2;     // K stage s at sk + s*KV_TILE
  const uint32_t sv = sk + TC_STAGES * KV_TILE;
  // mbarriers, 8 bytes each: full[s] at bar + 8s, empty[s] at
  // bar + 8 (STAGES + s), then Q's full and empty
  const uint32_t bar = sv + TC_STAGES * KV_TILE;
  const uint32_t q_full = bar + 16 * TC_STAGES, q_empty = q_full + 8;
  const int items = (p.S + TC_BQ - 1) / TC_BQ * p.Hq * p.B;
  const int group = p.Hq / p.Hkv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bar + 8 * s, 1);                        // the producer
      mbar_init(bar + 8 * (TC_STAGES + s), 256);        // every consumer
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int tile = 0, n = 0;  // tiles and items of this block so far
      for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
        const TcItem it = tc_item(p, w, BK);
        const int hk = it.h / group;
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, TC_BQ * DM * 2);
        for (int j = 0; j < NS; ++j)
          tma_load_4d(sq + j * Q_SLAB, &tm_q, q_full, j * SLAB, it.h, it.q0,
                      it.b);
        for (int i = 0; i < it.n_tiles; ++i, ++tile) {
          const int s = tile % TC_STAGES;
          mbar_wait(bar + 8 * (TC_STAGES + s), ((tile / TC_STAGES) & 1) ^ 1);
          const uint32_t full = bar + 8 * s;
          mbar_expect_tx(full, 2 * KV_TILE);
          for (int j = 0; j < NS; ++j) {
            tma_load_4d(sk + s * KV_TILE + j * KV_SLAB, &tm_k, full, j * SLAB,
                        hk, i * BK, it.b);
            tma_load_4d(sv + s * KV_TILE + j * KV_SLAB, &tm_v, full, j * SLAB,
                        hk, i * BK, it.b);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each.  Tile i's Q K^T runs
    // on the tensor cores beside tile i-1's P V; the softmax of tile i
    // overlaps the latter, and O is rescaled once P V has landed.
    reg_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int t = lane & 3;
    const float sl2 = p.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
    const uint32_t q_desc_base = sq + wg * 64 * RB;

    int tile = 0, n = 0;  // tiles and items of this block so far
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++n) {
      const TcItem it = tc_item(p, w, BK);
      const int n_tiles = it.n_tiles;
      const int row_lo = it.q0 + wg * 64;               // this warpgroup's first row
      const int r0 = row_lo + warp * 16 + (lane >> 2);  // this thread's two rows
      const int r1 = r0 + 8;

      float o[DM / 2];
#pragma unroll
      for (int i = 0; i < DM / 2; ++i) o[i] = 0.0f;
      float m0 = NEG_INF, m1 = NEG_INF;  // raw row maxima (logits before scale)
      float l0 = 0.0f, l1 = 0.0f;        // this thread's share of the row sums
      uint32_t pa[BK / 16][4];           // P of a tile, bf16 A fragments

      // S = Q K^T of the item's tile i into sc (asynchronous; one group)
      auto issue_s = [&](float (&sc)[BK / 2], int i) {
        const uint32_t kt = sk + ((tile + i) % TC_STAGES) * KV_TILE;
#pragma unroll
        for (int kk = 0; kk < DM / 16; ++kk)
          wgmma_ss<BK>(sc,
                       slab_desc(q_desc_base + (kk * 16 / SLAB) * Q_SLAB +
                                     (kk * 16 % SLAB) * 2, 16, 8 * RB, LT),
                       slab_desc(kt + (kk * 16 / SLAB) * KV_SLAB +
                                     (kk * 16 % SLAB) * 2, 16, 8 * RB, LT),
                       kk);
        wgmma_commit();
      };
      // O += P V of tile i, P in `pf` (asynchronous; one group)
      auto issue_pv = [&](int i, uint32_t (&pf)[BK / 16][4]) {
        const uint32_t vt = sv + ((tile + i) % TC_STAGES) * KV_TILE;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<DM>(o, pf[kk],
                       slab_desc(vt + kk * 16 * RB, KV_SLAB, 8 * RB, LT));
        wgmma_commit();
      };
      auto wait_full = [&](int i) {
        mbar_wait(bar + 8 * ((tile + i) % TC_STAGES), ((tile + i) / TC_STAGES) & 1);
      };
      auto release = [&](int i) {  // tile i's stage may be refilled
        mbar_arrive(bar + 8 * (TC_STAGES + (tile + i) % TC_STAGES));
      };
      // The online softmax of tile i's scores: masks, new maxima, row-sum
      // shares, and P (rounded to bf16: p.astype(v.dtype)) into pn; returns
      // the factors that carry O and l over to the new maxima.
      // sc[4c + e]: row (e & 2 ? r1 : r0), key k0 + 8c + 2t + (e & 1).
      auto softmax = [&](float (&sc)[BK / 2], int i, uint32_t (&pn)[BK / 16][4],
                         float& a0, float& a1) {
        const int k0 = i * BK;
        if (k0 + BK > p.T || (p.causal && k0 + BK - 1 > row_lo)) {
#pragma unroll
          for (int c = 0; c < BK / 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = k0 + 8 * c + 2 * t + (e & 1);
              const int r = (e & 2) ? r1 : r0;
              if (j >= p.T || (p.causal && j > r)) sc[4 * c + e] = NEG_INF;
            }
        }
        // four partial maxima and sums a row: short dependency chains
        float x0[4], x1[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x0[c] = fmaxf(sc[4 * c + 0], sc[4 * c + 1]);
          x1[c] = fmaxf(sc[4 * c + 2], sc[4 * c + 3]);
        }
#pragma unroll
        for (int c = 4; c < BK / 8; ++c) {
          x0[c % 4] = fmaxf(x0[c % 4], fmaxf(sc[4 * c + 0], sc[4 * c + 1]));
          x1[c % 4] = fmaxf(x1[c % 4], fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
        }
        float mx0 = fmaxf(fmaxf(m0, fmaxf(x0[0], x0[1])), fmaxf(x0[2], x0[3]));
        float mx1 = fmaxf(fmaxf(m1, fmaxf(x1[0], x1[1])), fmaxf(x1[2], x1[3]));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        a0 = ex2((m0 - mx0) * sl2);
        a1 = ex2((m1 - mx1) * sl2);
        m0 = mx0;
        m1 = mx1;
        const float b0 = -m0 * sl2, b1 = -m1 * sl2;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
          const float p0 = ex2(fmaf(sc[4 * c + 0], sl2, b0));
          const float p1 = ex2(fmaf(sc[4 * c + 1], sl2, b0));
          const float p2 = ex2(fmaf(sc[4 * c + 2], sl2, b1));
          const float p3 = ex2(fmaf(sc[4 * c + 3], sl2, b1));
          x0[c % 4] = c < 4 ? p0 + p1 : x0[c % 4] + (p0 + p1);
          x1[c % 4] = c < 4 ? p2 + p3 : x1[c % 4] + (p2 + p3);
          // keys 16kk + 2t (c even) and 16kk + 8 + 2t (c odd) of rows r0, r1
          pn[c / 2][(c & 1) * 2 + 0] = pack_bf16(p0, p1);
          pn[c / 2][(c & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
        l0 = l0 * a0 + ((x0[0] + x0[1]) + (x0[2] + x0[3]));
        l1 = l1 * a1 + ((x1[0] + x1[1]) + (x1[2] + x1[3]));
      };
      // Tile i >= 1: S of tile i beside P V of tile i-1 (P in pc), then the
      // softmax of tile i into pn while P V runs; O is rescaled once it lands.
      auto step = [&](int i, uint32_t (&pc)[BK / 16][4],
                      uint32_t (&pn)[BK / 16][4]) {
        float sc[BK / 2];
        float a0, a1;
        wait_full(i);
        fence_regs(sc);
        fence_regs(o);
        fence_regs(pc);
        wgmma_fence();
        issue_s(sc, i);
        issue_pv(i - 1, pc);
        wgmma_wait<1>();  // S of tile i is in; P V of tile i-1 still runs
        fence_regs(sc);
        if (i == n_tiles - 1) mbar_arrive(q_empty);  // Q is read for good
        softmax(sc, i, pn, a0, a1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pc);
        release(i - 1);
#pragma unroll
        for (int c = 0; c < DM / 8; ++c) {
          o[4 * c + 0] *= a0;
          o[4 * c + 1] *= a0;
          o[4 * c + 2] *= a1;
          o[4 * c + 3] *= a1;
        }
      };
      auto last = [&](uint32_t (&pc)[BK / 16][4]) {
        fence_regs(o);
        fence_regs(pc);
        wgmma_fence();
        issue_pv(n_tiles - 1, pc);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pc);
        release(n_tiles - 1);
      };

      mbar_wait(q_full, n & 1);
      {
        float sc[BK / 2];
        float a0, a1;
        wait_full(0);
        fence_regs(sc);
        wgmma_fence();
        issue_s(sc, 0);
        wgmma_wait<0>();
        fence_regs(sc);
        if (n_tiles == 1) mbar_arrive(q_empty);
        softmax(sc, 0, pa, a0, a1);  // O is still zero: nothing to rescale
      }
      // two P buffers in turn, so P never moves between registers
      uint32_t pb[BK / 16][4];
      int i = 1;
      for (; i + 1 < n_tiles; i += 2) {
        step(i, pa, pb);
        step(i + 1, pb, pa);
      }
      if (i < n_tiles) {
        step(i, pa, pb);
        last(pb);
      } else {
        last(pa);
      }
      tile += n_tiles;

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
      const float inv0 = 1.0f / ls0, inv1 = 1.0f / ls1;  // o / l, to an ulp
      __nv_bfloat16* O =
          static_cast<__nv_bfloat16*>(p.o) + it.b * p.o_sb + it.h * p.o_sh;
      // o columns d, d+1 of rows r0, r1: one 4-byte store a pair where the
      // row pitch keeps pairs aligned, else one element at a time
      const bool pairs = p.D % 2 == 0 && p.o_ss % 2 == 0;
#pragma unroll
      for (int c = 0; c < DM / 8; ++c) {
        const int d = 8 * c + 2 * t;
        if (d >= p.D) continue;
        const float x[4] = {o[4 * c] * inv0, o[4 * c + 1] * inv0,
                            o[4 * c + 2] * inv1, o[4 * c + 3] * inv1};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = rr ? r1 : r0;
          if (r >= p.S) continue;
          __nv_bfloat16* dst = O + r * p.o_ss + d;
          if (pairs)
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(x[2 * rr], x[2 * rr + 1]);
          else {
            dst[0] = __float2bfloat16_rn(x[2 * rr]);
            if (d + 1 < p.D) dst[1] = __float2bfloat16_rn(x[2 * rr + 1]);
          }
        }
      }
      if (t == 0) {  // lse = m + log(l), m in natural units: raw max x scale
        float* L = p.lse + static_cast<long long>(it.b) * p.S * p.Hq + it.h;
        if (r0 < p.S) L[static_cast<long long>(r0) * p.Hq] = m0 * p.scale + logf(ls0);
        if (r1 < p.S) L[static_cast<long long>(r1) * p.Hq] = m1 * p.scale + logf(ls1);
      }
    }
  }
}

template <int DM>
cudaError_t launch_tc(const FlashParams& p, cudaStream_t s) {
  using sm90::sm_count;
  using sm90::tensor_map;
  CUtensorMap tq, tk, tv;
  constexpr int bk = tc_bk<DM>();
  constexpr int slab = tc_slab<DM>();
  if (!tensor_map(&tq, p.q, p.B, p.S, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, TC_BQ, slab) ||
      !tensor_map(&tk, p.k, p.B, p.T, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, bk, slab) ||
      !tensor_map(&tv, p.v, p.B, p.T, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, bk, slab))
    return cudaErrorInvalidValue;
  constexpr int bytes = tc_smem_bytes<DM>();
  auto kernel = flash_attention_tc<DM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((p.S + TC_BQ - 1) / TC_BQ) * p.Hq * p.B;
  const int grid = static_cast<int>(items < sm_count() ? items : sm_count());
  kernel<<<grid, TC_THREADS, bytes, s>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// ------------------------------------------------------ float32: SIMT

constexpr int FA_BQ = 64;        // query rows a block
constexpr int FA_BK = 64;        // keys a tile
constexpr int FA_THREADS = 256;  // 16 x 16 threads, each 4 rows x 4 keys
constexpr int FA_LD = 68;        // pitch (floats) of the 64-wide tiles

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
  if (p.dtype == 1) {  // bfloat16: tensor cores
    switch (dm) {
      case 16: err = repro::launch_tc<16>(p, s); break;
      case 32: err = repro::launch_tc<32>(p, s); break;
      case 48: err = repro::launch_tc<48>(p, s); break;
      case 64: err = repro::launch_tc<64>(p, s); break;
      case 80: err = repro::launch_tc<80>(p, s); break;
      case 96: err = repro::launch_tc<96>(p, s); break;
      case 112: err = repro::launch_tc<112>(p, s); break;
      default: err = repro::launch_tc<128>(p, s); break;
    }
  } else {  // float32: the exact SIMT kernel
    switch (dm) {
      case 16: err = repro::launch_flash<float, 16>(p, s); break;
      case 32: err = repro::launch_flash<float, 32>(p, s); break;
      case 48: err = repro::launch_flash<float, 48>(p, s); break;
      case 64: err = repro::launch_flash<float, 64>(p, s); break;
      case 80: err = repro::launch_flash<float, 80>(p, s); break;
      case 96: err = repro::launch_flash<float, 96>(p, s); break;
      case 112: err = repro::launch_flash<float, 112>(p, s); break;
      default: err = repro::launch_flash<float, 128>(p, s); break;
    }
  }
  return static_cast<int>(err);
}
