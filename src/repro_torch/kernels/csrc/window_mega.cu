// The whole per-window control round in one launch: gate, all W service
// ticks, the lost-telemetry observation select and the policy's step.
//
// Replaces the TPU kernel src/repro/kernels/window_mega/kernel.py
// (mega_window_pallas -> kernel -> mega_round_block).  Its plain PyTorch
// version is repro_torch/kernels/window_mega/ref.py::mega_round_ref, the
// straight composition policy.gate -> fleet_window_ref -> where(telem_ok)
// -> policy.step.
//
// What bounds it on the H100: bytes.  Under adaptbf without faults a window
// reads the [W, O, J] rate block and eight [O, J] arrays (queue, volume,
// allocation, backlog caps, nodes, record, remainder, previous allocation)
// and writes seven (queue, volume, served, demand, next allocation, record,
// remainder): (W + 15) * O * J * 4 bytes, 105 MB at W=10, O=256, J=4096,
// 31 us at 3.35 TB/s.  Under the byte bound sit the two latency chains of
// the kernels it fuses: two reductions a tick, and ~25 in the allocation
// round (alloc_round.cuh), each a barrier.
//
// Design: one thread block per OST row, as in fleet_window.cu and
// adaptbf_alloc.cu, whose device code it shares (serve.cuh, alloc_round.cuh;
// the ticks are serve.cuh's megakernel tick, not B1's lean one, with which
// some of this kernel's instances ran slower: PERF.md).
// The row's serve state lives in registers across the ticks; the window's
// results are written out as soon as the ticks end, so only the observation
// the step reads stays live into it, and the step reads the rest of its
// inputs (nodes, policy state) from device memory.  Which policy runs is a
// template argument, chosen on the host from the policy's device id, so each
// case has its own register allocation and no branch on it runs in the
// kernel; a coded policy launches the case of its selected member.  The
// standing allocation is not updated in place: every output is a fresh
// buffer (the caller still reads the allocation after the round).
// Residency: the blocks are held to 64 registers a thread, two 512-thread
// blocks an SM, so all 256 rows of the main path run in one wave (264
// slots) rather than two.  To spill less at that cap, the read-only
// backlog caps sit in thread-private lanes of dynamic shared memory during
// the ticks, and the adaptbf case keeps the allocation round's live lanes
// there too (alloc_round.cuh's SmemRound, 64 KB a block, as
// adaptbf_alloc.cu does; the caps use the round's first array, which the
// round fills only after the ticks): fewer spills than with either in
// registers, and faster (ptxas and the measured times: PERF.md).
//
// Rows wider than 8192 jobs (up to 65536) run on a thread-block cluster of
// c = 2, 4 or 8 blocks a row (common.cuh: template case Row =
// RowBlock<true>): each block runs the round over its slice of the row,
// its rate, state and output rows offset by the slice, with the cluster's
// reductions and searches.  A block of 16 lanes a thread fits one an SM
// (its round's 128 KB of lanes), so the wide case drops the two-block
// register cap: held to 64 registers it spilled 1.7 KB a thread and ran
// 1.3193 ms at 256 x 16384 (PERF.md).  Rows of 33 to 8192 jobs run the
// one-block cases (Row = RowBlock<false>), unchanged.
//
// Rows of at most 32 jobs (common.cuh: WARP_J) run one warp a row,
// WARP_ROWS = 16 rows a block (RowWarp; template case Row): the ticks'
// and the round's reductions are warp butterflies and the searches
// shuffles (serve.cuh, alloc_round.cuh), with no barrier anywhere; a warp
// past the last row (or past the last of a code's listed rows) returns at
// once.  Every policy case and both FLEETS cases have a warp instance.
// window_mega_one_block launches the one-block instances at any J <= 8192,
// to time the two (PERF.md).
//
// What crosses the cluster: each block pushes its partials into every
// peer's shared memory before a cluster barrier and reads only its own
// after it; the DSMEM bytes a block writes a reduction and a search pass,
// at c = 2, 4 and 8, are given beside the code (common.cuh: reductions;
// alloc_round.cuh: the top-k search and the excess descent).
//
// A batch of F independent fleets (storage/tenants.py): F * O rows, the
// rates of row o = f * O + r at (f * rate_fleet_rows + r) * J floats (0 rows
// a fleet for one shared trace), ticks O * J apart, as in fleet_window.cu.
// Per-fleet control codes: the host launches once for each distinct code
// present, each launch's grid over that code's rows only (`rows`, the row
// of each block or cluster; null: block or cluster b is row b), with its
// member's template case,
// so no kernel branches on the policy.  A batch of fleets is a template
// case of its own (FLEETS): with one fleet and no row list the kernel is
// the single-fleet code it was, its rates at `rates + row`, because the
// fleet's rate offset (a division and a 64-bit pointer held through the
// ticks) raised the adaptbf case's spill stores from 104 to 148 bytes at
// the 64-register cap and its time by ~3% (PERF.md).
// Those launches write disjoint rows of the fresh outputs.  The member
// state of the rows a launch does not select must come out unchanged, so
// the wrapper (window_mega/ops.py) copies the member's input state into
// its state outputs before the member's launch, which then overwrites its
// own rows only; an out-of-range code runs the last member's case with its
// state outputs sent to a scratch buffer (no state advances, as the coded
// where-chain does).
//
// Numerics: as serve.cuh and alloc_round.cuh.  The policy constants (AIMD's
// ai_frac, md, sat, floor) come from the Python class as float arguments;
// each expression keeps the plain version's order, e.g. (ai_frac * cap) * p
// and (spare * weight) / den.
#include "alloc_round.cuh"
#include "serve.cuh"

namespace repro {

// Mirrors repro_torch/kernels/window_mega/ops.py::_Params field for field.
// Arrays are [O, J] unless noted; unused pointers are null.
struct MegaParams {
  const float* queue;
  const float* vol;
  const float* alloc;
  const float* held_served;   // read only under faults
  const float* held_demand;
  const float* held_alloc;
  const float* state0;        // adaptbf: record; aimd: rate
  const float* state1;        // adaptbf: remainder
  const float* state2;        // adaptbf: previous allocation
  const float* nodes;
  const float* backlog;
  const float* rates;         // [W, O, J]
  const float* cap_tick;      // [O]
  const float* cap_w;         // [O]
  const float* telem_ok;      // [O], faults only
  const float* up;            // [O], faults only
  float* queue_out;
  float* vol_out;
  float* served_out;
  float* demand_out;
  float* obs_served_out;      // faults only
  float* obs_demand_out;
  float* obs_alloc_out;
  float* alloc_out;
  float* state0_out;          // adaptbf: record; aimd: rate
  float* state1_out;          // adaptbf: remainder
  int n_ost;                  // rows in all: F * O for F fleets
  int n_jobs;
  int n_ticks;
  int policy;
  int has_faults;
  int integer_tokens;
  float u_max;
  float ai_frac;
  float md;
  float sat;
  float floor;
  const int* rows;            // [n_rows] the row of each block (cluster), or null
  int n_rows;                 // rows launched (n_ost when rows is null)
  int rows_per_fleet;         // O: rows of one fleet (n_ost for one fleet)
  int rate_fleet_rows;        // rates' fleet stride in rows of J (0: shared)
};

}  // namespace repro

namespace {

using namespace repro;

// Device ids: must equal the `device_id` attributes of the policy classes
// in repro_torch/core/policies.py.
enum PolicyId : int {
  POLICY_ADAPTBF = 0,
  POLICY_STATIC = 1,
  POLICY_NOBW = 2,
  POLICY_STATIC_WC = 3,
  POLICY_AIMD = 4,
};

constexpr float STATIC_EPS = 1e-12f;  // baselines.static_allocate
constexpr float POLICY_EPS = 1e-9f;   // policies._EPS

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Row-wide sum of this thread's nodes, with the nodes kept for the lanes.
template <int LPT, class R>
__device__ __forceinline__ float nodes_sum(const float* __restrict__ nodes_row,
                                           float (&nd)[LPT], int n_jobs,
                                           R& s) {
  double part = 0.0;
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    nd[i] = j < n_jobs ? nodes_row[j] : 0.0f;
    part += nd[i];
  }
  return block_sum(part, s);
}

// Row: RowBlock<false> (one block a row), RowBlock<true> (a cluster) or
// RowWarp<WARP_ROWS> (one warp a row at LPT 1; held to 64 registers, 1024
// threads an SM, as the one-block rows).
template <int LPT, int POLICY, bool FLEETS, class Row>
__global__ void __launch_bounds__(Row::THREADS,
                                  Row::WARP ? 1024 / Row::THREADS
                                            : (Row::CLUSTER ? 1 : 2))
window_mega_kernel(const MegaParams p) {
  if constexpr (Row::WARP) {
    if (Row::outside(p.n_rows)) return;  // a warp past the last row
  }
  __shared__ Scratch scratch;
  if constexpr (POLICY == POLICY_ADAPTBF && !Row::WARP) search_init(scratch);
  const int o = FLEETS && p.rows != nullptr ? p.rows[Row::index()]
                                            : static_cast<int>(Row::index());
  const int n_jobs = p.n_jobs;  // the row's jobs (its stride)
  Row rb(scratch, n_jobs);
  auto& s = rb.red;
  const int n = rb.n;           // this block's lanes, from lane rb.first
  const size_t row = static_cast<size_t>(o) * n_jobs + rb.first;
  const float cap_w = p.cap_w[o];
  const bool delivered = !p.has_faults || p.telem_ok[o] > 0.0f;

  // gate + serve ------------------------------------------------------
  // adaptbf, static_wc and aimd stop a rule at a zero allocation (the job
  // falls back to the unruled queue); static and nobw gate with the
  // allocation itself
  constexpr bool OPEN_ZERO = POLICY == POLICY_ADAPTBF ||
                             POLICY == POLICY_STATIC_WC ||
                             POLICY == POLICY_AIMD;
  float q[LPT], v[LPT], b[LPT], acc[LPT];
  SmemLanes<LPT, 0> bl;  // read-only; the round's lanes start after the ticks
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    const bool in = j < n;
    q[i] = in ? p.queue[row + j] : 0.0f;
    v[i] = in ? p.vol[row + j] : 0.0f;
    bl[i] = in ? p.backlog[row + j] : 0.0f;
    const float a = in ? p.alloc[row + j] : 0.0f;
    b[i] = OPEN_ZERO ? (a > 0.0f ? a : inf_f()) : a;
    acc[i] = 0.0f;
  }
  if constexpr (FLEETS) {
    // row r of fleet f: rates at (f * rate_fleet_rows + r) * J, ticks
    // O * J apart
    const int fleet = o / p.rows_per_fleet;
    serve_window<LPT, false>(
        q, v, b, bl, acc,
        p.rates + (static_cast<size_t>(fleet) * p.rate_fleet_rows + o -
                   fleet * p.rows_per_fleet) * n_jobs + rb.first,
        static_cast<size_t>(p.rows_per_fleet) * n_jobs, p.n_ticks,
        p.cap_tick[o], n, s);
  } else {
    serve_window<LPT, false>(q, v, b, bl, acc, p.rates + row,
                             static_cast<size_t>(p.n_ost) * n_jobs, p.n_ticks,
                             p.cap_tick[o], n, s);
  }

  // observe: demand = served + standing queue; a lost-telemetry row hands
  // the step the last delivered observation instead
  float os[LPT], od[LPT], oa[LPT];
#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    os[i] = od[i] = oa[i] = 0.0f;
    if (j < n) {
      const float demand = acc[i] + q[i];
      p.queue_out[row + j] = q[i];
      p.vol_out[row + j] = v[i];
      p.served_out[row + j] = acc[i];
      p.demand_out[row + j] = demand;
      if (delivered) {
        os[i] = acc[i];
        od[i] = demand;
        oa[i] = p.alloc[row + j];
      } else {
        os[i] = p.held_served[row + j];
        od[i] = p.held_demand[row + j];
        oa[i] = p.held_alloc[row + j];
      }
      if (p.has_faults) {
        p.obs_served_out[row + j] = os[i];
        p.obs_demand_out[row + j] = od[i];
        p.obs_alloc_out[row + j] = oa[i];
      }
    }
  }

  // step --------------------------------------------------------------
  float next[LPT];
  if constexpr (POLICY == POLICY_ADAPTBF) {
    // lender-side ledger reclaim: a down OST's record is pinned to zero
    const bool up = !p.has_faults || p.up[o] > 0.0f;
    adaptbf_round<LPT>(od, p.nodes + row, p.state0 + row, p.state1 + row,
                       p.state2 + row, cap_w, p.u_max, p.integer_tokens != 0,
                       n, s, [&](int i, float a, float rec, float rem) {
                         next[i] = a;
                         const int j = lane_of(i);
                         if (j < n) {
                           p.state0_out[row + j] = up ? rec : 0.0f;
                           p.state1_out[row + j] = rem;
                         }
                       });
  } else if constexpr (POLICY == POLICY_STATIC) {
    float nd[LPT];
    const float den = fmaxf(nodes_sum<LPT>(p.nodes + row, nd, n, s),
                            STATIC_EPS);
#pragma unroll
    for (int i = 0; i < LPT; ++i) next[i] = cap_w * (nd[i] / den);
  } else if constexpr (POLICY == POLICY_NOBW) {
#pragma unroll
    for (int i = 0; i < LPT; ++i) next[i] = inf_f();
  } else if constexpr (POLICY == POLICY_STATIC_WC) {
    // static shares; each window's unused share re-granted to backlogged
    // jobs by the same shares
    float share[LPT], base[LPT], weight[LPT];
    const float den = fmaxf(nodes_sum<LPT>(p.nodes + row, share, n, s),
                            STATIC_EPS);
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      share[i] = cap_w * (share[i] / den);
      base[i] = od[i] > 0.0f ? fminf(share[i], od[i]) : 0.0f;
      part += base[i];
    }
    const float spare = fmaxf(cap_w - block_sum(part, s), 0.0f);
    part = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const bool needy = od[i] > 0.0f && od[i] > share[i];
      weight[i] = needy ? share[i] : 0.0f;
      part += weight[i];
    }
    const float w_tot = fmaxf(block_sum(part, s), POLICY_EPS);
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const float extra = spare * weight[i] / w_tot;
      const float a = od[i] > 0.0f ? base[i] + extra : 0.0f;
      next[i] = p.integer_tokens ? floorf(a) : a;
    }
  } else if constexpr (POLICY == POLICY_AIMD) {
    // rules only while the row is saturated; carried rates move by
    // additive increase / multiplicative decrease
    float pr[LPT];
    const float n_tot = fmaxf(nodes_sum<LPT>(p.nodes + row, pr, n, s),
                              POLICY_EPS);
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < LPT; ++i) part += os[i];
    const float served_tot = block_sum(part, s);
    // a zeroed capacity (down OST) reads as "nothing to throttle"
    const bool congested = served_tot >= p.sat * cap_w && cap_w > 0.0f;
    const float ai = p.ai_frac * cap_w;
    const float hi = fmaxf(cap_w, p.floor);
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int j = lane_of(i);
      pr[i] = pr[i] / n_tot;
      float rate = j < n ? p.state0[row + j] : 0.0f;
      // decrease only jobs whose own rule was binding in a congested window
      const bool gated = isfinite(oa[i]) && oa[i] > 0.0f;
      const bool binding = gated && os[i] >= p.sat * oa[i];
      rate = (congested && binding) ? rate * p.md
                                    : (congested ? rate : rate + ai * pr[i]);
      rate = fminf(fmaxf(rate, p.floor), hi);
      float thr = od[i] > 0.0f ? rate : 0.0f;
      if (p.integer_tokens) thr = floorf(thr);
      next[i] = congested ? thr : inf_f();
      if (j < n) p.state0_out[row + j] = rate;
    }
  }

#pragma unroll
  for (int i = 0; i < LPT; ++i) {
    const int j = lane_of(i);
    if (j < n) p.alloc_out[row + j] = next[i];
  }
  rb.done();
}

// Dynamic shared memory a block: the allocation round's lanes (adaptbf),
// whose first array holds the backlog caps during the ticks; the caps'
// lanes alone for the other policies.
template <int LPT, int POLICY>
constexpr int smem_bytes() {
  return POLICY == POLICY_ADAPTBF ? SmemRound<LPT>::BYTES : LPT * THREADS * 4;
}

LayoutLaunches layout_launches;

// The launch of one case: its layout by row_layout, or the one-block
// layout at any J <= MAX_J when `narrow` is false.
template <int POLICY, bool FLEETS>
cudaError_t launch_case(const MegaParams& p, cudaStream_t s, bool narrow) {
  if (narrow && row_layout(p.n_jobs) == ROW_WARP)
    return layout_launches.count(ROW_WARP, launch_warp_rows<
        window_mega_kernel<1, POLICY, FLEETS, RowWarp<WARP_ROWS>>,
        smem_bytes<1, POLICY>(), WARP_ROWS>(p.n_rows, s, p));
  const int c = cluster_blocks(p.n_jobs);
  if (c > 1)
    return layout_launches.count(ROW_CLUSTER, launch_clusters<
        window_mega_kernel<MAX_LPT, POLICY, FLEETS, RowBlock<true>>,
        smem_bytes<MAX_LPT, POLICY>()>(p.n_rows, c, s, p));
  REPRO_DISPATCH_LPT(
      p.n_jobs,
      return layout_launches.count(ROW_BLOCK, launch_rows<
          window_mega_kernel<LPT, POLICY, FLEETS, RowBlock<false>>,
          smem_bytes<LPT, POLICY>()>(p.n_rows, s, p)));
  return cudaErrorInvalidValue;
}

template <int POLICY>
cudaError_t launch(const MegaParams& p, cudaStream_t s, bool narrow) {
  if (p.rows != nullptr || p.rows_per_fleet != p.n_ost)
    return launch_case<POLICY, true>(p, s, narrow);
  return launch_case<POLICY, false>(p, s, narrow);
}

int launch_round(const MegaParams& p, cudaStream_t s, bool narrow) {
  if (cluster_blocks(p.n_jobs) == 0 || p.n_ost < 1 || p.n_ticks < 0 ||
      p.n_rows < 1 || p.rows_per_fleet < 1 || p.n_ost % p.rows_per_fleet ||
      p.rate_fleet_rows < 0 || (p.rows == nullptr && p.n_rows != p.n_ost))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p.policy) {
    case POLICY_ADAPTBF: return static_cast<int>(launch<POLICY_ADAPTBF>(p, s, narrow));
    case POLICY_STATIC: return static_cast<int>(launch<POLICY_STATIC>(p, s, narrow));
    case POLICY_NOBW: return static_cast<int>(launch<POLICY_NOBW>(p, s, narrow));
    case POLICY_STATIC_WC:
      return static_cast<int>(launch<POLICY_STATIC_WC>(p, s, narrow));
    case POLICY_AIMD: return static_cast<int>(launch<POLICY_AIMD>(p, s, narrow));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One control round for every OST row (or the rows listed in p.rows); rows
// of up to MAX_ROW_J jobs (one warp a row to WARP_J, a block to MAX_J, a
// cluster past it).  Launches on `stream`, does not synchronise, allocates
// nothing; returns the launch's cudaError_t.
extern "C" int window_mega(const MegaParams* params, void* stream) {
  return launch_round(*params, static_cast<cudaStream_t>(stream), true);
}

// window_mega with rows of J <= WARP_J on the one-block instances (a block
// of THREADS a row) instead of their warp rows: what ran them before the
// warp layout, for timing the two in one process (chip_smoke.py).  The
// wrappers never call it.
extern "C" int window_mega_one_block(const MegaParams* params, void* stream) {
  return launch_round(*params, static_cast<cudaStream_t>(stream), false);
}

// The launches this library has made in row layout `layout` (ROW_WARP,
// ROW_BLOCK or ROW_CLUSTER of common.cuh; -1 for another value).
extern "C" int window_mega_layout_launches(int layout) {
  return layout_launches.get(layout);
}

// Rows a block of the warp-row instance (common.cuh: WARP_ROWS).
extern "C" int window_mega_warp_rows() { return WARP_ROWS; }

// Blocks of the adaptbf case resident on an SM at row width n_jobs (of
// WARP_ROWS warp rows each at J <= WARP_J), or past MAX_J the clusters
// resident on the card (-1 on error); its dynamic shared memory a block
// into *smem.
extern "C" int window_mega_occupancy(int n_jobs, int* smem) {
  const int c = cluster_blocks(n_jobs);
  if (c == 0) return -1;
  if (row_layout(n_jobs) == ROW_WARP) {
    *smem = smem_bytes<1, POLICY_ADAPTBF>();
    return warp_blocks_per_sm<
        window_mega_kernel<1, POLICY_ADAPTBF, false, RowWarp<WARP_ROWS>>,
        smem_bytes<1, POLICY_ADAPTBF>(), WARP_ROWS>();
  }
  if (c > 1) {
    *smem = smem_bytes<MAX_LPT, POLICY_ADAPTBF>();
    return clusters_per_card<
        window_mega_kernel<MAX_LPT, POLICY_ADAPTBF, false, RowBlock<true>>,
        smem_bytes<MAX_LPT, POLICY_ADAPTBF>()>(c);
  }
  REPRO_DISPATCH_LPT(
      n_jobs, *smem = smem_bytes<LPT, POLICY_ADAPTBF>();
      return blocks_per_sm<
          window_mega_kernel<LPT, POLICY_ADAPTBF, false, RowBlock<false>>,
          smem_bytes<LPT, POLICY_ADAPTBF>()>());
  return -1;
}
