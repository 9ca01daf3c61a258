#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each of which raises on failure (the run then exits non-zero):

1. Build the eight CUDA kernels from ``src/repro_torch/kernels/csrc``, one
   nvcc per source, in parallel, and print ptxas's registers, spills and
   shared memory and the count of tensor-core (HGMMA) instructions in the
   SASS of the flash attention forward and backward and SSD scan and SSD
   backward libraries (``cuobjdump -sass``; none in any, or in either
   bfloat16 SSD backward kernel, fails the run); for the three fleet
   kernels at J=4096 and the two bfloat16 SSD backward kernels at N=64, a
   summary of registers, spills, static and dynamic shared memory and
   resident blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
   for the three fleet kernels' instances over thread-block clusters (rows
   of 8192 < J <= 65536), the same and the clusters of 2, 4 and 8 blocks
   resident on the card (``cudaOccupancyMaxActiveClusters``); for B1's,
   B2's and B3's warp-row instances (J <= 32, one warp a row, 16 rows a
   block), the same and their blocks an SM.  An empty kernel (``launch_floor.cu``) is
   built beside them.
2. Hold each kernel against its plain PyTorch version on the card, on
   seeded fixtures at the main paths' shapes.  Fleet kernels (O=256 OSTs,
   J=4096 jobs, W=10 ticks per window): the allocation over chained
   rounds, so its remainder carry is read and checked too; the window
   megakernel for each built-in policy and for coded dispatch, over three
   chained rounds from an evolved state and one round with a fault row;
   both on rows built to stress the allocation's radix select and excess
   descent (exact ties, -0.0 beside +0.0, no active job, a zero budget
   over carried remainders, k = count - 1) at J of 1, 4093, 4095, 4096
   and 8192, the integer allocation held with ``torch.equal``; the window
   service and the allocation also at O of 1, 133 and 265 (one past a
   full wave at one and at two blocks an SM) and J=4093 (rate rows off a
   16-byte boundary), the window service at J of 1, 3 and 8192 and W of
   0 and 1, with budgets of +inf and 0 and backlog caps below the queue,
   and at capacities that phase 1 fits, that it overflows in every tick
   and with every lane ruled (the share of row-ticks that formed the
   second row sum printed, 1 and 0 in the last two).
   Warp rows: the stress rows also at J of 8 and 32, and B1 (bitwise its
   one-block instance), B2 and B3 (every policy case and coded code, a
   fault round) at J of 1, 8 and 32 over 17 and 4096 rows.  Rows over clusters: the stress rows also at J of 16385
   and 65536, and
   at J=16384 (clusters of 2), 32768 (of 4) and 65536 (of 8), O of 1 and
   one past a full wave of clusters: B1 at W of 0, 1 and 10, B2, and B3
   for each built-in policy and coded code with a fault round (the
   integer allocations equal).
   LM kernels, at the tolerances of the reference's kernel tests
   (attention float32 2e-5, bfloat16 2e-2; SSD 1e-4, 3e-2): flash
   attention causal at the prefill's shape (B=4, S=2048, 32 heads of 80)
   in both types, non-causal GQA 8/2, a ragged S=1000 at D=96, S of 1,
   63, 64, 65 and 129, S != T, and head dims 16-128; flash decode at the
   engine's shape with lengths {1, 37, 128, 128}, 8 sequences of up to
   32768 positions (2.7 GB of KV; its split grid printed and timed there),
   GQA 8/2, and lengths 0, 1, L-1, L, L+1 and T around the host plan's
   split length L; the SSD scan at the prefill's shape (80 heads of P=64,
   N=64) in both types, a ragged S=2000, S of 1, 63, 64, 65 and 129,
   N=128, P=32, 5 heads and a batch of 1; and warm-started from a seeded
   ``initial_state`` at the prefill's shape and at S of 1 and 65, in both
   types (its launch counter must move).  The attention backward (B4-bwd)
   against ``ref._bwd_impl``, dq, dk and dv: the training shape (B=4,
   S=2048, 32 heads of 80, causal), GQA 32/8, non-causal S != T, S=1000,
   D of 64 and 128, B=1, float32 (SIMT) within 1e-4 x max(1, max |g|),
   bfloat16 (tensor cores) no farther from the float32 plain gradients
   than the bfloat16 plain version (mean within 1.25x, max within 2x); two
   calls bitwise equal.  The SSD backward (B6-bwd) against autograd of
   ``ref.ssd_chunked``, every gradient: the training shape (B=4, S=2048,
   80 heads of P=64, N=64) in both types, S of 1000 and 1, a warm start,
   no ``d_skip``, gy only, gstate only, P=16 with N=128, at the same two
   rules; two calls bitwise equal.
3. Drive the main paths, each with every launch counter set to 0 just
   before it and read just after.  The fleet: a seeded 256-OST x 4096-job
   fleet (``random_fleet(0, profile="mixed")``, 20 windows of trace tiled
   to 60) under AdapTBF: ``serve_backend="fused"`` with
   ``alloc_backend="pallas"`` (one launch of each of the first two kernels
   a window), compared with the plain ``("scan", "core")`` run on the card
   (the first window, alloc and record in every window, per-OST horizon
   service); then ``serve_backend="mega"`` (one megakernel launch a
   window and nothing else), compared with the fused/pallas run the same
   way; then ``control="coded"`` with AdapTBF's code under "mega", which
   must equal the direct run bitwise.  Streaming telemetry and the online
   service on the same fleet: each of the three runs again with
   ``telemetry="streaming"`` (launch counters as above; queue_final equal
   to the trajectory run's, coded's stats equal to mega's), the
   ``streaming_*`` finalizers against the trajectory metrics of the same
   run (the tolerances of ``tests/test_streaming_telemetry.py``); 60
   ``FleetService.step`` calls equal to ``simulate_fleet`` bitwise for
   fused/pallas, mega and coded in both telemetry modes, the counters
   moving once a window; an outage of every fourth OST in windows 20-30,
   the service saved at window 25 (``build/chip_smoke_checkpoints``,
   removed after), a new service restored and run to window 60, equal to
   the uninterrupted run bitwise (checkpoint bytes, save and restore
   seconds printed); 2000 windows of streaming mega with the same peak
   device memory as 60 (within 2 MiB) and ``stats.windows`` 2000.  The LM
   serving path: zamba2-2.7b at
   full width and depth on weights from ``torch.Generator(0)``; the
   prefill step (``make_prefill_step``, bfloat16, B=4 x S=2048; 9 flash
   attention and 54 SSD launches) against the plain path on the card,
   with float32 runs of both as the yardstick (kernel vs plain within 1e-3
   x max(1, max |logit|), and each against a float64 plain run: the
   kernel path's error within 1.25x (mean) and 2x (max) the plain
   path's); then the serving
   launcher's workload through ``ServingEngine`` and
   ``AdapTBFController`` (8 requests, 16 new tokens, 4 slots, float32; 9
   flash decode launches a step), the plain path teacher-forced on the
   kernel run's inputs and compared at every step.  The tenant axis
   (``simulate_tenants``, ``tenant_phase``): 16 fleets at the fleet's full
   width sharing its trace, per-fleet codes (the default trio cycled and
   one out of range), 60 windows of streaming telemetry under
   fused/pallas and mega/pallas, each fleet bitwise its own
   ``simulate_fleet`` run, B1 and B2 once a window over all rows or B3
   once a window a distinct code, the peak device memory below 16 copies
   of the trace; 4 fleets in trajectory mode with a batched fault plan,
   bitwise the same way; and many small tenants (O=4, J=8, 20 windows, F
   of 16, 256 and 1024): F=1024 bitwise the per-fleet loop with its
   launch counts (B1, B2 and B3 on their warp-row instances, by the C
   entries' counts by row layout), windows/s batched and as a per-fleet
   loop, and the three fleet kernels' time a launch at F*O rows: through
   the wrappers, and by their C entries (the wrappers' captured launches
   replayed, their host work left out) beside their one-block instances
   at the same shapes (the layout before the warp rows; outputs bitwise
   the warp rows') and an empty kernel over the warp rows' grid.
   Sharding on ``torch.distributed`` (``shard_phase``): the fleet cell under
   ``partition="ost_shard"`` with NCCL at one rank (fused/pallas,
   trajectory) and with gloo at 2 and 4 ranks sharing ``cuda:0``
   (fused/pallas and mega in both telemetry modes, coded mega, an outage
   of every fourth OST in windows 20-30 under streaming mega), and the 16
   wide tenants under ``"fleet_shard"`` on a 2x2 grid (streaming,
   fused/pallas and mega/pallas), each rank spawned with the inputs on the
   host and every rank's gathered result bitwise the unsharded run (per
   leaf SHA-256), B1 and B2 or B3 once a window a rank on its own rows,
   each rank's peak device memory at 4 ranks within 0.4x the unsharded
   run's in every run, trajectory and tenants too (the whole result is
   gathered into host memory); windows/s per group (ranks sharing one card: not a
   scaling figure), the busy-count all_reduce's host time a window and
   the final gather's time.  The LM training path (``lm_train_path``,
   phase 3f): zamba2-2.7b at full width and depth on weights from
   ``torch.Generator(0)`` and ``TokenPipeline(32000, 2048, 4).batch(0)``;
   ``loss_fn`` forward and backward in float32, kernel path against the
   plain path (loss within 1e-4 relative) and each against a float64
   plain run (the kernel path's gradients within 1.25x the plain path's
   mean error and 2x its worst leaf's max |err| / max(1, max |g|)), and in
   bfloat16 against the float32 plain gradients, held to the bfloat16
   plain path's own error; then five
   ``make_train_step`` steps (bfloat16 compute, float32 masters, AdamW in
   place), each launching B4 18 times (9 and 9 recomputed), its
   backward 9 times, B6 108 times and B6's backward 54 times, the plain
   path launching nothing;
   every loss, parameter and moment finite; the peak device memory.  The
   MoE block and the audio and vision frontends (``frontier_phase``,
   phase 3g): each config's bytes from ``param_shapes`` and
   ``cache_shapes`` (meta tensors) printed before anything is allocated;
   B4 and B5 against their plain versions at the phase's shapes (causal
   D=128 at 16/16 and 32/8 heads, non-causal D=80 at S=1500, decode at 16
   heads of 128, both types) and timed at moonshot's; then, each at full
   width on weights from ``torch.Generator(0)``, moonshot-v1-16b-a3b (48
   layers), phi3.5-moe-42b-a6.6b (16 of its 32: 78.0 GiB at full depth),
   hubert-xlarge (48; frames at S=1500, non-causal) and pixtral-12b (40;
   1024 patches, then 1024 tokens): float32 at 4, 2, 48 and 10 layers,
   kernel path against plain path and both against a float64 plain run
   at the positions whose routing agrees in the three (the kernel path's
   error within 1.25x mean and 2x max the plain path's; kernel vs plain
   within 1e-3 x max(1, max |logit|) where the plain path's mean error
   from float64 is below that; routing flips between the float32 paths
   at most 0.1% of positions; hubert's ``loss_fn`` within 1e-4
   relative), bfloat16 at the same depths held to the bfloat16 plain
   path's mean error; then bfloat16 at the run's depth: the prefill step
   (hubert: the encoder's forward) with B4 once a layer, no call of the
   plain attention, logits finite, two MoE calls on one input bitwise
   equal, tokens/s over three calls, peak memory, argmax agreement and
   routing flips against the bfloat16 plain path; moonshot's serving
   engine in bfloat16 (the launcher's workload; B5 once a layer a step,
   every request answered with its 16 tokens, the plain path
   teacher-forced for the argmax agreement).  The fleet main path on rows
   over thread-block clusters (``wide_phase``, phase 3h): wide-16k
   (``random_fleet(0, n_ost=256, n_jobs=16384, "mixed")``, 20 windows of
   trace tiled to 60; clusters of 2): fused/pallas against plain
   scan/core, mega against fused/pallas (the main cell's comparisons and
   invariants), coded equal to direct bitwise, streaming mega's
   queue_final equal to its trajectory run's, 4 fleets of its first 64
   OSTs under mega/pallas with per-fleet codes each bitwise its own run;
   wide-64k (64 OSTs x 65536 jobs, 20 windows; clusters of 8):
   fused/pallas against plain, mega against fused/pallas; launch counters
   once a window in every run.  Sharded training (``train_shard_phase``,
   phase 3i): zamba2-2.7b at full width and 12 of its 54 layers (two
   shared-attention applications; 2-4 ranks with whole gathered weights
   fit one card), B=4 x S=2048 of ``TokenPipeline``, float32 masters, on
   (data, model) meshes of gloo ranks sharing ``cuda:0``: 1x2 and 2x1 in a
   world of 2, 2x2 in a world of 4, against the unsharded step at the same
   depth in the same phase: 1x2 bitwise after two float32 steps (per-leaf
   SHA-256), 2x1 and 2x2 the float32 loss within 1e-5 relative and the
   all-reduced gradients within 1e-4 x max(1, max |g|) a leaf of the
   unsharded step's over the same split of the batch (two microbatches,
   themselves held to a float64 pass beside the one-pass step; the grad
   norm beside the unsharded one), each rank's B4, B4-bwd, B6 and B6-bwd
   launches in every pass equal to the unsharded step's; then bfloat16
   steps: train tokens/s, peak memory a rank, collective bytes and host
   seconds a step, the roofline's compute, memory and collective terms
   (``launch/roofline.py``), and the roofline shares (model FLOPs over
   step seconds x peak) of the full-depth train (3f) and prefill (3e)
   steps.  Then the four examples (``python -m
   repro_torch.examples.<name>``), started together, each exiting 0.
4. Time each kernel and its plain version with CUDA events (and, for the
   attention kernels, ``scaled_dot_product_attention`` on the same inputs
   as the library yardstick), the fleet paths in windows per second
   (trajectory and streaming, median and spread of 5 runs),
   ``FleetService.step`` latency (p50, p99 over 60 windows; the window's
   rates on the card or handed over as numpy), the prefill in tokens per
   second on both paths and the engine in generated tokens per second;
   B1-B3 at the wide cells' fixtures beside their bounds and plain times
   (``time_wide_cell``: allocations equal to the plain versions', two
   calls bitwise equal), and windows/s of fused/pallas, mega and the plain
   path there; B1 at J=4096 (256 and 4096 rows) and at the wide cells
   beside the share of row-ticks whose tick formed its second row sum,
   counted from the plain path on the timed fixture and over the cell's
   own fleet run (``s1_sum_phase``); what a cluster
   reduction costs against a block's (B1 at 8192 lanes a block, one block
   or clusters of 2 and 8 a row);
   the attention backward beside its bound and SDPA's forward+backward
   minus its forward; the SSD backward beside its bound, its plain
   reverse scan and the float32 kernel at the same shape; train tokens per
   second (B x S over the median of the last four steps).
5. Trace one fused/pallas run and one mega run (``trace_fleet_cell``;
   device busy and idle share not measured where the profiler missed
   some of the run's launches), one streaming fused/pallas
   run, 60 telemetry folds at the main shape, one bfloat16 prefill step,
   one engine run and one bfloat16 train step (with the SSD backward
   kernels' share, its ``record_function`` range, no plain SSD backward
   range, and the bfloat16 walk, chunk and reduction kernels 54 times each
   and the SIMT scan never) with ``torch.profiler``: device busy time, idle
   share and device time by kernel (the fused/pallas run's beside the
   one from before the allocation kernel ran two blocks an SM,
   ``ONE_BLOCK_FUSED_TRACE``; the fold's device time a window beside the
   service and allocation kernels'); and at each wide cell one fused/pallas
   run and one mega run of its fleet (``trace_fleet_cell``): B1, B2 and
   B3's device time a launch inside the fleet's own windows, and the time
   a window on the host's clock, device busy time and idle share.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is a JSON object with one entry per kernel, and the two
before that the card's name and power limit and each phase's seconds.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import bisect
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
O, J, W = 256, 4096, 10           # the main path's fleet width
N_WINDOWS = 60                    # 20 trace windows, tiled three times
DEVICE = "cuda"
HBM_BYTES_S = 3.35e12             # H100 SXM device memory rate
FP32_OPS_S = 67e12                # H100 SXM float32 rate outside tensor cores
BF16_OPS_S = 989e12               # H100 SXM dense bfloat16 tensor-core rate
LM_ARCH = "zamba2-2.7b"           # the LM serving path's model, full width
PREFILL_B, PREFILL_S = 4, 2048    # the prefill step's batch
SERVE = dict(requests=8, prompt=4, max_new=16, slots=4, max_len=128)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 5   # the training path's batch
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the reference's kernel tests
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the fused/pallas run under the profiler when the allocation kernel ran
# one block an SM (device busy ms, idle share; NVIDIA H100 80GB HBM3,
# 700 W; PERF.md)
ONE_BLOCK_FUSED_TRACE = (8.23, 0.655)


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def _without_params(name: str) -> str:
    """A demangled function name without its trailing parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def ptxas_of(log: Path, marker):
    """(registers, spill store bytes, spill load bytes, static shared
    bytes) of the first kernel whose mangled name holds ``marker`` (a
    string, or a tuple of strings it holds all of) in an nvcc ``-Xptxas
    -v`` log."""
    marks = (marker,) if isinstance(marker, str) else marker
    lines = log.read_text().splitlines()
    for k, line in enumerate(lines):
        entry = re.search(r"entry function '(\w+)'", line)
        if not entry or not all(m in entry.group(1) for m in marks):
            continue
        regs = stores = loads = smem = 0
        for info in lines[k + 1:k + 6]:
            if "entry function" in info:
                break
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          info)
            if m:
                stores, loads = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", info)
            if m:
                regs = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", info)
            if m:
                smem = int(m.group(1))
        return regs, stores, loads, smem
    raise AssertionError(f"no kernel {marker} in {log}")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ------------------------------------------------------------- fixtures
# Shaped like the reference's kernel fixtures
# (tests/test_kernel_fleet_window.py::_case, tests/test_kernel_adaptbf.py::_case).


def window_case(o, j, w, seed):
    rng = np.random.default_rng(seed)
    queue = (rng.random((o, j)) * 12).astype(np.float32)
    vol_left = np.where(rng.random((o, j)) < 0.3, np.inf,
                        rng.integers(0, 200, (o, j))).astype(np.float32)
    budget = np.where(rng.random((o, j)) < 0.5, np.inf,
                      rng.integers(0, 30, (o, j))).astype(np.float32)
    rates = rng.integers(0, 3, (w, o, j)).astype(np.float32)
    backlog = rng.choice([16.0, 64.0, 256.0], (o, j)).astype(np.float32)
    cap = rng.integers(4, 40, (o,)).astype(np.float32)
    return queue, vol_left, budget, rates, backlog, cap


def alloc_case(o, j, seed, cap=1000.0):
    rng = np.random.default_rng(seed)
    demand = rng.integers(0, 3000, (o, j)).astype(np.float32)
    demand[rng.random((o, j)) < 0.3] = 0.0
    nodes = rng.integers(1, 128, (o, j)).astype(np.float32)
    record = rng.integers(-200, 200, (o, j)).astype(np.float32)
    remainder = np.zeros((o, j), np.float32)
    alloc_prev = rng.integers(0, 500, (o, j)).astype(np.float32)
    capacity = np.full((o,), cap, np.float32)
    return demand, nodes, record, remainder, alloc_prev, capacity


# ------------------------------------------------------------ measuring


def cuda_ms(fn, reps: int, groups: int = 5, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls (so the host's launch overhead overlaps the device
    work), median over ``groups`` such runs after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def window_work(o, j, w, rate_rows=None, s1_share=1.0):
    """(bytes, operations) one window's service must move and do: every
    input read once ([W, O, J] rates, four [O, J] arrays, [O] capacity),
    every output written once (three [O, J]); about 22 float operations per
    lane per tick (issue 6, phase 1 8, phase 2 4, update 4), and 2 more
    (a conversion and an add) in the share ``s1_share`` of row-ticks that
    form the second row sum (``s1_sum_share``; 1: every row-tick).
    ``rate_rows``: the rows of distinct rates (default ``o``); a batch of
    fleets sharing one trace reads its O rows once, through a stride-0
    fleet axis, however many fleets' rows it serves."""
    rate_rows = o if rate_rows is None else rate_rows
    return (4 * (w * rate_rows * j + 7 * o * j + o),
            (22 + 2 * s1_share) * w * o * j)


def alloc_work(o, j):
    """(bytes, operations) of one allocation round: five [O, J] inputs and
    [O] capacity read once, three [O, J] outputs written once.  Operations
    per lane: three largest-remainder distributions, each with 26 descent
    sums (2 each), 33 threshold counts (3 each), ceil(log2 J) tie-break
    counts (4 each) and about 30 element-wise operations, plus about 70
    for the rest of the round.  The probe counts are fixed, not data
    dependent."""
    tie = max(j - 1, 1).bit_length()
    per_lane = 3 * (26 * 2 + 33 * 3 + tie * 4 + 30) + 70
    return 4 * (8 * o * j + o), per_lane * o * j


def mega_work(o, j, w, rate_rows=None):
    """(bytes, operations) of one megakernel round under AdapTBF without
    faults: the [W, O, J] rates, eight [O, J] inputs (queue, volume,
    allocation, backlog caps, nodes, record, remainder, previous
    allocation) and two [O] capacities read once, seven [O, J] outputs
    (queue, volume, served, demand, allocation, record, remainder) written
    once; the window service's and the allocation round's operations.
    ``rate_rows`` as in ``window_work``."""
    rate_rows = o if rate_rows is None else rate_rows
    _, serve_ops = window_work(o, j, w)
    _, alloc_ops = alloc_work(o, j)
    return (4 * (w * rate_rows * j + 15 * o * j + 2 * o),
            serve_ops + alloc_ops)


def bound_ms(n_bytes, n_ops, ops_s=FP32_OPS_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


MEGA_LEAVES = ("queue", "vol_left", "served", "demand", "obs_served",
               "obs_demand", "obs_alloc")


def mega_case(torch, policy, o, j, w, seed, dev, code=None):
    """A running fleet's round inputs for ``policy``: queues, volumes,
    integer allocations with stopped rules (unruled rows under aimd),
    nonzero lend/borrow records and fractional remainders (adaptbf),
    carried rates (aimd).  Capacities of 2000-6000 RPCs a tick leave some
    rows saturated and others not.  Returns (ctx, cap_tick, backlog,
    queue, vol, alloc, held, pstate) on ``dev`` and the numpy generator
    for the rate trace."""
    from repro_torch.core.policies import (
        AdapTBFPolicy, AIMDPolicy, CodedPolicy, NoBWPolicy, PolicyContext,
        StaticPolicy)
    from repro_torch.core.state import AllocatorState
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    nodes = t(rng.integers(1, 128, (o, j)))
    cap_tick = t(rng.integers(2000, 6000, (o,)))
    ctx = PolicyContext(nodes=nodes, cap_w=cap_tick * w, control_code=code)
    alloc = np.where(rng.random((o, j)) < 0.3, 0.0,
                     rng.integers(1, 20, (o, j))).astype(np.float32)

    def state_of(member):
        if isinstance(member, AdapTBFPolicy):
            return AllocatorState(
                record=t(rng.integers(-200, 200, (o, j))),
                remainder=t(rng.random((o, j)) - 0.5),
                alloc_prev=t(rng.integers(0, 30, (o, j))))
        if isinstance(member, AIMDPolicy):
            alloc[rng.random(o) < 0.5] = np.inf
            return t(1.0 + rng.random((o, j)) * 40.0)
        return member.init_state(ctx)

    if isinstance(policy, CodedPolicy):
        pstate = tuple(state_of(m) for m in policy.members)
    else:
        pstate = state_of(policy)
    if isinstance(policy, (StaticPolicy, NoBWPolicy)):
        alloc_t = policy.init_alloc(ctx)   # their standing allocation
    else:
        alloc_t = t(alloc)
    zeros = torch.zeros((o, j), device=dev)
    queue = t(rng.random((o, j)) * 12)
    vol = t(np.where(rng.random((o, j)) < 0.3, np.inf,
                     rng.integers(0, 200, (o, j))))
    backlog = t(rng.choice([16.0, 64.0, 256.0], (o, j)))
    return (ctx, cap_tick, backlog, queue, vol, alloc_t,
            (zeros, zeros.clone(), alloc_t), pstate), rng


def check_mega_kernel(torch, mega_ops, dev, rounds=3):
    """The megakernel against its plain version for each built-in policy
    and for coded dispatch over the default members with each code: three
    chained rounds from an evolved state (each round fed the plain
    version's outputs of the one before), then a round with a fault row
    (OST 0 loses telemetry, OST 1 is down, OST 2 at half capacity).  Every
    output leaf within atol 1e-3 with equal finite masks."""
    from repro_torch.core.policies import CodedPolicy, get_policy
    from repro_torch.storage import DEFAULT_CODED_POLICIES, FLEET_CONTROL_CODES
    cases = [(name, get_policy(name), None) for name in
             ("adaptbf", "static", "nobw", "static_wc", "aimd")]
    cases += [(f"coded[{name}]", CodedPolicy(DEFAULT_CODED_POLICIES), code)
              for name, code in FLEET_CONTROL_CODES.items()]
    up = torch.ones(O, device=dev)
    up[1] = 0.0
    telem = torch.ones(O, device=dev)
    telem[0] = 0.0
    scale = torch.ones(O, device=dev)
    scale[2] = 0.5
    worst, timed = 0.0, None
    for k, (name, policy, code) in enumerate(cases):
        inputs, rng = mega_case(torch, policy, O, J, W, seed=300 + k,
                                dev=dev, code=code)
        ctx, cap_tick, backlog, queue, vol, alloc, held, pstate = inputs
        errs = {}
        for r in range(rounds + 1):
            rates = torch.as_tensor(
                rng.integers(0, 3 + 3 * (r % 2), (W, O, J)).astype(np.float32),
                device=dev)
            faults = ()
            if r == rounds:
                cap_r = cap_tick * up * scale
                args = (policy, ctx._replace(cap_w=cap_r * W), cap_r,
                        backlog, queue, vol, alloc, held, pstate,
                        rates * up[None, :, None])
                faults = (telem, up)
            else:
                args = (policy, ctx, cap_tick, backlog, queue, vol, alloc,
                        held, pstate, rates)
                if name == "adaptbf" and r == 0:
                    timed = args
            got = mega_ops.mega_window_round(*args, *faults)
            want = mega_ops.ref.mega_round_ref(*args, *faults)
            names = (list(MEGA_LEAVES)
                     + [f"state{i}" for i in range(len(mega_ops._leaves(want[7])))]
                     + ["alloc_next"])
            flat = lambda out: [*out[:7], *mega_ops._leaves(out[7]), out[8]]
            for leaf, g, w in zip(names, flat(got), flat(want), strict=True):
                if not torch.equal(g.isfinite(), w.isfinite()):
                    raise AssertionError(f"window_mega {name} round {r}: "
                                         f"{leaf} finite masks differ")
                fin = w.isfinite()
                e = float((g[fin].double() - w[fin].double()).abs().max()) \
                    if bool(fin.any()) else 0.0
                if e > 1e-3:
                    raise AssertionError(f"window_mega {name} round {r}: "
                                         f"{leaf} off by {e} > 1e-3")
                errs[leaf] = max(errs.get(leaf, 0.0), e)
            queue, vol = want[0], want[1]
            held, pstate, alloc = tuple(want[4:7]), want[7], want[8]
        worst = max(worst, max(errs.values()))
        print(f"window_mega kernel vs plain, {name}, at O={O} J={J} W={W}, "
              f"{rounds} chained rounds + 1 faulted: max |err| per leaf "
              + json.dumps(errs))
    return timed, worst


def alloc_stress_case(j, seed):
    """Six [6, J] rows built for the allocation's searches: (0) every
    remainder key tied, (1) remainders of -0.0 beside +0.0, (2) no active
    job (every key -inf, budget 0), (3) zero capacity over carried
    remainders of 3.5 (a multi-round excess), (4) J - 1 tokens over J
    equal shares (k = count - 1 among ties), (5) a random row."""
    rng = np.random.default_rng(seed)
    o = 6
    demand = rng.integers(1, 3000, (o, j)).astype(np.float32)
    nodes = np.full((o, j), 8.0, np.float32)
    record = np.zeros((o, j), np.float32)
    remainder = np.full((o, j), 0.25, np.float32)
    prev = np.full((o, j), 100.0, np.float32)
    cap = np.array([1000.0, 1000.0, 1000.0, 0.0, j - 1.0, 50000.0],
                   np.float32)
    remainder[1, ::2] = -0.0
    remainder[1, 1::2] = 0.0
    demand[2] = 0.0
    remainder[3] = 3.5
    remainder[4] = 0.0
    demand[5, rng.random(j) < 0.3] = 0.0
    nodes[5] = rng.integers(1, 128, j)
    record[5] = rng.integers(-200, 200, j)
    remainder[5] = rng.random(j) - 0.5
    prev[5] = rng.integers(0, 500, j)
    return demand, nodes, record, remainder, prev, cap


def check_alloc_stress(torch, alloc_ops, mega_ops, dev):
    """B2 and B3 (adaptbf) against their plain versions on the stress rows
    at J of 1, 8 and 32 (warp rows), 4093, 4095, 4096 and 8192 and over
    clusters at 16385 and
    65536 (ties straddling every slice edge): the integer allocation equal
    (``torch.equal``), record and remainder and every other megakernel
    leaf within atol 1e-3.  The megakernel's row 2 gets no traffic, so it
    observes no demand.  Returns the largest error."""
    from repro_torch.core.policies import PolicyContext, get_policy
    from repro_torch.core.state import AllocatorState

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    worst = 0.0
    for j in (1, 8, 32, 4093, 4095, 4096, 8192, 16385, 65536):
        host = alloc_stress_case(j, seed=j)
        args = [t(x) for x in host]
        got = alloc_ops.fleet_alloc(*args)
        want = alloc_ops.fleet_alloc_ref(*args)[:3]
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"adaptbf_alloc stress rows J={j}: "
                                 "allocations differ")
        errs = [float((g.double() - w.double()).abs().max())
                for g, w in zip(got[1:], want[1:])]
        if max(errs) > 1e-3:
            raise AssertionError(f"adaptbf_alloc stress rows J={j}: record/"
                                 f"remainder off by {errs}")
        demand, nodes, record, remainder, prev, cap = alloc_stress_case(
            j, seed=j + 1)
        rng = np.random.default_rng(j)
        queue = rng.random((6, j)) * 12
        rates = rng.integers(0, 4, (W, 6, j)).astype(np.float32)
        queue[2] = 0.0
        rates[:, 2] = 0.0
        cap_tick = t(cap / W)
        alloc = t(rng.integers(0, 20, (6, j)))
        zeros = torch.zeros((6, j), device=dev)
        margs = (get_policy("adaptbf"),
                 PolicyContext(nodes=t(nodes), cap_w=cap_tick * W), cap_tick,
                 t(rng.choice([16.0, 64.0], (6, j))), t(queue),
                 t(np.full((6, j), np.inf)), alloc, (zeros, zeros, alloc),
                 AllocatorState(t(record), t(remainder), t(prev)), t(rates))
        mgot = mega_ops.mega_window_round(*margs)
        mwant = mega_ops.ref.mega_round_ref(*margs)
        if not torch.equal(mgot[8], mwant[8]):
            raise AssertionError(f"window_mega stress rows J={j}: "
                                 "allocations differ")
        flat = lambda out: [*out[:7], *mega_ops._leaves(out[7]), out[8]]
        for g, w in zip(flat(mgot), flat(mwant), strict=True):
            if not torch.equal(g.isfinite(), w.isfinite()):
                raise AssertionError(f"window_mega stress rows J={j}: "
                                     "finite masks differ")
            fin = w.isfinite()
            e = float((g[fin].double() - w[fin].double()).abs().max()) \
                if bool(fin.any()) else 0.0
            if e > 1e-3:
                raise AssertionError(f"window_mega stress rows J={j}: off "
                                     f"by {e} > 1e-3")
            errs.append(e)
        worst = max(worst, *errs)
        print(f"adaptbf_alloc and window_mega (adaptbf) vs plain on the "
              f"search stress rows at J={j}: allocations equal, max |err| "
              f"{max(errs)} (atol 1e-3)")
    return worst


# --------------------------------------------------------------- phases


def check_window_kernel(torch, fw_ops, dev):
    host = window_case(O, J, W, seed=11)
    args = [torch.as_tensor(x, device=dev) for x in host]
    got = fw_ops.fleet_window_serve(*args)
    want = fw_ops.fleet_window_ref(*args)
    err = 0.0
    for name, g, w in zip(("queue", "vol_left", "served"), got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if not np.array_equal(np.isfinite(g), np.isfinite(w)):
            raise AssertionError(f"fleet_window: {name} finite masks differ")
        fin = np.isfinite(g)
        e = float(np.abs(g[fin].astype(np.float64) - w[fin]).max())
        if e > 1e-4:
            raise AssertionError(f"fleet_window: {name} off by {e} > 1e-4")
        err = max(err, e)
    print(f"fleet_window kernel vs plain at O={O} J={J} W={W}: "
          f"max |err| {err} (atol 1e-4)")
    return args, err


def s1_sum_share(fw_ops, args) -> float:
    """The share of a window's row-ticks whose tick forms its second row
    sum, sum(s1) (phase 1 overflows the capacity while an unruled job
    waits: ``ref.serve_tick_model``), counted by the plain model on B1's
    inputs ``args``."""
    _, formed = fw_ops.ref.fleet_window_model(*args)
    return float(formed.float().mean()) if formed.numel() else 0.0


def check_window_edges(torch, fw_ops, dev):
    """B1 against its plain version at the edges of its design: O of 1,
    133 and 265 (one past a full wave at one and at two blocks an SM), J
    of 1, 3, 4093 (not a multiple of 4: rows off a 16-byte boundary) and
    8192, W of 0 and 1, capacities large enough
    that phase 1 fits them (its scale exactly 1), capacities so small
    that phase 1 overflows them in every tick (the tick forms sum(s1) in
    every row-tick), and every lane ruled (no unruled job waits: sum(s1)
    formed in none); each with budgets of +inf (half the lanes, but where
    every lane is ruled) and 0 (every 7th) and backlog caps below the
    queue (every 5th).  atol 1e-4, equal finite masks; the share of
    row-ticks that formed sum(s1) (``s1_sum_share``) printed and held to 1
    and 0 in the two cases built for it.  Returns the largest error."""
    cases = [(1, J, W, 1, ""), (133, J, W, 1, ""), (265, J, W, 1, ""),
             (O, 1, W, 1, ""), (O, 3, W, 1, ""), (O, 4093, W, 1, ""),
             (O, 8192, W, 1, ""), (O, J, 0, 1, ""), (O, J, 1, 1, ""),
             (O, J, W, 10000, ""), (O, J, W, 0.01, "overflow"),
             (O, J, W, 1, "all ruled")]
    worst = 0.0
    for o, j, w, cap_scale, kind in cases:
        queue, vol, budget, rates, backlog, cap = window_case(
            o, j, w, seed=o + j + w)
        if kind == "all ruled":
            budget = np.where(np.isinf(budget), 7.0, budget).astype(
                np.float32)
        budget[:, ::7] = 0.0
        backlog[:, ::5] = queue[:, ::5] * 0.5
        cap = (cap * cap_scale).astype(np.float32)
        args = [torch.as_tensor(x, device=dev)
                for x in (queue, vol, budget, rates, backlog, cap)]
        share = s1_sum_share(fw_ops, args)
        want_share = {"overflow": 1.0, "all ruled": 0.0}.get(kind)
        if want_share is not None and share != want_share:
            raise AssertionError(f"fleet_window O={o} J={j} W={w} {kind}: "
                                 f"sum(s1) formed in {share} of row-ticks")
        got = fw_ops.fleet_window_serve(*args)
        want = fw_ops.fleet_window_ref(*args)
        err = 0.0
        for name, g, w_ in zip(("queue", "vol_left", "served"), got, want):
            if not torch.equal(g.isfinite(), w_.isfinite()):
                raise AssertionError(f"fleet_window O={o} J={j} W={w}: "
                                     f"{name} finite masks differ")
            fin = w_.isfinite()
            e = float((g[fin].double() - w_[fin].double()).abs().max()) \
                if bool(fin.any()) else 0.0
            if e > 1e-4:
                raise AssertionError(f"fleet_window O={o} J={j} W={w}: "
                                     f"{name} off by {e} > 1e-4")
            err = max(err, e)
        worst = max(worst, err)
        print(f"fleet_window kernel vs plain at O={o} J={j} W={w}, capacity "
              f"x{cap_scale}{', ' + kind if kind else ''} (+inf and 0 "
              f"budgets, caps below the queue): max |err| {err} (atol 1e-4); "
              f"sum(s1) formed in {share:.4f} of row-ticks")
    return worst


def check_alloc_edges(torch, alloc_ops, dev):
    """B2 against its plain version at O of 1, 133 and 265 and J of 4093
    and 4096 (one round from ``alloc_case`` with fractional remainders):
    allocations equal (``torch.equal``), record and remainder within
    atol 1e-3.  Returns the largest error."""
    worst = 0.0
    for o, j in ((1, J), (133, J), (265, J), (1, 4093), (265, 4093)):
        host = list(alloc_case(o, j, seed=o * j))
        host[3] = (np.random.default_rng(o).random((o, j)) - 0.5).astype(
            np.float32)
        args = [torch.as_tensor(x, device=dev) for x in host]
        got = alloc_ops.fleet_alloc(*args)
        want = alloc_ops.fleet_alloc_ref(*args)[:3]
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"adaptbf_alloc O={o} J={j}: allocations "
                                 "differ")
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got[1:], want[1:]))
        if err > 1e-3:
            raise AssertionError(f"adaptbf_alloc O={o} J={j}: record/"
                                 f"remainder off by {err} > 1e-3")
        worst = max(worst, err)
        print(f"adaptbf_alloc kernel vs plain at O={o} J={j}: allocations "
              f"equal, record/remainder max |err| {err} (atol 1e-3)")
    return worst


def check_alloc_kernel(torch, alloc_ops, dev, rounds=3):
    """The allocation kernel against its plain version over ``rounds``
    chained rounds.  Round 0 starts from a zero remainder; each later round
    takes fresh demand and the plain version's record, remainder and
    allocation of the round before, so the kernel also reads the nonzero
    (fractional, some negative) remainders a running fleet carries.  Every
    round holds alloc, record and remainder within atol 1e-3 (the
    reference's own kernel tolerance), integer-valued allocations and
    per-row conservation of capacity."""
    host = alloc_case(O, J, seed=97, cap=50000.0)
    args = first = [torch.as_tensor(x, device=dev) for x in host]
    rng = np.random.default_rng(98)
    err, carried = 0.0, []
    for r in range(rounds):
        got = [x.cpu().numpy() for x in alloc_ops.fleet_alloc(*args)]
        want_t = alloc_ops.fleet_alloc_ref(*args)[:3]
        want = [x.cpu().numpy() for x in want_t]
        for name, g, w in zip(("alloc", "record", "remainder"), got, want):
            e = float(np.abs(g.astype(np.float64) - w).max())
            if e > 1e-3:
                raise AssertionError(f"adaptbf_alloc round {r}: {name} off "
                                     f"by {e} > 1e-3")
            err = max(err, e)
        if not np.array_equal(got[0], np.floor(got[0])):
            raise AssertionError(f"adaptbf_alloc round {r}: allocations not "
                                 "integer-valued")
        active = args[0].cpu().numpy() > 0
        total = got[0].astype(np.float64).sum(axis=1)
        want_total = np.where(active.any(axis=1), host[5], 0.0)
        if not np.allclose(total, want_total, atol=1e-2):
            raise AssertionError(f"adaptbf_alloc round {r}: a row does not "
                                 "conserve its capacity")
        demand = rng.integers(0, 3000, (O, J)).astype(np.float32)
        demand[rng.random((O, J)) < 0.3] = 0.0
        args = [torch.as_tensor(demand, device=dev), args[1], want_t[1],
                want_t[2], want_t[0], args[5]]
        carried.append(int(args[3].ne(0).sum()))
    if not carried[0]:
        raise AssertionError("adaptbf_alloc: round 0 left no remainder to "
                             "carry, so later rounds test nothing new")
    print(f"adaptbf_alloc kernel vs plain at O={O} J={J}, {rounds} chained "
          f"rounds: max |err| {err} (alloc/record/remainder atol 1e-3), "
          f"integer-valued, rows conserve capacity; nonzero remainder "
          f"lanes carried {carried[:-1]}")
    return first, err


def check_main_path(torch, name, res, inputs, cap_w, n_windows=N_WINDOWS):
    """The invariants, in float64: finite outputs of the expected shape
    ([n_windows, O, J] of the fleet's volume); no negative queue, service
    or allocation; per-OST served <= cap_w; moved <= offered; moved <=
    volume."""
    for field in ("served", "demand", "alloc", "record"):
        x = getattr(res, field)
        if tuple(x.shape) != (n_windows, *inputs["volume"].shape):
            raise AssertionError(f"{name}: {field} has shape {tuple(x.shape)}")
        if field != "alloc" and not bool(x.isfinite().all()):
            raise AssertionError(f"{name}: non-finite {field}")
    served = res.served.double()
    if (served < 0).any() or (res.queue_final < 0).any():
        raise AssertionError(f"{name}: negative service or queue")
    if ((res.demand.double() - served) < -1e-3).any():
        raise AssertionError(f"{name}: negative standing queue")
    alloc = res.alloc.double()
    if (alloc[alloc.isfinite()] < 0).any():
        raise AssertionError(f"{name}: negative allocation")
    if (served.sum(-1) > cap_w[None, :] + 1e-3).any():
        raise AssertionError(f"{name}: an OST served past its capacity")
    moved = served.sum(0) + res.queue_final.double()
    full, rest = divmod(n_windows, inputs["trace_windows"])
    offered = (inputs["rates"].sum(0, dtype=torch.float64) * full
               + inputs["rates"][:rest * W].sum(0, dtype=torch.float64))
    if (moved > offered + 1e-2).any():
        raise AssertionError(f"{name}: served more than offered")
    vol = inputs["volume"].double()
    if (vol.isfinite() & (moved > vol + 1e-2)).any():
        raise AssertionError(f"{name}: served more than a job's volume")


def fleet_run(torch, dev, inputs, serve, alloc, control="adaptbf", code=None,
              telemetry="trajectory", n_windows=N_WINDOWS, fault_plan=None):
    """One ``simulate_fleet`` run of a fleet's inputs on the card,
    synchronised."""
    from repro_torch.storage import FleetConfig, simulate_fleet
    cfg = FleetConfig(control=control, serve_backend=serve,
                      alloc_backend=alloc, telemetry=telemetry)
    res = simulate_fleet(cfg, inputs["nodes"], inputs["rates"],
                         inputs["volume"], inputs["cap"], inputs["backlog"],
                         control_code=code, n_windows=n_windows,
                         fault_plan=fault_plan, device=dev)
    torch.cuda.synchronize()
    return res


def compare_runs(torch, label, res, base):
    """alloc and record in every window within atol 1e-3 (unruled masks
    equal), per-OST horizon service within 1e-3 relative, and which fields
    are bitwise equal; held while the closed loop has not forked (on these
    fleets it has not: the kernel paths agree bitwise)."""
    per_window = 0.0
    for f in ("alloc", "record"):
        k, p = getattr(res, f), getattr(base, f)
        if not torch.equal(k.isinf(), p.isinf()):
            raise AssertionError(f"{label}: {f} unruled masks differ")
        fin = k.isfinite()
        e = float((k[fin].double() - p[fin].double()).abs().max())
        if e > 1e-3:
            raise AssertionError(f"{label}: {f} off by {e} in some window")
        per_window = max(per_window, e)
    k_tot = res.served.double().sum((0, 2))
    p_tot = base.served.double().sum((0, 2))
    rel = float(((k_tot - p_tot).abs() / p_tot.clamp_min(1.0)).max())
    if rel > 1e-3:
        raise AssertionError(f"{label}: horizon served per OST off by "
                             f"{rel} relative")
    same = {f: bool(torch.equal(getattr(res, f), getattr(base, f)))
            for f in ("served", "demand", "alloc", "record", "queue_final")}
    return per_window, rel, same


def first_window_err(res, base):
    """The largest difference of served, demand and record in window 0."""
    return max(float((getattr(res, f)[0].double()
                      - getattr(base, f)[0].double()).abs()
                     .nan_to_num(0.0).max())
               for f in ("served", "demand", "record"))


def trace(torch, label, run, what=f"{N_WINDOWS} windows", top=8, focus=(),
          ranges=()):
    """One run under ``torch.profiler``: device busy time, idle share and
    device time by kernel (the ``top`` longest, and each kernel whose name
    holds a string of ``focus``: its launches and device time a launch),
    printed; each ``record_function`` range named in ``ranges``: its span
    on the device timeline and the device time of the kernels that start
    inside that span.  Returns (device busy ms, idle share, {focus or
    range: (launches or calls, device ms)}), or None when the profiler saw
    no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): a CPU op's row repeats
    # the device time of the kernels it launched
    # (a range's own device-side row, its span, is not a kernel)
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in ranges]
    device_us = {e.key: e.self_device_time_total for e in device}
    busy = sum(device_us.values()) / 1e6
    if busy == 0:
        print(f"trace ({label}): the profiler recorded no device time "
              "(not measured)")
        return None
    longest = sorted(device_us.items(), key=lambda kv: -kv[1])[:top]
    print(f"trace ({label}, {what}, {wall * 1e3:.1f} ms wall "
          f"under the profiler): {sum(e.count for e in device)} device "
          f"operations, device busy {busy * 1e3:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}; device time by kernel: "
          + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in longest))
    per_focus = {}
    for name in focus:
        hits = [e for e in device if name in e.key]
        count = sum(e.count for e in hits)
        total = sum(e.self_device_time_total for e in hits)
        per_focus[name] = (count, total / 1e3)
        print(f"trace ({label}): {name}: {count} launches, "
              f"{total / 1e3:.3f} ms device time, "
              f"{total / max(count, 1):.2f} us a launch")
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for name in ranges:
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events if e.name == name)
        starts = [a for a, _ in spans]
        inside = 0.0
        for e in events:
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if e.name not in ranges and i >= 0 and \
                    e.time_range.start < spans[i][1]:
                inside += e.time_range.elapsed_us()
        span = sum(b - a for a, b in spans)
        per_focus[name] = (len(spans), inside / 1e3)
        print(f"trace ({label}): range {name}: {len(spans)} calls spanning "
              f"{span / 1e3:.3f} ms of the device timeline; the kernels "
              f"inside them {inside / 1e3:.3f} ms of device time, "
              f"{inside / 1e6 / busy:.3f} of device busy")
    return busy * 1e3, 1 - busy / wall, per_focus

# -------------------------------------- streaming telemetry, the service


FIELDS = ("served", "demand", "alloc", "record")


def trajectory_metrics(res, nodes, cap_w):
    """The trajectory metrics of a fleet run (host-side numpy)."""
    from repro_torch.storage import metrics
    served = res.served.cpu().numpy()
    demand = res.demand.cpu().numpy()
    return {"aggregate_mb": metrics.aggregate_mb(served),
            "mean_utilization": metrics.mean_utilization(served, cap_w),
            "fairness": metrics.fairness(served.sum(1, dtype=np.float64),
                                         nodes,
                                         demand.sum(1, dtype=np.float64)),
            "job_slowdown": metrics.job_slowdown(served, cap_w),
            "p99_queue": metrics.p99_queue(demand, served)}


def check_streaming_metrics(label, stats, want, nodes, cap_w):
    """The ``streaming_*`` finalizers against the trajectory metrics of the
    same run, at the tolerances of ``tests/test_streaming_telemetry.py``;
    returns the largest relative difference of the first four."""
    from repro_torch.storage import metrics
    got = {"aggregate_mb": metrics.streaming_aggregate_mb(stats),
           "mean_utilization": metrics.streaming_mean_utilization(stats),
           "fairness": metrics.streaming_fairness(stats, nodes),
           "job_slowdown": metrics.streaming_job_slowdown(stats, cap_w),
           "p99_queue": metrics.streaming_p99_queue(stats)}
    worst = 0.0
    for name in ("aggregate_mb", "mean_utilization", "fairness",
                 "job_slowdown"):
        g, w = np.asarray(got[name], np.float64), np.asarray(want[name])
        np.testing.assert_allclose(
            g, w, rtol=1e-5, atol=1e-7 if name == "fairness" else 0,
            equal_nan=True, err_msg=f"{label}: {name}")
        fin = np.isfinite(w) & (w != 0)
        if fin.any():
            worst = max(worst, float(np.max(np.abs(g[fin] - w[fin])
                                            / np.abs(w[fin]))))
    exact, approx = want["p99_queue"], got["p99_queue"]
    if not exact * 0.77 - 0.05 <= approx <= exact * 1.3 + 0.05:
        raise AssertionError(f"{label}: streaming p99 {approx} vs {exact}")
    print(f"streaming vs trajectory ({label}): aggregate "
          f"{got['aggregate_mb']:.1f} MB, utilization "
          f"{got['mean_utilization']:.6f}, fairness {got['fairness']:.6f}, "
          f"p99 backlog {approx:.3f} (histogram) vs {exact:.3f}; max rel "
          f"diff {worst:.3g} (rtol 1e-5)")
    return worst


def same_stats(torch, a, b) -> bool:
    """Every ``StreamStats`` leaf equal, dtype included."""
    from repro_torch.pytree import leaves_with_paths
    return all(x.dtype == y.dtype and bool(torch.equal(x, y))
               for (_, x), (_, y) in zip(leaves_with_paths(a),
                                         leaves_with_paths(b)))


def fleet_online(torch, dev, inputs, scn, run, counted, zero_counts, counts,
                 offline):
    """Streaming telemetry and ``FleetService`` at the main fleet shape:
    streaming equals trajectory (finalizers against metrics), online equals
    offline for fused/pallas, mega and coded in both telemetry modes with
    the launch counters moving once a window, a save inside an outage
    restored into a new service, the 2000-window horizon's peak memory,
    and the service's step latency.  Returns what phase 4 prints."""
    import shutil
    from repro_torch.storage import (FLEET_CONTROL_CODES, FleetConfig,
                                     FleetService, faults)
    nodes_np, cap_w_np = scn.nodes, scn.capacity_per_tick * W
    trace_windows = inputs["trace_windows"]
    code = FLEET_CONTROL_CODES["adaptbf"]
    configs = {"fused/pallas": ("fused", "pallas", "adaptbf", None),
               "mega": ("mega", "core", "adaptbf", None),
               "coded": ("mega", "core", "coded", code)}
    kernel_of = {"fused": {"fleet_window": N_WINDOWS,
                           "adaptbf_alloc": N_WINDOWS},
                 "mega": {"window_mega": N_WINDOWS}}
    out = {"rel": 0.0}

    # streaming equals trajectory, on the card
    streamed = {}
    for label, (serve, alloc, control, c) in configs.items():
        res, _ = counted(f"{label}, streaming", kernel_of[serve], serve,
                         alloc, control, c, telemetry="streaming")
        if not torch.equal(res.queue_final, offline[label].queue_final):
            raise AssertionError(f"{label}: streaming queue_final differs "
                                 "from the trajectory run's")
        if int(res.stats.windows) != N_WINDOWS:
            raise AssertionError(f"{label}: stats.windows "
                                 f"{int(res.stats.windows)}")
        streamed[label] = res
    for label in ("fused/pallas", "mega"):
        want = trajectory_metrics(offline[label], nodes_np, cap_w_np)
        out["rel"] = max(out["rel"], check_streaming_metrics(
            label, streamed[label].stats, want, nodes_np, cap_w_np))
    if not same_stats(torch, streamed["coded"].stats,
                      streamed["mega"].stats):
        raise AssertionError("coded streaming stats differ from direct")

    # online equals offline, bitwise, both telemetry modes
    def service(label, telemetry, **kw):
        serve, alloc, control, c = configs[label]
        cfg = FleetConfig(control=control, serve_backend=serve,
                          alloc_backend=alloc, telemetry=telemetry)
        return FleetService(cfg, inputs["nodes"], inputs["volume"],
                            inputs["cap"], inputs["backlog"],
                            control_code=c, device=dev, **kw)

    def window(w):
        s = (w % trace_windows) * W
        return inputs["rates"][s:s + W]

    for label in configs:
        for telemetry in ("trajectory", "streaming"):
            serve = configs[label][0]
            svc = service(label, telemetry)
            base = offline[label] if telemetry == "trajectory" \
                else streamed[label]
            zero_counts()
            same = True
            for w in range(N_WINDOWS):
                o = svc.step(window(w))
                if o is not None:
                    same &= all(bool(torch.equal(x, getattr(base, f)[w]))
                                for x, f in zip(o, FIELDS))
            got = counts()
            want = {n: kernel_of[serve].get(n, 0) for n in got}
            if got != want:
                raise AssertionError(f"service {label} {telemetry}: "
                                     f"launches {got}, expected {want}")
            if telemetry == "streaming":
                same &= same_stats(torch, svc.stats, base.stats)
            same &= bool(torch.equal(svc.queue, base.queue_final))
            if not same:
                raise AssertionError(f"FleetService ({label}, {telemetry}) "
                                     "differs from simulate_fleet")
            print(f"online == offline ({label}, {telemetry}): "
                  f"{N_WINDOWS} FleetService.step calls bitwise equal to "
                  f"simulate_fleet; launches {got}")
            del svc

    # save inside an outage, restore into a new service, run on
    osts = np.arange(0, O, 4)
    plan = faults.outage(N_WINDOWS, O, 20, 30, osts=osts)
    ckdir = ROOT / "build" / "chip_smoke_checkpoints"
    for label in ("fused/pallas", "mega"):
        serve, alloc, _, _ = configs[label]
        base = run(serve, alloc, telemetry="streaming", fault_plan=plan)
        shutil.rmtree(ckdir, ignore_errors=True)
        svc = service(label, "streaming", checkpoint_dir=str(ckdir),
                      fault_plan=plan)
        for w in range(25):
            svc.step(window(w))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = Path(svc.save())
        save_s = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in path.iterdir())
        n_leaves = len(list(path.glob("leaf_*.npy")))
        committed = sorted(d.name for d in ckdir.iterdir())
        del svc
        svc = service(label, "streaming", checkpoint_dir=str(ckdir),
                      fault_plan=plan)
        t0 = time.perf_counter()
        step = svc.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for w in range(step, N_WINDOWS):
            svc.step(window(w))
        down = svc.stats.down_windows.cpu().numpy()
        want_down = np.zeros(O, np.int32)
        want_down[osts] = 10
        if not (same_stats(torch, svc.stats, base.stats)
                and bool(torch.equal(svc.queue, base.queue_final))
                and step == 25 and np.array_equal(down, want_down)):
            raise AssertionError(f"outage restore ({label}) differs from "
                                 "the uninterrupted run")
        print(f"outage restore ({label}, streaming): {len(osts)} OSTs down "
              f"in windows 20-30; saved at window 25 ({n_bytes} B, "
              f"{n_bytes / 1e6:.1f} MB, in {n_leaves} leaves, save {save_s:.3f} s, restore "
              f"{restore_s:.3f} s; committed: {committed}, the first by "
              f"the fault trigger), new service run to window {N_WINDOWS}: "
              "bitwise equal to the uninterrupted run, down_windows 10 on "
              "each outage OST")
        out[f"ckpt_{label}"] = (n_bytes, save_s, restore_s)
        del svc, base
    shutil.rmtree(ckdir, ignore_errors=True)

    # horizon independence: 60 and 2000 windows of streaming mega
    peaks = {}
    for n in (N_WINDOWS, 2000):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run("mega", "core", telemetry="streaming", n_windows=n)
        secs = time.perf_counter() - t0
        peaks[n] = torch.cuda.max_memory_allocated()
        if int(res.stats.windows) != n:
            raise AssertionError(f"{n} windows: stats.windows "
                                 f"{int(res.stats.windows)}")
        out[f"horizon_{n}_w_s"] = n / secs
        del res
    if abs(peaks[2000] - peaks[N_WINDOWS]) > 2 << 20:
        raise AssertionError(f"peak device memory grew with the horizon: "
                             f"{peaks}")
    print(f"horizon independence (mega, streaming): peak device memory "
          f"{peaks[N_WINDOWS]} B over {N_WINDOWS} windows, {peaks[2000]} B "
          f"over 2000 (stats.windows 2000; {out['horizon_2000_w_s']:.1f} "
          "windows/s)")
    out["peaks"] = peaks

    # FleetService.step latency, rates on the card and as numpy
    for label in ("fused/pallas", "mega"):
        for source in ("card", "numpy"):
            svc = service(label, "streaming")
            lat = []
            for w in range(N_WINDOWS):
                if source == "card":
                    x = window(w)
                else:
                    s = (w % trace_windows) * W
                    x = scn.issue_rate[s:s + W]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc.step(x)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
            out[f"lat_{label}_{source}"] = (
                1e3 * float(np.percentile(lat, 50)),
                1e3 * float(np.percentile(lat, 99)))
            del svc
    return out


# ------------------------------------------------------------ the tenant axis

TENANT_F = 16                     # fleets at the main path's width
TENANT_TRAJ_F = 4                 # fleets of the trajectory check
SMALL = dict(o=4, j=8, windows=20, fleets=(16, 256, 1024), loop_cap=256)


def warp_rows(lib="adaptbf_alloc"):
    """Rows a block of a fleet library's warp-row instance, from its C
    entry (``csrc/common.cuh``: WARP_ROWS)."""
    from repro_torch.kernels import _build
    return _build.load(f"{lib}_warp_rows", [], lib=lib)()


def small_tenant_inputs(torch, dev):
    """The small tenants' shared trace and each fleet's nodes and volumes:
    (rates [T, O, J], capacity [O], nodes [F, O, J], volume [F, O, J]) for
    the largest F of ``SMALL["fleets"]`` (a batch of F fleets takes the
    first F), made from seeds."""
    from repro_torch.storage import random_fleet
    o, j, n_win = SMALL["o"], SMALL["j"], SMALL["windows"]
    base = random_fleet(0, n_ost=o, n_jobs=j, duration_s=n_win * W * 0.01)
    rates = torch.as_tensor(base.issue_rate, device=dev)
    cap = torch.as_tensor(base.capacity_per_tick, device=dev)
    rng = np.random.default_rng(7)
    n_max = max(SMALL["fleets"])
    nodes = torch.as_tensor(
        rng.integers(1, 32, (n_max, o, j)).astype(np.float32), device=dev)
    volume = torch.as_tensor(np.where(
        rng.random((n_max, o, j)) < 0.2, 500.0, np.inf).astype(np.float32),
        device=dev)
    return rates, cap, nodes, volume


def small_tenant_rate(torch, dev, cfg, inputs, n_fleets, runs=3):
    """Fleet-windows/s of one batched ``simulate_tenants`` run of the first
    ``n_fleets`` small tenants (``small_tenant_inputs``) under ``cfg``:
    one run to warm up, then the median of ``runs`` on the host's clock."""
    from repro_torch.storage import simulate_tenants
    rates, cap, nodes, volume = inputs

    def batched():
        simulate_tenants(cfg, nodes[:n_fleets], rates, volume[:n_fleets],
                         cap, device=dev)
        torch.cuda.synchronize()

    batched()
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        batched()
        secs.append(time.perf_counter() - t0)
    return n_fleets * SMALL["windows"] / statistics.median(secs)


def tenant_leaves_equal(torch, batched, one, f: int, label: str) -> None:
    """Every tensor leaf of fleet ``f`` of a batched result equals the
    per-fleet result's, bitwise and in dtype; raises otherwise."""
    from repro_torch.pytree import leaves_with_paths
    got = dict(leaves_with_paths(batched))
    for path, x in leaves_with_paths(one):
        if isinstance(x, torch.Tensor):
            y = got[path][f]
            if y.dtype != x.dtype or not torch.equal(y, x):
                raise AssertionError(f"tenants {label}: fleet {f} differs "
                                     f"from its own simulate_fleet in {path}")


def fleet_launch_calls(torch, dev, n_fleets, rates_w, cap, nodes):
    """(B1, B2, B3 adaptbf) calls of the wrappers over ``n_fleets`` fleets'
    rows: one window's shared [W, O, J] rates read through a stride-0
    fleet axis, the fleets' [F, O, J] nodes, seeded queues, volumes,
    budgets and demand.  Returns (the three calls, the tensors they read)."""
    from repro_torch.core.policies import PolicyContext, get_policy
    from repro_torch.core.state import init_fleet_state
    from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.kernels.window_mega import ops as mega_ops
    _, o, j = rates_w.shape
    r = n_fleets * o
    g = np.random.default_rng(n_fleets)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    queue, vol = t(g.random((r, j)) * 12), t(g.integers(0, 500, (r, j)))
    budget = t(np.where(g.random((r, j)) < 0.3, np.inf,
                        g.integers(0, 30, (r, j))))
    backlog = torch.full((r, j), 256.0, device=dev)
    cap_r = cap.repeat(n_fleets)
    rates_f = rates_w.expand(n_fleets, *rates_w.shape)
    demand = t(g.integers(0, 300, (r, j)))
    nodes = nodes.reshape(r, j).contiguous()
    state = init_fleet_state(r, j, device=dev)
    ctx = PolicyContext(nodes=nodes, cap_w=cap_r * W)
    pol = get_policy("adaptbf")
    cap_w = cap_r * W
    calls = (lambda: fw_ops.fleet_window_serve(queue, vol, budget, rates_f,
                                               backlog, cap_r),
             lambda: alloc_ops.fleet_alloc(demand, nodes, *state, cap_w),
             lambda: mega_ops.mega_window_round(
                 pol, ctx, cap_r, backlog, queue, vol, budget,
                 (demand, demand, budget), state, rates_f))
    return calls, (queue, vol, budget, rates_f, backlog, cap_r, demand,
                   nodes, *state, cap_w)


def time_fleet_launches(torch, dev, n_fleets, rates_w, cap, nodes):
    """(B1, B2, B3 adaptbf) milliseconds a call of the wrappers over
    ``n_fleets`` fleets' rows (``fleet_launch_calls``; CUDA events, 20
    calls, median of 5)."""
    calls, _ = fleet_launch_calls(torch, dev, n_fleets, rates_w, cap, nodes)
    return tuple(cuda_ms(call, reps=20) for call in calls)


def layout_launches(lib):
    """A fleet library's launches by row layout [warp, block, cluster],
    counted by its C entry where it picks the instance."""
    from repro_torch.kernels import _build
    fn = _build.load(f"{lib}_layout_launches", [ctypes.c_int], lib=lib)
    return [fn(layout) for layout in (1, 2, 3)]


def tensors_of(tree):
    """The tensors of a result: tuples (named too) and lists walked in
    order."""
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in tensors_of(item)]
    return [tree] if hasattr(tree, "data_ptr") else []


def captured(call):
    """The C entry launches ``call()`` makes through ``_build.launch``:
    [(entry, argtypes, arguments)], made once, and ``call``'s result, which
    holds the buffers the arguments point at."""
    from repro_torch.kernels import _build
    made, real = [], _build.launch

    def record(name, argtypes, *args):
        made.append((name, argtypes, args))
        real(name, argtypes, *args)

    _build.launch = record
    try:
        out = call()
    finally:
        _build.launch = real
    return made, out


def replay(made, suffix=""):
    """A function that repeats the captured launches by their C entries
    (``entry + suffix``, same arguments), without the wrappers' host work;
    raises if a launch fails."""
    from repro_torch.kernels import _build
    fns = [(_build.load(name + suffix, argtypes, lib=name), args)
           for name, argtypes, args in made]

    def go():
        for fn, args in fns:
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"replayed launch failed: CUDA error {err}")
    return go


def one_block_bitwise(torch, name, made, written):
    """Replay the captured launches ``made`` by their one-block entries
    (``*_one_block``) into the same outputs ``written``, filled with NaN
    first so that each value compared is one the replay wrote; raises
    unless every output equals what the warp rows wrote, bit for bit."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    warp = [x.clone() for x in written]
    for x in written:
        x.fill_(float("nan"))
    replay(made, "_one_block")()
    torch.cuda.synchronize()
    if not all(torch.equal(bits(a), bits(b)) for a, b in
               zip(warp, written, strict=True)):
        raise AssertionError(f"{name}: the one-block instance differs from "
                             "the warp rows")


def time_narrow_launches(torch, dev, n_fleets, rates_w, cap, nodes):
    """A launch of B1, B2 and B3 (adaptbf) over ``n_fleets`` narrow fleets'
    rows by its C entry (``captured``, ``replay``: CUDA events, 20 launches,
    median of 5, the wrappers' host work left out; a ctypes call still
    costs a few microseconds of host time, which the empty kernel's time
    shows): the layout the wrappers launch (one warp a row), the one-block
    instances (``*_one_block``: a block of 512 threads a row, what ran
    these rows before the warp layout), and an empty kernel over the warp
    rows' grid (``launch_floor.cu``: the practical floor of a launch).
    Each wrapper call must make exactly one launch, of its own kernel.
    Returns {name: ms}; the one-block outputs are held bitwise against the
    warp rows' (``one_block_bitwise``)."""
    from repro_torch.kernels import _build
    calls, inputs = fleet_launch_calls(torch, dev, n_fleets, rates_w, cap,
                                       nodes)
    read = {x.data_ptr() for x in inputs}
    out = {}
    for name, call in zip(("fleet_window", "adaptbf_alloc", "window_mega"),
                          calls):
        made, res = captured(call)
        if [entry for entry, *_ in made] != [name]:
            raise AssertionError(f"{name}: the wrapper's launches by C entry "
                                 f"were {[entry for entry, *_ in made]}, not "
                                 "one of its own")
        out[name] = cuda_ms(replay(made), reps=20)
        one_block_bitwise(torch, name, made, list(
            {x.data_ptr(): x for x in tensors_of(res)
             if x.data_ptr() not in read}.values()))
        out[f"{name}_one_block"] = cuda_ms(replay(made, "_one_block"),
                                           reps=20)
    floor = _build.load("launch_floor", [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p])
    rows_a_block = warp_rows()
    blocks = -(-n_fleets * nodes.shape[-2] // rows_a_block)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty():
        if floor(blocks, rows_a_block * 32, stream) != 0:
            raise RuntimeError("empty kernel launch failed")
    out["empty"] = cuda_ms(empty, reps=20)
    return out


def wide_tenant_inputs(scn, n_fleets, o=O):
    """[F, o, J] nodes and volumes of F wide fleets over the first o OSTs
    of a fleet: each fleet's own seeded permutation of the fleet's jobs."""
    j = scn.volume.shape[1]
    nodes, volume = [], []
    for f in range(n_fleets):
        perm = np.random.default_rng(100 + f).permutation(j)
        nodes.append(np.broadcast_to(scn.nodes[perm], (o, j)))
        volume.append(scn.volume[:o, perm])
    return np.stack(nodes), np.stack(volume)


#: the wide tenants' per-fleet codes: the default trio cycled, then one
#: out of range
TENANT_CODES = [i % 3 for i in range(TENANT_F - 1)] + [3]


def tenant_phase(torch, dev, inputs, scn, counts, zero_counts, names, card):
    """The tenant axis on the card.  (1) 16 fleets at the main path's width
    (each with its own seeded permutation of the fleet's job nodes and
    volumes, the 839 MB trace shared), the default coded trio cycled plus
    one out-of-range code, 60 windows of streaming telemetry under
    fused/pallas and mega/pallas: bitwise the per-fleet ``simulate_fleet``
    runs, B1 and B2 once a window over all 4096 rows or B3 once a window a
    distinct code, the peak device memory below 16 copies of the trace,
    fleet-windows/s batched and looped (median of 5 each), and B1/B2/B3's
    time a launch over the 4096 rows.  (2) 4 fleets, trajectory, with a
    batched fault plan (an outage of every fourth OST in fleet 1 in
    windows 20-30, lost telemetry on half the OSTs of fleet 2 in windows
    30-40), both paths: bitwise the loop.
    (3) Many small tenants (O=4, J=8, 20 windows, shared trace, streaming
    adaptbf, ``benchmarks/tenant_scaling.py``'s shape): at F=1024, each
    fleet bitwise its own ``simulate_fleet`` run and B1 and B2 (or B3)
    once a window, each on its warp-row instance (``layout_launches``);
    at F of 16, 256 and 1024, aggregate windows/s of the
    batched run and of the per-fleet loop (capped at 256 fleets,
    extrapolated above), and B1/B2/B3's time a launch at F*O rows.
    Returns what phase 4 prints."""
    from repro_torch.storage import (FaultPlan, FleetConfig, faults,
                                     simulate_fleet, simulate_tenants)
    out = {}
    trace_bytes = inputs["rates"].numel() * 4
    paths = {"fused/pallas": ("fused", "pallas"), "mega/pallas": ("mega",
                                                                  "pallas")}

    def fleet_inputs(n_fleets):
        return tuple(torch.as_tensor(x, device=dev)
                     for x in wide_tenant_inputs(scn, n_fleets))

    def expect(serve, n_codes, n_win=N_WINDOWS):
        want = ({"window_mega": n_win * n_codes} if serve == "mega" else
                {"fleet_window": n_win, "adaptbf_alloc": n_win})
        return {name: want.get(name, 0) for name in names}

    def rate_of(n_fleet_windows, fn, runs=5):
        """(median, slowest, fastest) fleet-windows/s of ``runs`` calls of
        ``fn`` (host clock around each, synchronized)."""
        secs = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return (n_fleet_windows / statistics.median(secs),
                n_fleet_windows / max(secs), n_fleet_windows / min(secs))

    # (1) 16 fleets at full width, streaming, the trace shared
    codes = TENANT_CODES
    nodes, volume = fleet_inputs(TENANT_F)
    for label, (serve, alloc) in paths.items():
        cfg = FleetConfig(control="coded", serve_backend=serve,
                          alloc_backend=alloc, telemetry="streaming")
        def batched():
            res = simulate_tenants(cfg, nodes, inputs["rates"], volume,
                                   inputs["cap"], inputs["backlog"],
                                   control_code=codes, n_windows=N_WINDOWS,
                                   device=dev)
            torch.cuda.synchronize()
            return res

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res = batched()
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        if got != expect(serve, len(set(codes))):
            raise AssertionError(f"tenants {label}: launches {got}")
        if peak >= TENANT_F * trace_bytes:
            raise AssertionError(f"tenants {label}: peak {peak} B reaches 16 "
                                 "copies of the trace")
        def one(f, code):
            return simulate_fleet(cfg, nodes[f], inputs["rates"], volume[f],
                                  inputs["cap"], inputs["backlog"],
                                  control_code=code, n_windows=N_WINDOWS,
                                  device=dev)

        for f, code in enumerate(codes):
            tenant_leaves_equal(torch, res, one(f, code), f, label)
        del res
        fw = TENANT_F * N_WINDOWS
        rate = rate_of(fw, batched)
        loop = rate_of(fw, lambda: [one(f, c) for f, c in enumerate(codes)])
        print(f"tenants ({label}, streaming): {TENANT_F} fleets x O={O} x "
              f"J={J}, codes {codes}, {N_WINDOWS} windows, launches {got}; "
              f"every fleet bitwise equal to its own simulate_fleet run; "
              f"peak device memory {peak:,} B (16 copies of the trace: "
              f"{TENANT_F * trace_bytes:,} B); fleet-windows/s (median of 5 "
              f"runs, [slowest, fastest]): batched {rate[0]:.2f} "
              f"[{rate[1]:.2f}, {rate[2]:.2f}], per-fleet loop {loop[0]:.2f} "
              f"[{loop[1]:.2f}, {loop[2]:.2f}] on {card}")
        out[f"peak_{label}"] = peak
        out[f"launches_{label}"] = got
    # B1/B2/B3 a launch over the 16 wide fleets' 4096 rows (CUDA events)
    wide = time_fleet_launches(torch, dev, TENANT_F, inputs["rates"][:W],
                               inputs["cap"], nodes)
    bounds = [bound_ms(*work)[0] for work in (
        window_work(TENANT_F * O, J, W, rate_rows=O),
        alloc_work(TENANT_F * O, J),
        mega_work(TENANT_F * O, J, W, rate_rows=O))]
    print(f"tenants: a launch over {TENANT_F} fleets' {TENANT_F * O} rows of "
          f"J={J} (the shared trace's rates counted once in the bounds): "
          f"fleet_window {wide[0]:.4f} ms (bound {bounds[0]:.4f}), "
          f"adaptbf_alloc {wide[1]:.4f} ms (bound {bounds[1]:.4f}), "
          f"window_mega (adaptbf) {wide[2]:.4f} ms (bound {bounds[2]:.4f}) "
          f"(CUDA events, 20 launches, median of 5) on {card}")
    out["wide_ms"] = wide
    del nodes, volume

    # (2) 4 fleets, trajectory, a batched fault plan
    codes = [0, 0, 0, 2]
    nodes, volume = fleet_inputs(TENANT_TRAJ_F)
    plans = [faults.no_faults(N_WINDOWS, O) for _ in codes]
    plans[1] = faults.outage(N_WINDOWS, O, 20, 30, osts=range(0, O, 4))
    plans[2].telem_ok[30:40, : O // 2] = 0.0
    plan = FaultPlan(*(np.stack(x) for x in zip(*plans)))
    for label, (serve, alloc) in paths.items():
        cfg = FleetConfig(control="coded", serve_backend=serve,
                          alloc_backend=alloc)
        zero_counts()
        res = simulate_tenants(cfg, nodes, inputs["rates"], volume,
                               inputs["cap"], inputs["backlog"],
                               control_code=codes, n_windows=N_WINDOWS,
                               fault_plan=plan, device=dev)
        torch.cuda.synchronize()
        got = counts()
        if got != expect(serve, len(set(codes))):
            raise AssertionError(f"tenants {label}, trajectory: launches "
                                 f"{got}")
        for f, code in enumerate(codes):
            one = simulate_fleet(cfg, nodes[f], inputs["rates"], volume[f],
                                 inputs["cap"], inputs["backlog"],
                                 control_code=code, n_windows=N_WINDOWS,
                                 fault_plan=plans[f], device=dev)
            tenant_leaves_equal(torch, res, one, f, f"{label}, trajectory")
            del one
        print(f"tenants ({label}, trajectory, faults): {TENANT_TRAJ_F} "
              f"fleets, codes {codes}, outage in fleet 1, lost telemetry in "
              f"fleet 2, launches {got}; every fleet bitwise equal to its own "
              f"simulate_fleet run ({res.served.numel() * 16 / 1e9:.1f} GB "
              "of trajectories)")
        del res
    del nodes, volume
    torch.cuda.empty_cache()

    # (3) many small tenants
    o, j, n_win = SMALL["o"], SMALL["j"], SMALL["windows"]
    small_in = small_tenant_inputs(torch, dev)
    rates, cap, nodes_all, volume_all = small_in
    n_max = max(SMALL["fleets"])
    small = {}
    for label, (serve, alloc) in paths.items():
        cfg = FleetConfig(serve_backend=serve, alloc_backend=alloc,
                          telemetry="streaming")
        # the largest batch (F*O rows of J=8) against the per-fleet loop;
        # B1 and B2 (or B3) on their warp-row instances every window
        n_f = n_max
        libs = (("window_mega",) if serve == "mega"
                else ("fleet_window", "adaptbf_alloc"))
        zero_counts()
        warp_before = [layout_launches(lib) for lib in libs]
        res = simulate_tenants(cfg, nodes_all, rates, volume_all, cap,
                               device=dev)
        torch.cuda.synchronize()
        got = counts()
        warp = [[a - b for a, b in zip(layout_launches(lib), was)]
                for lib, was in zip(libs, warp_before)]
        if got != expect(serve, 1, n_win):
            raise AssertionError(f"small tenants {label}: launches {got}")
        if warp != [[n_win, 0, 0]] * len(libs):
            raise AssertionError(f"small tenants {label}: {libs} launches by "
                                 f"row layout (warp, block, cluster) {warp}")
        for f in range(n_f):
            tenant_leaves_equal(torch, res, simulate_fleet(
                cfg, nodes_all[f], rates, volume_all[f], cap, device=dev),
                f, f"small {label}")
        del res
        print(f"small tenants ({label}, streaming adaptbf, O={o} J={j}, "
              f"{n_win} windows) F={n_f}: launches {got}, "
              + ", ".join(f"{lib}'s by row layout (warp, block, cluster) {w}"
                          for lib, w in zip(libs, warp))
              + "; every fleet bitwise equal to its own simulate_fleet run")
        for n_f in SMALL["fleets"]:
            nodes, volume = nodes_all[:n_f], volume_all[:n_f]

            def loop(k):
                for f in range(k):
                    simulate_fleet(cfg, nodes[f], rates, volume[f], cap,
                                   device=dev)
                torch.cuda.synchronize()

            entry = {"batched": small_tenant_rate(torch, dev, cfg, small_in,
                                                  n_f)}
            if label == "fused/pallas":
                k = min(n_f, SMALL["loop_cap"])
                loop(1)
                t0 = time.perf_counter()
                loop(k)
                entry["loop"] = k * n_win / (time.perf_counter() - t0)
                entry["extrapolated"] = k < n_f
            small[(label, n_f)] = entry
    # B1/B2/B3's time a launch at F*O rows of J=8 (CUDA events): through
    # the wrappers, and by their C entries beside B2's and B3's one-block
    # instances and an empty launch
    launch_ms = {n_f: time_fleet_launches(torch, dev, n_f, rates[:W], cap,
                                          nodes_all[:n_f])
                 for n_f in SMALL["fleets"]}
    narrow_ms = {n_f: time_narrow_launches(torch, dev, n_f, rates[:W], cap,
                                           nodes_all[:n_f])
                 for n_f in SMALL["fleets"]}
    for (label, n_f), e in small.items():
        loop_txt = ""
        if "loop" in e:
            loop_txt = (f", per-fleet loop {e['loop']:.1f}"
                        + (f" (measured on {SMALL['loop_cap']} fleets, "
                           "extrapolated)" if e["extrapolated"] else ""))
        print(f"small tenants ({label}, streaming adaptbf, O={o} J={j}, "
              f"{n_win} windows) F={n_f}: batched {e['batched']:.1f} "
              f"windows/s{loop_txt} on {card}")
    rows_a_block = warp_rows()
    for n_f, (b1, b2, b3) in launch_ms.items():
        r = n_f * o
        bounds = [bound_ms(*work)[0] for work in (
            window_work(r, j, W, rate_rows=o), alloc_work(r, j),
            mega_work(r, j, W, rate_rows=o))]
        t = narrow_ms[n_f]
        print(f"small tenants: a launch at F*O={r} rows of J={j} by its C "
              f"entry (CUDA events, 20 launches, median of 5; bound beside; "
              f"one warp a row, {rows_a_block} rows a block, beside the "
              f"one-block instance): "
              + ", ".join(
                  f"{name} {t[name]:.5f} ms (bound {b:.7f}; the one-block "
                  f"instance {t[name + '_one_block']:.5f} ms, "
                  f"{t[name + '_one_block'] / t[name]:.2f}x)"
                  for name, b in zip(("fleet_window", "adaptbf_alloc",
                                      "window_mega"), bounds))
              + "; an "
              f"empty kernel over {-(-r // rows_a_block)} blocks of "
              f"{rows_a_block * 32} threads {t['empty']:.5f} ms; through the "
              f"wrappers {b1:.4f}, {b2:.4f}, {b3:.4f} ms on {card}")
    out["small"], out["launch_ms"], out["narrow_ms"] = small, launch_ms, narrow_ms
    return out


def tenant_entry(tenants, name: str, k: int) -> dict:
    """A fleet kernel's tenant numbers for the kernels line: its launches
    in the 16-fleet streaming runs and its time a call of the wrapper by
    rows x jobs (the wide fleets' 4096 x 4096 and the small tenants' F*O x
    8); at the small tenants also its time a launch by its C entry, its
    one-block instance's and the empty kernel's."""
    ms = {f"{TENANT_F * O}x{J}": tenants["wide_ms"][k]}
    ms.update({f"{n_f * SMALL['o']}x{SMALL['j']}": t[k]
               for n_f, t in tenants["launch_ms"].items()})
    small = {f"{n_f * SMALL['o']}x{SMALL['j']}": t
             for n_f, t in tenants["narrow_ms"].items()}
    entry = {"tenant_launches": sum(tenants[f"launches_{p}"][name]
                                    for p in ("fused/pallas", "mega/pallas")),
             "tenant_ms_by_rows_x_jobs": ms,
             "narrow_entry_ms_by_rows_x_jobs": {
                 key: t[name] for key, t in small.items()},
             "empty_launch_ms_by_rows_x_jobs": {
                 key: t["empty"] for key, t in small.items()}}
    entry["narrow_layout"] = f"one warp a row, {warp_rows(name)} rows a block"
    entry["one_block_entry_ms_by_rows_x_jobs"] = {
        key: t[f"{name}_one_block"] for key, t in small.items()}
    return entry


# ---------------------------------------------------------- sharding

#: the sharded runs, each run unsharded in the parent and sharded on the
#: ranks: label -> (entry point, FleetConfig fields, what else it takes)
SHARD_JOBS = {
    "fused/pallas": ("fleet", dict(serve_backend="fused",
                                   alloc_backend="pallas"), ()),
    "fused/pallas, streaming": ("fleet", dict(
        serve_backend="fused", alloc_backend="pallas",
        telemetry="streaming"), ()),
    "mega": ("fleet", dict(serve_backend="mega"), ()),
    "mega, streaming": ("fleet", dict(serve_backend="mega",
                                      telemetry="streaming"), ()),
    "coded mega, streaming": ("fleet", dict(
        control="coded", serve_backend="mega", telemetry="streaming"),
        ("code",)),
    "faulted mega, streaming": ("fleet", dict(
        serve_backend="mega", telemetry="streaming"), ("faults",)),
    "tenants fused/pallas, streaming": ("tenants", dict(
        control="coded", serve_backend="fused", alloc_backend="pallas",
        telemetry="streaming"), ()),
    "tenants mega/pallas, streaming": ("tenants", dict(
        control="coded", serve_backend="mega", alloc_backend="pallas",
        telemetry="streaming"), ()),
}
SHARD_FLEET = [k for k, v in SHARD_JOBS.items() if v[0] == "fleet"]
#: (backend, ranks, runs): one group of processes each, in turn
SHARD_GROUPS = [("nccl", 1, ["fused/pallas"]), ("gloo", 2, SHARD_FLEET),
                ("gloo", 4, list(SHARD_JOBS))]
TENANT_MESH = (2, 2)
SHARD_MEMORY_CAP = 0.4    # a rank's peak / the unsharded run's, 4 ranks,
                          # every run
SHARD_DIR = ROOT / "build" / "chip_smoke_shard"


def shard_run(label, data, sharded: bool, device=None):
    """Run ``label`` of ``SHARD_JOBS`` on the global host inputs ``data``:
    ``partition="ost_shard"`` (``"fleet_shard"`` on ``TENANT_MESH`` for the
    tenants) when ``sharded``, else unsharded."""
    from repro_torch.storage import (FLEET_CONTROL_CODES, FleetConfig, faults,
                                     simulate_fleet, simulate_tenants)
    entry, fields, extra = SHARD_JOBS[label]
    kw = dict(n_windows=N_WINDOWS, device=device)
    if entry == "tenants":
        cfg = FleetConfig(**fields, partition=("fleet_shard" if sharded
                                               else "none"))
        if sharded:
            kw["mesh_shape"] = TENANT_MESH
        return simulate_tenants(
            cfg, data["tenant_nodes"], data["rates"], data["tenant_volume"],
            data["cap"], data["backlog"], control_code=TENANT_CODES, **kw)
    cfg = FleetConfig(**fields, partition="ost_shard" if sharded else "none")
    if "code" in extra:
        kw["control_code"] = FLEET_CONTROL_CODES["adaptbf"]
    if "faults" in extra:
        kw["fault_plan"] = faults.outage(N_WINDOWS, O, 20, 30,
                                         osts=range(0, O, 4))
    return simulate_fleet(cfg, data["nodes"], data["rates"], data["volume"],
                          data["cap"], data["backlog"], **kw)


def leaf_digests(result) -> dict:
    """SHA-256 of each tensor leaf's bytes, with its dtype and shape: two
    results are bitwise equal exactly when their digests are."""
    import hashlib

    import torch
    from repro_torch.pytree import leaves_with_paths
    out = {}
    for path, x in leaves_with_paths(result):
        if isinstance(x, torch.Tensor):
            a = x.detach().cpu().contiguous().numpy()
            out[path] = (f"{a.dtype}{a.shape}"
                         + hashlib.sha256(a.tobytes()).hexdigest())
    return out


def shard_rank(rank, world, backend, tmp, labels):
    """One rank of the sharding phase: join the group (a file rendezvous),
    run each of ``labels`` sharded on the global inputs the parent left in
    ``tmp`` (the trace memory-mapped, so only the rank's rows reach its
    device), hold every leaf of the gathered result to the parent's
    unsharded digests, and write the rank's times, peak device memory,
    launches and collectives to ``tmp``.  Raises on any difference."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.kernels.window_mega import ops as mega_ops
    from repro_torch.launch import mesh
    kernels = {"fleet_window": fw_ops, "adaptbf_alloc": alloc_ops,
               "window_mega": mega_ops}
    tmp = Path(tmp)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/rendezvous-{backend}-{world}",
        rank=rank, world_size=world)
    try:
        data = dict(np.load(tmp / "inputs.npz"))
        data["rates"] = np.load(tmp / "rates.npy", mmap_mode="c")
        want = np.load(tmp / "unsharded.npz")
        records = []
        for label in labels:
            for mod in kernels.values():
                mod.launches = 0
            mesh.reset_collectives()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            dist.barrier()
            t0 = time.perf_counter()
            res = shard_run(label, data, sharded=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            got = leaf_digests(res)
            del res
            keys = [k.split("|", 1)[1] for k in want.files
                    if k.startswith(label + "|")]
            bad = sorted(set(keys) ^ set(got)) + [
                p for p in keys if p in got and str(want[f"{label}|{p}"])
                != got[p]]
            if bad:
                raise AssertionError(
                    f"sharding ({backend}, rank {rank} of {world}) {label}: "
                    f"not bitwise the unsharded run in {bad}")
            records.append(dict(
                label=label, secs=secs, peak=peak,
                launches={n: m.launches for n, m in kernels.items()},
                collectives={k: dict(v) for k, v in
                             mesh.collectives.items()}))
        (tmp / f"ranks-{backend}-{world}-{rank}.json").write_text(
            json.dumps(records))
        dist.barrier()         # no rank leaves the group while one works
    finally:
        dist.destroy_process_group()


def shard_phase(torch, dev, scn, card):
    """Sharding on ``torch.distributed`` (``partition="ost_shard"`` and
    ``"fleet_shard"``) at the main fleet cell.  The parent runs each of
    ``SHARD_JOBS`` unsharded on the card from host inputs (timing it and
    taking its peak device memory), leaves the inputs (the 839 MB trace as
    a ``.npy`` the ranks memory-map) and the unsharded results' per-leaf
    digests (an ``.npz``) in ``SHARD_DIR``, and spawns each group of
    ``SHARD_GROUPS`` in turn: NCCL at one rank, gloo at 2 and at 4 ranks
    sharing ``cuda:0``.  Every rank's gathered result must be bitwise the
    unsharded run, every rank must launch B1 and B2 (fused/pallas) or B3
    (mega, once a distinct code among its fleets) once a window, and at 4
    ranks each rank's peak device memory must stay within
    ``SHARD_MEMORY_CAP`` of the unsharded run's in every run.  Returns each fleet
    kernel's launches per rank by group."""
    import shutil

    import torch.multiprocessing as mp
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    SHARD_DIR.mkdir(parents=True)
    out = {name: {} for name in ("fleet_window", "adaptbf_alloc",
                                 "window_mega")}
    try:
        t_nodes, t_volume = wide_tenant_inputs(scn, TENANT_F)
        data = dict(nodes=scn.nodes, volume=scn.volume,
                    cap=scn.capacity_per_tick, backlog=scn.max_backlog,
                    tenant_nodes=t_nodes, tenant_volume=t_volume)
        np.savez(SHARD_DIR / "inputs.npz", **data)
        np.save(SHARD_DIR / "rates.npy", scn.issue_rate)
        data["rates"] = scn.issue_rate
        digests, peak, rate = {}, {}, {}
        for label in SHARD_JOBS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = shard_run(label, data, sharded=False, device=dev)
            torch.cuda.synchronize()
            rate[label] = N_WINDOWS / (time.perf_counter() - t0)
            peak[label] = torch.cuda.max_memory_allocated() - base
            for path, d in leaf_digests(res).items():
                digests[f"{label}|{path}"] = np.array(d)
            del res
        np.savez(SHARD_DIR / "unsharded.npz", **digests)
        print("sharding: unsharded runs on the card from host inputs "
              f"({N_WINDOWS} windows): " + "; ".join(
                  f"{k} {rate[k]:.2f} windows/s, peak device memory "
                  f"{peak[k]:,} B" for k in SHARD_JOBS) + f" on {card}")
        torch.cuda.empty_cache()
        for backend, world, labels in SHARD_GROUPS:
            t0 = time.perf_counter()
            mp.spawn(shard_rank, args=(world, backend, str(SHARD_DIR),
                                       labels), nprocs=world, join=True)
            wall = time.perf_counter() - t0
            ranks = [json.loads((SHARD_DIR / f"ranks-{backend}-{world}-"
                                 f"{r}.json").read_text())
                     for r in range(world)]
            group = f"{backend} x{world}"
            shard_check(group, world, labels, ranks, peak)
            for name in out:
                out[name][group] = [sum(rec["launches"][name] for rec in rk)
                                    for rk in ranks]
            shard_print(group, world, labels, ranks, peak, rate, wall, card)
    finally:
        shutil.rmtree(SHARD_DIR, ignore_errors=True)
    return out


def shard_expected(label, world, rank):
    """The fleet-kernel launches one rank of ``world`` makes in ``label``."""
    entry, fields, _ = SHARD_JOBS[label]
    if fields.get("serve_backend") != "mega":
        return {"fleet_window": N_WINDOWS, "adaptbf_alloc": N_WINDOWS,
                "window_mega": 0}
    n_codes = 1
    if entry == "tenants":   # B3 once a window a distinct code of its fleets
        per = TENANT_F // TENANT_MESH[0]
        block = rank // TENANT_MESH[1] if world > 1 else 0
        n_codes = len(set(TENANT_CODES[block * per:(block + 1) * per]))
    return {"fleet_window": 0, "adaptbf_alloc": 0,
            "window_mega": N_WINDOWS * n_codes}


def shard_check(group, world, labels, ranks, peak):
    for r, records in enumerate(ranks):
        for rec in records:
            want = shard_expected(rec["label"], world, r)
            if rec["launches"] != want:
                raise AssertionError(f"sharding ({group}) rank {r} "
                                     f"{rec['label']}: launches "
                                     f"{rec['launches']}, expected {want}")
            if (world == 4
                    and rec["peak"] > SHARD_MEMORY_CAP * peak[rec["label"]]):
                raise AssertionError(
                    f"sharding ({group}) rank {r} {rec['label']}: peak "
                    f"device memory {rec['peak']:,} B above "
                    f"{SHARD_MEMORY_CAP} x the unsharded run's "
                    f"{peak[rec['label']]:,} B")
    assert [[rec["label"] for rec in rk] for rk in ranks] == [labels] * world


def shard_print(group, world, labels, ranks, peak, rate, wall, card):
    print(f"sharding ({group}, ranks share one card: not a scaling figure; "
          f"spawn to exit {wall:.1f} s): every rank's result bitwise the "
          "unsharded run in " + ", ".join(labels) + f" on {card}")
    for k, label in enumerate(labels):
        recs = [rk[k] for rk in ranks]
        coll = {}
        for rec in recs:
            for name, c in rec["collectives"].items():
                agg = coll.setdefault(name, [0, 0.0])
                agg[0] += c["calls"]
                agg[1] = max(agg[1], c["seconds"] / max(c["calls"], 1))
        ar = coll.get("all_reduce", [0, 0.0])
        ag = coll.get("gather", [0, 0.0])
        per_window = {n: [rec["launches"][n] / N_WINDOWS for rec in recs]
                      for n in recs[0]["launches"]}
        slowest = max(r["secs"] for r in recs)
        top = max(r["peak"] for r in recs)
        print(f"  {group} {label}: windows/s {N_WINDOWS / slowest:.2f} "
              f"(slowest rank; unsharded {rate[label]:.2f}); peak device "
              f"memory per rank {[r['peak'] for r in recs]} B vs unsharded "
              f"{peak[label]:,} B (max {top / peak[label]:.3f}x); "
              f"launches per rank per window {per_window}; busy-count "
              f"all_reduce {ar[0] // world} a rank, "
              f"{ar[1] * 1e3:.4f} ms of host time a window (slowest rank); "
              f"final gather into host memory {ag[1] * 1e3:.2f} ms (slowest "
              f"rank); staged "
              f"through the host by the port: none ({group.split()[0]} "
              "takes the card's tensors)")


# ------------------------------------------- rows over clusters (1, 2, 3h, 4)

#: the wide cells: (label, O, J, windows run), 20 windows of trace each
WIDE_CELLS = [("wide-16k", 256, 16384, N_WINDOWS), ("wide-64k", 64, 65536, 20)]
#: the wide tenants: fleets of wide-16k's first OSTs, per-fleet codes (the
#: default trio and one out of range)
WIDE_TENANT_F, WIDE_TENANT_O, WIDE_TENANT_CODES = 4, 64, [0, 1, 2, 3]
#: the wide kernel instances (16 lanes a thread, a cluster a row)
WIDE_MARKERS = {"fleet_window": ("fleet_window_kernelILi16E",
                                 "RowBlockILb1E"),
                "adaptbf_alloc": ("adaptbf_alloc_kernelILi16E",
                                  "RowBlockILb1E"),
                "window_mega": ("window_mega_kernelILi16ELi0ELb0E",
                                "RowBlockILb1E")}


def wide_build_summary(libs, n_sm):
    """Phase 1 for rows over clusters: ptxas's registers, spills and static
    shared memory of each fleet kernel's wide instance (one instance serves
    clusters of 2, 4 and 8 blocks) and, for each cluster size, the dynamic
    shared memory a block and the clusters resident on the card
    (``cudaOccupancyMaxActiveClusters``).  Returns {kernel: {c: clusters}}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import cluster_size
    out = {}
    for name, marker in WIDE_MARKERS.items():
        regs, stores, loads, smem = ptxas_of(libs[name].with_suffix(".log"),
                                             marker)
        per_c, dyn = {}, 0
        for j in (16384, 32768, 65536):
            clusters, dyn = _build.occupancy(name, j)
            if clusters < 1:
                raise AssertionError(f"{name}: no cluster of "
                                     f"{cluster_size(j)} fits the card")
            per_c[cluster_size(j)] = clusters
        out[name] = per_c
        print(f"{name} over clusters (16 lanes a thread, a slice of up to "
              f"8192 jobs a block): {regs} registers, {stores} B spill "
              f"stores, {loads} B spill loads, {smem} B static + {dyn} B "
              f"dynamic shared memory a block; clusters resident on the card "
              + ", ".join(f"c={c}: {n} ({n * c} of {n_sm} SMs)"
                          for c, n in per_c.items()))
    return out


def narrow_build_summary(libs, n_sm, occupancy):
    """Phase 1 for narrow rows (J <= 32): ptxas's registers, spills and
    static shared memory of B1's, B2's and B3's (adaptbf) warp-row
    instances, the dynamic shared memory a block and the blocks of
    ``warp_rows`` rows resident on an SM, into ``occupancy`` as
    ``<name>_narrow``."""
    from repro_torch.kernels import _build
    for name, marker in (("fleet_window", ("fleet_window_kernelILi1E",
                                           "RowWarp")),
                         ("adaptbf_alloc", ("adaptbf_alloc_kernelILi1E",
                                            "RowWarp")),
                         ("window_mega", ("window_mega_kernelILi1ELi0ELb0E",
                                          "RowWarp"))):
        regs, stores, loads, smem = ptxas_of(libs[name].with_suffix(".log"),
                                             marker)
        blocks, dyn = _build.occupancy(name, SMALL["j"])
        if blocks < 1:
            raise AssertionError(f"{name}: no block of warp rows fits an SM")
        occupancy[f"{name}_narrow"] = blocks
        rows = warp_rows(name)
        print(f"{name} at J={SMALL['j']} (one warp a row, {rows} rows a "
              f"block of {rows * 32} threads): {regs} registers, "
              f"{stores} B spill stores, {loads} B spill loads, {smem} B "
              f"static + {dyn} B dynamic shared memory a block; {blocks} "
              f"blocks an SM, {blocks * rows * n_sm} rows a wave on "
              f"{n_sm} SMs")


def leaf_errs(torch, label, got, want, atol):
    """The largest |got - want| over finite lanes of each pair; raises on a
    finite-mask difference or an error past atol."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if not torch.equal(g.isfinite(), w.isfinite()):
            raise AssertionError(f"{label}: leaf {i} finite masks differ")
        fin = w.isfinite()
        e = float((g[fin].double() - w[fin].double()).abs().max()) \
            if bool(fin.any()) else 0.0
        if e > atol:
            raise AssertionError(f"{label}: leaf {i} off by {e} > {atol}")
        worst = max(worst, e)
    return worst


def check_wide_kernels(torch, fw_ops, alloc_ops, mega_ops, dev, clusters):
    """Phase 2 for rows over clusters: at J=16384 (clusters of 2), 32768
    (of 4) and 65536 (of 8), at O of 1 and one past a full wave of
    clusters (each kernel's resident clusters + 1): B1 at W of 0, 1 and 10
    (atol 1e-4; budgets of +inf and 0, backlog caps below the queue); B2
    (allocations equal, record and remainder within 1e-3); B3 for each
    built-in policy and coded dispatch (each code), one round and one round
    with a fault row (every leaf within 1e-3, adaptbf's allocation equal).
    Returns the largest error of each kernel."""
    from repro_torch.core.policies import CodedPolicy, get_policy
    from repro_torch.kernels.dispatch import cluster_size
    from repro_torch.storage import DEFAULT_CODED_POLICIES, FLEET_CONTROL_CODES
    worst = {"fleet_window": 0.0, "adaptbf_alloc": 0.0, "window_mega": 0.0}
    cases = [(name, get_policy(name), None) for name in
             ("adaptbf", "static", "nobw", "static_wc", "aimd")]
    cases += [(f"coded[{name}]", CodedPolicy(DEFAULT_CODED_POLICIES), code)
              for name, code in FLEET_CONTROL_CODES.items()]
    for j in (16384, 32768, 65536):
        c = cluster_size(j)
        for name in worst:
            o_wave = clusters[name][c] + 1
            for o in (1, o_wave):
                if name == "fleet_window":
                    for w in (0, 1, W):
                        queue, vol, budget, rates, backlog, cap = window_case(
                            o, j, w, seed=o + j + w)
                        budget[:, ::7] = 0.0
                        backlog[:, ::5] = queue[:, ::5] * 0.5
                        args = [torch.as_tensor(x, device=dev) for x in
                                (queue, vol, budget, rates, backlog, cap)]
                        e = leaf_errs(torch, f"fleet_window O={o} J={j} W={w}",
                                      fw_ops.fleet_window_serve(*args),
                                      fw_ops.fleet_window_ref(*args), 1e-4)
                        worst[name] = max(worst[name], e)
                elif name == "adaptbf_alloc":
                    host = list(alloc_case(o, j, seed=o * 7 + j))
                    host[3] = (np.random.default_rng(o).random((o, j)) - 0.5
                               ).astype(np.float32)
                    args = [torch.as_tensor(x, device=dev) for x in host]
                    got = alloc_ops.fleet_alloc(*args)
                    want = alloc_ops.fleet_alloc_ref(*args)[:3]
                    if not torch.equal(got[0], want[0]):
                        raise AssertionError(f"adaptbf_alloc O={o} J={j}: "
                                             "allocations differ")
                    worst[name] = max(worst[name], leaf_errs(
                        torch, f"adaptbf_alloc O={o} J={j}", got[1:], want[1:],
                        1e-3))
                else:
                    for k, (label, policy, code) in enumerate(cases):
                        e = check_mega_case(
                            torch, mega_ops, policy, code, o, j, seed=400 + k,
                            dev=dev, label=f"window_mega {label} O={o} J={j}",
                            exact=label == "adaptbf")
                        worst[name] = max(worst[name], e)
            print(f"{name} over clusters of {c} vs plain at J={j}, O of 1 and "
                  f"{o_wave} (one past a full wave of clusters)"
                  + (", W of 0, 1 and 10" if name == "fleet_window" else "")
                  + (", every policy case, a fault round" if name ==
                     "window_mega" else "")
                  + f": max |err| {worst[name]}")
    return worst


def check_narrow_kernels(torch, fw_ops, alloc_ops, mega_ops, dev):
    """Phase 2 for narrow rows (one warp a row, ``warp_rows`` rows a
    block): at J of 1, 8 (the small tenants') and 32, over 17 rows (the
    last block part-filled) and 4096 (the small tenants' 1024 fleets of 4):
    B1 (within 1e-4 of the plain version, budgets of +inf and 0, backlog
    caps below the queue, capacities that some row-ticks' phase 1
    overflows; bitwise its one-block instance, ``one_block_bitwise``), B2
    (allocations equal, record and remainder within 1e-3) and B3 for
    each built-in policy and coded dispatch (each code), one round and one
    round with a fault row (every leaf within 1e-3, adaptbf's allocation
    equal).  Returns the largest error of each."""
    from repro_torch.core.policies import CodedPolicy, get_policy
    from repro_torch.storage import DEFAULT_CODED_POLICIES, FLEET_CONTROL_CODES
    worst = {"fleet_window": 0.0, "adaptbf_alloc": 0.0, "window_mega": 0.0}
    cases = [(name, get_policy(name), None) for name in
             ("adaptbf", "static", "nobw", "static_wc", "aimd")]
    cases += [(f"coded[{name}]", CodedPolicy(DEFAULT_CODED_POLICIES), code)
              for name, code in FLEET_CONTROL_CODES.items()]
    for j in (1, SMALL["j"], 32):
        for o in (17, 1024 * SMALL["o"]):
            queue, vol, budget, rates, backlog, cap = window_case(
                o, j, W, seed=o + j)
            budget[:, ::7] = 0.0
            backlog[:, ::5] = queue[:, ::5] * 0.5
            wargs = [torch.as_tensor(x, device=dev)
                     for x in (queue, vol, budget, rates, backlog, cap)]
            made, got = captured(lambda: fw_ops.fleet_window_serve(*wargs))
            worst["fleet_window"] = max(worst["fleet_window"], leaf_errs(
                torch, f"fleet_window O={o} J={j}", got,
                fw_ops.fleet_window_ref(*wargs), 1e-4))
            one_block_bitwise(torch, f"fleet_window O={o} J={j}", made,
                              list(got))
            host = list(alloc_case(o, j, seed=o * 7 + j))
            host[3] = (np.random.default_rng(o).random((o, j)) - 0.5
                       ).astype(np.float32)
            args = [torch.as_tensor(x, device=dev) for x in host]
            got = alloc_ops.fleet_alloc(*args)
            want = alloc_ops.fleet_alloc_ref(*args)[:3]
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"adaptbf_alloc O={o} J={j}: "
                                     "allocations differ")
            worst["adaptbf_alloc"] = max(worst["adaptbf_alloc"], leaf_errs(
                torch, f"adaptbf_alloc O={o} J={j}", got[1:], want[1:], 1e-3))
            for k, (label, policy, code) in enumerate(cases):
                worst["window_mega"] = max(worst["window_mega"], check_mega_case(
                    torch, mega_ops, policy, code, o, j, seed=500 + k, dev=dev,
                    label=f"window_mega {label} O={o} J={j}",
                    exact=label == "adaptbf"))
        print(f"fleet_window, adaptbf_alloc and window_mega (every policy "
              f"case, a fault round) on warp rows vs plain at J={j}, O of 17 "
              f"and {1024 * SMALL['o']}: fleet_window max |err| "
              f"{worst['fleet_window']} (atol 1e-4) and bitwise its one-block "
              f"instance; allocations equal, max |err| "
              f"{worst['adaptbf_alloc']}, {worst['window_mega']} (atol 1e-3)")
    return worst


def check_mega_case(torch, mega_ops, policy, code, o, j, seed, dev, label,
                    exact):
    """One megakernel round of ``policy`` (``mega_case``'s running fleet at
    O=o, J=j) and one with a fault row (OST 0 loses telemetry, the last OST
    is down), each against the plain round: every leaf within 1e-3 with
    equal finite masks, the next allocation equal when ``exact``.  Returns
    the largest error."""
    inputs, rng = mega_case(torch, policy, o, j, W, seed=seed, dev=dev,
                            code=code)
    ctx, cap_tick, backlog, queue, vol, alloc, held, pstate = inputs
    up = torch.ones(o, device=dev)
    up[-1] = 0.0 if o > 1 else 1.0
    telem = torch.ones(o, device=dev)
    telem[0] = 0.0
    worst = 0.0
    for r in range(2):
        rates = torch.as_tensor(
            rng.integers(0, 4, (W, o, j)).astype(np.float32), device=dev)
        faults = ()
        args = (policy, ctx, cap_tick, backlog, queue, vol, alloc, held,
                pstate, rates)
        if r == 1:
            cap_r = cap_tick * up
            args = (policy, ctx._replace(cap_w=cap_r * W), cap_r, backlog,
                    queue, vol, alloc, held, pstate, rates * up[None, :, None])
            faults = (telem, up)
        got = mega_ops.mega_window_round(*args, *faults)
        want = mega_ops.ref.mega_round_ref(*args, *faults)
        if exact and not torch.equal(got[8], want[8]):
            raise AssertionError(f"{label} round {r}: allocations differ")
        flat = lambda out: [*out[:7], *mega_ops._leaves(out[7]), out[8]]
        worst = max(worst, leaf_errs(torch, f"{label} round {r}", flat(got),
                                     flat(want), 1e-3))
        queue, vol = want[0], want[1]
        held, pstate, alloc = tuple(want[4:7]), want[7], want[8]
    return worst


def wide_fleet(torch, dev, o, j):
    """A wide cell's fleet on the card: ``random_fleet(0, n_ost=o,
    n_jobs=j, "mixed", 2.0 s)``."""
    from repro_torch.storage import random_fleet
    t0 = time.perf_counter()
    scn = random_fleet(0, n_ost=o, n_jobs=j, profile="mixed", duration_s=2.0)
    inputs = dict(nodes=torch.as_tensor(scn.nodes, device=dev),
                  rates=torch.as_tensor(scn.issue_rate, device=dev),
                  volume=torch.as_tensor(scn.volume, device=dev),
                  cap=torch.as_tensor(scn.capacity_per_tick, device=dev),
                  backlog=torch.as_tensor(scn.max_backlog, device=dev))
    inputs["trace_windows"] = scn.issue_rate.shape[0] // W
    print(f"wide fleet: random_fleet(0, n_ost={o}, n_jobs={j}, mixed, 2.0 s) "
          f"built in {time.perf_counter() - t0:.1f} s; rates "
          f"{scn.issue_rate.shape}, {scn.issue_rate.nbytes / 1e6:.0f} MB")
    return scn, inputs


def wide_phase(torch, dev, counts, zero_counts, names, card):
    """Phase 3h: the main path over clusters.  wide-16k (256 x 16384,
    clusters of 2; 20 windows of trace tiled to 60): fused/pallas against
    plain scan/core on the card, mega against fused/pallas (the main
    cell's comparisons: first window within 1e-3, alloc and record in
    every window within 1e-3, horizon service per OST within 1e-3
    relative, the invariants), coded (AdapTBF's code) equal to mega
    bitwise, streaming mega's queue_final equal to its trajectory run's,
    and 4 fleets of its first 64 OSTs under mega/pallas with per-fleet
    codes, each fleet bitwise its own ``simulate_fleet`` run.  wide-64k
    (64 x 65536, clusters of 8; 20 windows): fused/pallas against plain,
    mega against fused/pallas.  Every run's launch counters: B1 and B2
    once a window, or B3 once a window (a distinct code).  Windows/s of
    fused/pallas and mega (median of 3 runs) and of the plain run.
    Returns {cell: numbers} for phase 4 and the kernel line."""
    from repro_torch.storage import (FLEET_CONTROL_CODES, FleetConfig,
                                     simulate_fleet, simulate_tenants)
    from repro_torch.kernels.dispatch import cluster_size
    t_phase = time.perf_counter()
    out = {}
    for label, o, j, n_win in WIDE_CELLS:
        scn, inputs = wide_fleet(torch, dev, o, j)
        cap_w = inputs["cap"].double() * W
        c = cluster_size(j)

        def run(serve, alloc, control="adaptbf", code=None,
                telemetry="trajectory"):
            return fleet_run(torch, dev, inputs, serve, alloc, control, code,
                             telemetry, n_win)

        def counted(what, want, *config, **kw):
            zero_counts()
            t0 = time.perf_counter()
            res = run(*config, **kw)
            secs = time.perf_counter() - t0
            got = counts()
            want = {name: want.get(name, 0) for name in names}
            if got != want:
                raise AssertionError(f"{label} {what}: launches {got}, "
                                     f"expected {want}")
            return res, got, secs

        fused_want = {"fleet_window": n_win, "adaptbf_alloc": n_win}
        mega_want = {"window_mega": n_win}
        fused, fused_launches, _ = counted("fused/pallas", fused_want,
                                           "fused", "pallas")
        t0 = time.perf_counter()
        plain = run("scan", "core")
        plain_secs = time.perf_counter() - t0
        check_main_path(torch, f"{label} fused/pallas", fused, inputs, cap_w,
                        n_win)
        check_main_path(torch, f"{label} scan/core", plain, inputs, cap_w,
                        n_win)
        first = first_window_err(fused, plain)
        if first > 1e-3:
            raise AssertionError(f"{label}: first window off by {first}")
        per_window, rel, same = compare_runs(
            torch, f"{label}: fused/pallas vs scan/core", fused, plain)
        print(f"{label} (O={o} J={j}, clusters of {c}), {n_win} windows: "
              f"fused/pallas launches {fused_launches}; vs plain scan/core: "
              f"first window max |err| {first}; alloc/record max |err| "
              f"{per_window}; horizon served per OST max rel err {rel}; "
              f"bitwise equal: {same}; invariants hold on both")
        del plain
        mega, mega_launches, _ = counted("mega", mega_want, "mega", "core")
        check_main_path(torch, f"{label} mega", mega, inputs, cap_w, n_win)
        per_window, rel, same = compare_runs(
            torch, f"{label}: mega vs fused/pallas", mega, fused)
        print(f"{label}: mega launches {mega_launches}; vs fused/pallas: "
              f"alloc/record max |err| {per_window}; horizon served per OST "
              f"max rel err {rel}; bitwise equal: {same}; invariants hold")
        del fused
        if label == "wide-16k":
            code = FLEET_CONTROL_CODES["adaptbf"]
            coded, _, _ = counted(f"coded, code {code}", mega_want, "mega",
                                  "core", "coded", code)
            for f in ("served", "demand", "alloc", "record", "queue_final"):
                if not torch.equal(getattr(coded, f), getattr(mega, f)):
                    raise AssertionError(f"{label}: coded (code {code}) "
                                         f"differs from direct in {f}")
            del coded
            stream, _, _ = counted("mega, streaming", mega_want, "mega",
                                   "core", telemetry="streaming")
            if not torch.equal(stream.queue_final, mega.queue_final):
                raise AssertionError(f"{label}: streaming mega's queue_final "
                                     "differs from the trajectory run's")
            if int(stream.stats.windows) != n_win:
                raise AssertionError(f"{label}: stats.windows "
                                     f"{int(stream.stats.windows)}")
            del stream
            print(f"{label}: coded (code {code}) under mega bitwise equal to "
                  f"direct adaptbf in served, demand, alloc, record, "
                  f"queue_final; streaming mega's queue_final equal to its "
                  f"trajectory run's, stats.windows {n_win}")
            # tenants: fleets of the first OSTs, per-fleet codes
            t_nodes, t_volume = (torch.as_tensor(x, device=dev) for x in
                                 wide_tenant_inputs(scn, WIDE_TENANT_F,
                                                    WIDE_TENANT_O))
            sub = slice(0, WIDE_TENANT_O)
            t_rates = inputs["rates"][:, sub].contiguous()
            t_cap, t_backlog = inputs["cap"][sub], inputs["backlog"][sub]
            cfg = FleetConfig(control="coded", serve_backend="mega",
                              alloc_backend="pallas")
            codes = WIDE_TENANT_CODES
            zero_counts()
            batched = simulate_tenants(cfg, t_nodes, t_rates, t_volume, t_cap,
                                       t_backlog, control_code=codes,
                                       n_windows=n_win, device=dev)
            torch.cuda.synchronize()
            got = counts()
            want = {name: 0 for name in names}
            want["window_mega"] = n_win * len(set(codes))
            if got != want:
                raise AssertionError(f"{label} tenants: launches {got}")
            for f, code_f in enumerate(codes):
                one = simulate_fleet(cfg, t_nodes[f], t_rates, t_volume[f],
                                     t_cap, t_backlog, control_code=code_f,
                                     n_windows=n_win, device=dev)
                tenant_leaves_equal(torch, batched, one, f, label)
            print(f"{label} tenants: {WIDE_TENANT_F} fleets x O="
                  f"{WIDE_TENANT_O} x J={j} under mega/pallas, codes {codes}, "
                  f"{n_win} windows: launches {got}; every fleet bitwise "
                  f"equal to its own simulate_fleet run")
            del batched, one, t_nodes, t_volume, t_rates
        del mega
        rates = {k: statistics.median(v) for k, v in
                 fleet_rates(torch, dev, inputs, n_win).items()}
        rates["scan/core"] = n_win / plain_secs
        print(f"{label} windows/s on {card} (kernel paths: median of 3 runs; "
              "plain: its one run): "
              + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))
        launches = {**fused_launches,
                    "window_mega": mega_launches["window_mega"]}
        out[label] = dict(o=o, j=j, c=c, windows=n_win, rates=rates,
                          launches=launches, inputs=inputs)
        del inputs, scn
    out["seconds"] = time.perf_counter() - t_phase
    return out


#: a fleet's kernel paths: (key, serve, alloc, the kernels each window
#: launches once)
FLEET_PATHS = (("fused/pallas", "fused", "pallas",
                ("fleet_window", "adaptbf_alloc")),
               ("mega/core", "mega", "core", ("window_mega",)))


def fleet_kernel_ms(fw_ops, alloc_ops, mega_ops, fw_args, al_args,
                    mega_args):
    """B1, B2 and B3 (adaptbf)'s milliseconds a call of the wrappers on
    phase 2's fixtures (``check_window_kernel``, ``check_alloc_kernel``,
    ``check_mega_kernel``; CUDA events, 20 calls, median of 5)."""
    return (cuda_ms(lambda: fw_ops.fleet_window_serve(*fw_args), reps=20),
            cuda_ms(lambda: alloc_ops.fleet_alloc(*al_args), reps=20),
            cuda_ms(lambda: mega_ops.mega_window_round(*mega_args), reps=20))


def fleet_rates(torch, dev, inputs, n_win, runs=3):
    """Windows/s of each kernel path of ``FLEET_PATHS`` on a fleet's
    inputs: ``runs`` runs of ``n_win`` windows each on the host's clock.
    Returns {path: [windows/s of each run, fastest first]}."""
    rates = {}
    for key, serve, alloc, _ in FLEET_PATHS:
        secs = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fleet_run(torch, dev, inputs, serve, alloc, n_windows=n_win)
            secs.append(time.perf_counter() - t0)
        rates[key] = [n_win / x for x in sorted(secs)]
    return rates


def trace_fleet_cell(torch, dev, label, inputs, o, j, n_win, card):
    """One run of each kernel path of ``FLEET_PATHS`` on a fleet's inputs
    under ``torch.profiler`` (``trace``): the device time a launch of each
    of its kernels inside the fleet's own windows, and the run's time on
    the host's clock, device busy time and idle share a window.  Each
    kernel launches once a window, so the profiler must see ``n_win``
    launches of each: where it saw fewer (it drops a few events), the path
    is traced once more, and if it is still short its busy time and idle
    share are None (not measured), since they lack the missed launches.
    Returns {path: {host_ms_per_window, busy_ms_per_window, idle_share,
    us_per_launch, launches_seen}}."""
    out = {}
    for key, serve, alloc, focus in FLEET_PATHS:
        for attempt in range(2):
            got = trace(torch, f"{label} {key}",
                        lambda: fleet_run(torch, dev, inputs, serve, alloc,
                                          n_windows=n_win),
                        what=f"{n_win} windows at O={o} J={j}", focus=focus)
            if got is None:
                break
            seen = {k: n for k, (n, _) in got[2].items()}
            whole = all(n == n_win for n in seen.values())
            if whole:
                break
            print(f"trace ({label} {key}): the profiler saw {seen} of the "
                  f"run's {n_win} launches a kernel; "
                  + ("tracing again" if attempt == 0 else
                     "device busy and idle share not measured"))
        if got is None:
            continue
        busy, idle, per = got
        wall = busy / max(1.0 - idle, 1e-9)  # the run's own clock
        us = {k: 1e3 * t / max(n, 1) for k, (n, t) in per.items()}
        out[key] = dict(host_ms_per_window=wall / n_win,
                        busy_ms_per_window=busy / n_win if whole else None,
                        idle_share=idle if whole else None,
                        us_per_launch=us, launches_seen=seen)
        print(f"trace ({label} {key}) on {card}: {wall / n_win:.4f} ms "
              "a window on the host's clock, "
              + (f"device busy {busy / n_win:.4f} ms a window, idle share "
                 f"{idle:.3f}; " if whole else
                 "device busy and idle share not measured; ")
              + ", ".join(f"{k} {v:.2f} us a launch ({seen[k]} seen)"
                          for k, v in us.items()))
    return out


def trace_wide(torch, dev, wide, card):
    """Phase 5 at the wide cells: ``trace_fleet_cell`` at each.  Frees the
    cells' inputs; fills ``wide[cell]["trace"]``."""
    for label, o, j, n_win in WIDE_CELLS:
        inputs = wide[label].pop("inputs")
        wide[label]["trace"] = trace_fleet_cell(torch, dev, label, inputs, o,
                                                j, n_win, card)
        del inputs
    torch.cuda.empty_cache()


def time_wide_cell(torch, fw_ops, alloc_ops, mega_ops, dev, o, j, label):
    """B1, B2 and B3 (adaptbf) on one window's seeded fixtures at a wide
    cell's shape (``window_case``, ``alloc_case`` at a capacity of 50000,
    whose floors overshoot and run the excess descent, ``mega_case``):
    allocations equal to the plain versions', two calls of B2 and B3
    bitwise equal, max |err| of the other fields; then each timed (CUDA
    events, 20 launches, median of 5; plain: 3 of 3) beside its bound.
    Returns {kernel: {ms, plain_ms, bound_ms, bound_by, max_abs_err}}."""
    from repro_torch.core.policies import get_policy
    host = window_case(o, j, W, seed=11)
    fw_args = [torch.as_tensor(x, device=dev) for x in host]
    host = alloc_case(o, j, seed=97, cap=50000.0)
    al_args = [torch.as_tensor(x, device=dev) for x in host]
    m_in, rng = mega_case(torch, get_policy("adaptbf"), o, j, W, seed=300,
                          dev=dev)
    ctx, cap_tick, backlog, queue, vol, alloc, held, pstate = m_in
    rates = torch.as_tensor(rng.integers(0, 3, (W, o, j)).astype(
        np.float32), device=dev)
    mega_args = (get_policy("adaptbf"), ctx, cap_tick, backlog, queue, vol,
                 alloc, held, pstate, rates)
    got = alloc_ops.fleet_alloc(*al_args)
    want = alloc_ops.fleet_alloc_ref(*al_args)[:3]
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"{label}: adaptbf_alloc allocations differ")
    if not all(torch.equal(a, b) for a, b in
               zip(got, alloc_ops.fleet_alloc(*al_args))):
        raise AssertionError(f"{label}: two adaptbf_alloc calls differ")
    mgot = mega_ops.mega_window_round(*mega_args)
    mwant = mega_ops.ref.mega_round_ref(*mega_args)
    if not torch.equal(mgot[8], mwant[8]):
        raise AssertionError(f"{label}: window_mega allocations differ")
    flat = lambda out: [*out[:7], *mega_ops._leaves(out[7]), out[8]]
    if not all(torch.equal(a, b) for a, b in zip(
            flat(mgot), flat(mega_ops.mega_window_round(*mega_args)))):
        raise AssertionError(f"{label}: two window_mega calls differ")
    errs = {
        "fleet_window": leaf_errs(torch, f"{label} fleet_window",
                                  fw_ops.fleet_window_serve(*fw_args),
                                  fw_ops.fleet_window_ref(*fw_args), 1e-4),
        "adaptbf_alloc": leaf_errs(torch, f"{label} adaptbf_alloc",
                                   got[1:], want[1:], 1e-3),
        "window_mega": leaf_errs(torch, f"{label} window_mega",
                                 flat(mgot), flat(mwant), 1e-3)}
    del got, want, mgot, mwant
    times = {
        "fleet_window": (
            cuda_ms(lambda: fw_ops.fleet_window_serve(*fw_args), reps=20),
            cuda_ms(lambda: fw_ops.fleet_window_ref(*fw_args), reps=3,
                    groups=3), bound_ms(*window_work(o, j, W))),
        "adaptbf_alloc": (
            cuda_ms(lambda: alloc_ops.fleet_alloc(*al_args), reps=20),
            cuda_ms(lambda: alloc_ops.fleet_alloc_ref(*al_args), reps=3,
                    groups=3), bound_ms(*alloc_work(o, j))),
        "window_mega": (
            cuda_ms(lambda: mega_ops.mega_window_round(*mega_args),
                    reps=20),
            cuda_ms(lambda: mega_ops.ref.mega_round_ref(*mega_args),
                    reps=3, groups=3), bound_ms(*mega_work(o, j, W)))}
    return {name: dict(ms=t[0], plain_ms=t[1], bound_ms=t[2][0],
                       bound_by=t[2][1], max_abs_err=errs[name])
            for name, t in times.items()}


def time_wide_kernels(torch, fw_ops, alloc_ops, mega_ops, dev, card, wide,
                      clusters, n_sm):
    """Phase 4 at the wide cells' shapes: ``time_wide_cell`` at each.
    Then what a cluster reduction costs against a block's: B1 with W=50
    ticks (two reductions a tick) at J=8192 on c * n rows (one block a
    row) and at J=8192 c on n rows (clusters of c), the same blocks of the
    same lanes in one wave (n clusters resident at once, c * n SMs at
    most), for c of 2 and 8.  Fills ``wide[cell]``."""
    for label, o, j, _ in WIDE_CELLS:
        wide[label]["kernels"] = k = time_wide_cell(
            torch, fw_ops, alloc_ops, mega_ops, dev, o, j, label)
        print(f"kernel times at {label} (O={o} J={j} W={W}, clusters of "
              f"{wide[label]['c']}) on {card}: "
              + "; ".join(f"{name} {t['ms']:.4f} ms (plain "
                          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f}"
                          f" ms by {t['bound_by']}; max |err| "
                          f"{t['max_abs_err']})" for name, t in k.items())
              + "; two calls of adaptbf_alloc and window_mega bitwise equal")
    wide["reduction_cost"] = cluster_reduction_cost(torch, fw_ops, dev, card,
                                                    clusters, n_sm)


def cluster_reduction_cost(torch, fw_ops, dev, card, clusters, n_sm):
    """What a cluster reduction costs against a block's: B1 with W=50
    ticks (two reductions a tick) at J=8192 on c * n rows (one block a
    row) and at J=8192 c on n rows (clusters of c), the same blocks of the
    same lanes in one wave (n clusters resident at once, c * n SMs at
    most), for c of 2 and 8.  Returns {c: (ms one block a row, ms over
    clusters, us a reduction more, n)}."""
    ticks, cost = 50, {}
    for c in (2, 8):
        n = min(clusters["fleet_window"][c], n_sm // c)
        one = [torch.as_tensor(x, device=dev)
               for x in window_case(c * n, 8192, ticks, seed=5)]
        wide_in = [torch.as_tensor(x, device=dev)
                   for x in window_case(n, 8192 * c, ticks, seed=5)]
        t1 = cuda_ms(lambda: fw_ops.fleet_window_serve(*one), reps=20)
        tc = cuda_ms(lambda: fw_ops.fleet_window_serve(*wide_in), reps=20)
        cost[c] = (t1, tc, (tc - t1) * 1e3 / (2 * ticks), n)
        del one, wide_in
    print(f"a cluster reduction against a block reduction on {card} "
          f"(fleet_window, W={ticks}, {2 * ticks} reductions a launch, the "
          "same blocks of 8192 lanes in one wave): "
          + "; ".join(f"c={c}, {cost[c][3]} clusters: {cost[c][0]:.4f} ms "
                      f"one block a row, {cost[c][1]:.4f} ms clusters of {c}, "
                      f"{cost[c][2]:.3f} us a reduction more"
                      for c in cost))
    return cost


def fleet_s1_sum_share(fw_ops, run) -> float:
    """``s1_sum_share`` over every window of ``run()``, a fleet run on the
    plain serve path (``serve_backend="scan"``), counted on the inputs each
    window hands ``fleet_window_ref`` (the run's own results unchanged)."""
    real, tally = fw_ops.fleet_window_ref, []

    def counting(*args):
        _, formed = fw_ops.ref.fleet_window_model(*args)
        tally.append((formed.sum(), formed.numel()))
        return real(*args)

    fw_ops.fleet_window_ref = counting
    try:
        run()
    finally:
        fw_ops.fleet_window_ref = real
    total = sum(n for _, n in tally)
    return sum(int(k) for k, _ in tally) / total if total else 0.0


def s1_sum_phase(torch, dev, fw_ops, fw_args, fw_ms, inputs, scn, tenants,
                 wide, card):
    """Phase 4: B1 at J=4096 (the main cell's 256 rows and the 16 tenant
    fleets' 4096) and at the wide cells, each beside the share of
    row-ticks whose tick formed the second row sum, sum(s1), counted from
    the plain path: on the timed fixture (``s1_sum_share``) and over the
    fleet's own run (``fleet_s1_sum_share``: the cell's fleet, 60 windows
    or wide-64k's 20, under plain scan/core; the tenants under coded
    control with their codes, streaming).  The wide cells' B1 bounds take
    their fixtures' share.  Returns {cell: {ms, fixture, fleet}}."""
    from repro_torch.storage import FleetConfig, simulate_tenants
    out = {}
    main_fleet = fleet_s1_sum_share(fw_ops, lambda: fleet_run(
        torch, dev, inputs, "scan", "core"))
    out[f"{O}x{J}"] = dict(ms=fw_ms, fixture=s1_sum_share(fw_ops, fw_args),
                           fleet=main_fleet)
    nodes, volume = (torch.as_tensor(x, device=dev)
                     for x in wide_tenant_inputs(scn, TENANT_F, O))
    _, made = fleet_launch_calls(torch, dev, TENANT_F, inputs["rates"][:W],
                                 inputs["cap"], nodes)
    cfg = FleetConfig(control="coded", serve_backend="scan",
                      alloc_backend="core", telemetry="streaming")

    def tenant_run():
        simulate_tenants(cfg, nodes, inputs["rates"], volume, inputs["cap"],
                         inputs["backlog"], control_code=TENANT_CODES,
                         n_windows=N_WINDOWS, device=dev)
        torch.cuda.synchronize()

    out[f"{TENANT_F * O}x{J}"] = dict(
        ms=tenants["wide_ms"][0], fixture=s1_sum_share(fw_ops, made[:6]),
        fleet=fleet_s1_sum_share(fw_ops, tenant_run))
    del nodes, volume, made
    for label, o, j, n_win in WIDE_CELLS:
        args = [torch.as_tensor(x, device=dev)
                for x in window_case(o, j, W, seed=11)]
        share = s1_sum_share(fw_ops, args)
        k = wide[label]["kernels"]["fleet_window"]
        k["bound_ms"], k["bound_by"] = bound_ms(*window_work(
            o, j, W, s1_share=share))
        out[label] = dict(ms=k["ms"], fixture=share,
                          fleet=fleet_s1_sum_share(fw_ops, lambda: fleet_run(
                              torch, dev, wide[label]["inputs"], "scan",
                              "core", n_windows=n_win)))
        del args
    torch.cuda.empty_cache()
    print(f"fleet_window and the second row sum on {card} (ms a call at "
          "the cell's fixture; the share of row-ticks that formed sum(s1), "
          "counted from the plain path on the fixture and over the cell's "
          "fleet run): "
          + "; ".join(f"{cell} {v['ms']:.4f} ms, fixture {v['fixture']:.4f}, "
                      f"fleet {v['fleet']:.4f}" for cell, v in out.items()))
    return out


def wide_entry(wide, name):
    """A fleet kernel's numbers at the wide cells for the kernel line,
    with its device time a launch inside the traced fleet run."""
    run = "mega/core" if name == "window_mega" else "fused/pallas"
    return {"wide": {label: {
        "cluster": wide[label]["c"],
        "launches": wide[label]["launches"][name],
        **wide[label]["kernels"][name],
        "trace_us_per_launch": wide[label].get("trace", {}).get(run, {})
        .get("us_per_launch", {}).get(name)} for label, *_ in WIDE_CELLS}}


# ------------------------------------------------------- the LM serving path


def close_err(got, want, tol):
    """max |got - want| (float64), after raising unless every element is
    within atol + rtol * |want| (atol = rtol = ``tol``, the reference's
    kernel-test rule) and both are finite."""
    g, w = got.double(), want.double()
    if not bool(g.isfinite().all()):
        raise AssertionError("non-finite kernel output")
    diff = (g - w).abs()
    if bool((diff > tol + tol * w.abs()).any()):
        raise AssertionError(f"off by {float(diff.max())} (atol = rtol = {tol})")
    return float(diff.max())


def _randn(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def check_attention_kernel(torch, attn_ops, dev):
    """B4 against its plain version, o and lse: causal at the prefill's
    shape in both types, non-causal GQA 8/2 at D=64, a ragged S=1000 at
    D=96; the edges of the 128-row tiles (S = 1, 63, 64, 65, 129), S != T
    non-causal, and head dims 16-128 under GQA 4, in both types.  Returns
    the prefill-shape bfloat16 inputs (for timing) and the largest error."""
    gen = torch.Generator(device=dev).manual_seed(41)
    both = ("float32", "bfloat16")
    cases = [(PREFILL_B, PREFILL_S, PREFILL_S, 32, 32, 80, True, dt)
             for dt in both]
    cases += [(1, 512, 512, 8, 2, 64, False, dt) for dt in both]
    cases += [(2, 1000, 1000, 4, 4, 96, True, dt) for dt in both]
    cases += [(1, s, s, 4, 4, 64, True, dt) for s in (1, 63, 64, 65, 129)
              for dt in both]
    cases += [(2, 100, 300, 8, 2, 80, False, dt) for dt in both]
    cases += [(2, 200, 200, 8, 2, d, True, dt) for d in (16, 64, 80, 96, 128)
              for dt in both]
    worst, timed = 0.0, None
    for b, s, t, hq, hkv, d, causal, name in cases:
        dt = getattr(torch, name)
        q = _randn(torch, gen, (b, s, hq, d), dt)
        k = _randn(torch, gen, (b, t, hkv, d), dt)
        v = _randn(torch, gen, (b, t, hkv, d), dt)
        o, lse = attn_ops.attention_lse(q, k, v, causal=causal)
        wo, wl = attn_ops.ref.mha_lse(q, attn_ops.ref.broadcast_kv(k, hq),
                                      attn_ops.ref.broadcast_kv(v, hq),
                                      causal=causal)
        e_o = close_err(o, wo, ATTN_TOL[name])
        e_l = close_err(lse, wl, ATTN_TOL[name])
        print(f"flash_attention kernel vs plain, B={b} S={s} T={t} Hq={hq} "
              f"Hkv={hkv} D={d} causal={causal} {name}: max |err| o {e_o}, "
              f"lse {e_l} (atol = rtol = {ATTN_TOL[name]})")
        worst = max(worst, e_o)
        if (s, name) == (PREFILL_S, "bfloat16"):
            timed = (q, k, v)
    return timed, worst


def check_decode_kernel(torch, attn_ops, dev):
    """B5 against its plain version: the engine's shape (4 slots, T=128,
    32 heads of 80) with lengths {1, 37, 128, 128} in both types, 8
    sequences of up to 32768 positions in bfloat16 (2.7 GB of KV), GQA
    8/2, and lengths {0, 1, L-1, L, L+1, T} around the host plan's split
    length L (GQA 8/2, D=128, both types).  The caches are views of fused
    [B, T, Hkv * D] buffers, as the model hands them.  Returns the
    engine-shape float32 inputs, the largest error and the 32768 case's
    times."""
    gen = torch.Generator(device=dev).manual_seed(43)
    n_sm = attn_ops._sm_count(dev.index or 0)
    split, _ = attn_ops.decode_split_plan(4096, 7, 8, 2, n_sm)
    around = (0, 1, split - 1, split, split + 1, 4096, 3)
    cases = [(128, 32, 32, 80, (1, 37, 128, 128), dt)
             for dt in ("float32", "bfloat16")]
    cases += [(32768, 32, 32, 80, (32768, 30000, 1, 17, 20000, 32767, 5000,
                                   12345), "bfloat16"),
              (1024, 8, 2, 64, (1024, 1, 500, 999), "float32")]
    cases += [(4096, 8, 2, 128, around, dt) for dt in ("float32", "bfloat16")]
    worst, timed, long = 0.0, None, None
    for t, hq, hkv, d, lens, name in cases:
        dt = getattr(torch, name)
        b = len(lens)
        q = _randn(torch, gen, (b, 1, hq, d), dt)
        kc = _randn(torch, gen, (b, t, hkv * d), dt).view(b, t, hkv, d)
        vc = _randn(torch, gen, (b, t, hkv * d), dt).view(b, t, hkv, d)
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = attn_ops.decode_attention(q, kc, vc, length)
        want = attn_ops.ref.decode_attention(
            q, attn_ops.ref.broadcast_kv(kc, hq),
            attn_ops.ref.broadcast_kv(vc, hq), length)
        err = close_err(got, want, ATTN_TOL[name])
        split_len, n_split = attn_ops.decode_split_plan(t, b, hq, hkv, n_sm)
        print(f"flash_decode kernel vs plain, B={b} T={t} Hq={hq} Hkv={hkv} "
              f"D={d} lengths {list(lens)} {name}, {n_split} split(s) of "
              f"{split_len} keys: max |err| {err} "
              f"(atol = rtol = {ATTN_TOL[name]})")
        worst = max(worst, err)
        if t == 128 and name == "float32":
            timed = (q, kc, vc, length)
        if t == 32768:
            # the long-cache case timed here, while its 2.7 GB are alive
            ms = cuda_ms(lambda: attn_ops.decode_attention(q, kc, vc, length),
                         reps=20)
            mask = (torch.arange(t, device=dev)[None, :]
                    < length[:, None])[:, None, None, :]
            lib = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=mask), reps=20)
            bnd, by = bound_ms(*decode_work(lens, hq, hkv, d, 2))
            group = hq // hkv
            grid = (n_split, hkv * -(-group // attn_ops.decode_heads_per_block(
                group)), b)
            blocks = grid[0] * grid[1] * grid[2]
            if blocks <= b * hkv:
                raise AssertionError(f"flash_decode at T={t}: {blocks} blocks, "
                                     f"not more than B x Hkv = {b * hkv}")
            print(f"flash_decode at B={b} T={t}: grid {grid} = {blocks} blocks "
                  f"(B x Hkv = {b * hkv}); {ms:.4f} ms, "
                  f"scaled_dot_product_attention {lib:.4f} ms, bound "
                  f"{bnd:.4f} ms by {by} on {_smi()}")
            long = {"ms_t32768": ms, "bound_ms_t32768": bnd,
                    "library_ms_t32768": lib}
        del q, kc, vc, got, want
    return timed, worst, long


def ssd_inputs(torch, gen, b, s, h, p, n, dt):
    x = _randn(torch, gen, (b, s, h, p), dt)
    dtt = torch.nn.functional.softplus(
        _randn(torch, gen, (b, s, h), torch.float32) - 1.0)
    a = -torch.exp(torch.rand(h, generator=gen, device=gen.device) * 1.5)
    B = (_randn(torch, gen, (b, s, n), torch.float32) * n ** -0.5).to(dt)
    C = (_randn(torch, gen, (b, s, n), torch.float32) * n ** -0.5).to(dt)
    d_skip = torch.linspace(0.5, 1.5, h, device=gen.device)
    return x, dtt, a, B, C, d_skip


def check_ssd_kernel(torch, ssd_ops, dev):
    """B6 against its plain version, y and final state, in both types: the
    prefill's shape (B=4, S=2048, 80 heads of P=64, N=64, chunks of 64), a
    ragged S=2000, S of 1, 63, 64, 65 and 129 over 5 heads (no full group
    of consumers), N=128 and P=32 at a batch of 1.  Returns the
    prefill-shape bfloat16 inputs and the largest error."""
    gen = torch.Generator(device=dev).manual_seed(47)
    both = ("float32", "bfloat16")
    cases = [(PREFILL_B, PREFILL_S, 80, 64, 64, dt) for dt in both]
    cases += [(2, 2000, 80, 64, 64, dt) for dt in both]
    cases += [(2, s, 5, 64, 64, dt) for s in (1, 63, 64, 65, 129)
              for dt in both]
    cases += [(1, 1000, 8, 64, 128, dt) for dt in both]
    cases += [(1, 1000, 8, 32, 64, dt) for dt in both]
    worst, timed = 0.0, None
    for b, s, h, p, n, name in cases:
        args = ssd_inputs(torch, gen, b, s, h, p, n, getattr(torch, name))
        y, st = ssd_ops.ssd(*args[:5], d_skip=args[5])
        wy, wst = ssd_ops.ref.ssd_chunked(*args[:5], d_skip=args[5])
        e_y = close_err(y, wy, SSD_TOL[name])
        e_s = close_err(st, wst, SSD_TOL[name])
        print(f"ssd_scan kernel vs plain, B={b} S={s} H={h} P={p} N={n} "
              f"{name}: max |err| y {e_y}, state {e_s} "
              f"(atol = rtol = {SSD_TOL[name]})")
        worst = max(worst, e_y, e_s)
        if (s, name) == (PREFILL_S, "bfloat16"):
            timed = args
    return timed, worst


def check_ssd_warm_start(torch, ssd_ops, dev):
    """B6 warm-started from a seeded ``initial_state`` [B, H, P, N]
    (float32; the kernel rounds it to x's type, as the reference's oracle
    casts it) against ``ref.ssd_chunked(initial_state=...)``, y and the
    final state, in both types, at the prefill's shape and at S of 1 and
    65; each call must launch the kernel once.  Returns the largest
    error."""
    gen = torch.Generator(device=dev).manual_seed(53)
    worst = 0.0
    for b, s, name in [(PREFILL_B, PREFILL_S, dt) for dt in SSD_TOL] + [
            (2, s, dt) for s in (1, 65) for dt in SSD_TOL]:
        h, p, n = 80, 64, 64
        args = ssd_inputs(torch, gen, b, s, h, p, n, getattr(torch, name))
        h0 = _randn(torch, gen, (b, h, p, n), torch.float32)
        before = ssd_ops.launches
        y, st = ssd_ops.ssd(*args[:5], d_skip=args[5], initial_state=h0)
        if ssd_ops.launches != before + 1:
            raise AssertionError("warm-started ssd did not launch the kernel")
        wy, wst = ssd_ops.ref.ssd_chunked(*args[:5], d_skip=args[5],
                                          initial_state=h0)
        e_y = close_err(y, wy, SSD_TOL[name])
        e_s = close_err(st, wst, SSD_TOL[name])
        print(f"ssd_scan kernel vs plain, warm-started, B={b} S={s} H={h} "
              f"P={p} N={n} {name}: max |err| y {e_y}, state {e_s} "
              f"(atol = rtol = {SSD_TOL[name]})")
        worst = max(worst, e_y, e_s)
    return worst


def attention_work(b, s, h, d, elem):
    """(bytes, operations) of causal attention: q, k, v read and o written
    once, lse [B,S,H] float32 written once; 2*B*H*S^2*D operations (the
    QK^T and PV products over the causal half)."""
    return elem * 4 * b * s * h * d + 4 * b * s * h, 2 * b * h * s * s * d


def decode_work(lengths, hq, hkv, d, elem):
    """(bytes, operations) of one-token attention: the K and V rows below
    each length read once, q read and o written once; 4*D operations a key
    and query head."""
    keys = sum(lengths)
    return (elem * (2 * keys * hkv * d + 2 * len(lengths) * hq * d),
            4 * keys * hq * d)


def ssd_work(b, s, h, p, n, elem, q=64):
    """(bytes, operations) of the chunked scan: x, B, C read and y written
    once in the compute type, dt read and the state written once in
    float32; NC (2 Q^2 N + 2 Q^2 P + 4 Q N P) operations a (sequence,
    head)."""
    nc = -(-s // q)
    n_bytes = elem * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h
                                                                + b * h * n * p)
    return n_bytes, b * h * nc * (2 * q * q * n + 2 * q * q * p + 4 * q * n * p)


def lm_main_path(torch, dev, counts, zero_counts):
    """zamba2-2.7b at full width on seeded weights: the prefill step (bf16)
    on the kernels and on the plain path, and in float32 both ways and a
    float64 plain run as the yardsticks; then the launcher's serving
    workload through ServingEngine and AdapTBFController (float32), the
    plain path teacher-forced on the kernel run's inputs.  Returns the
    numbers for the report."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels.window_mega.ops import _leaves
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.storage import AdapTBFController
    cfg = get_config(LM_ARCH)
    out = {}
    t0 = time.perf_counter()
    params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in _leaves(params))
    print(f"{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, {cfg.ssm_heads} SSD heads of "
          f"P={cfg.ssm_head_dim} N={cfg.ssm_state}; {n_params} parameters "
          f"(analytic param_count {cfg.param_count()}), float32 on the card from "
          f"torch.Generator(0) in {time.perf_counter() - t0:.1f} s")

    # prefill ------------------------------------------------------------
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S)), device=dev)
    batch = {"tokens": tokens}
    logits = {}
    torch.cuda.reset_peak_memory_stats()
    for name in ("bfloat16", "float32"):
        dt = getattr(torch, name)
        w = models.cast_params(params, dt)
        for kernels in (True, False):
            step = make_prefill_step(cfg, compute_dtype=dt, kernels=kernels)
            zero_counts()
            t0 = time.perf_counter()
            lg = step(w, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = counts()
            want = ({"flash_attention": cfg.n_layers // cfg.shared_attn_every,
                     "ssd_scan": cfg.n_layers} if kernels else {})
            nonzero = {k: v for k, v in got.items() if v}
            if nonzero != want:
                raise AssertionError(f"prefill ({name}, kernels={kernels}): "
                                     f"launches {got}, expected {want}")
            if tuple(lg.shape) != (PREFILL_B, 1, cfg.vocab) or \
                    not bool(lg.isfinite().all()):
                raise AssertionError("prefill logits malformed")
            logits[(name, kernels)] = lg[:, -1].double()
            label = "kernel" if kernels else "plain"
            print(f"prefill step, {name}, {label} path, B={PREFILL_B} "
                  f"S={PREFILL_S}: launches {got}; first call {secs:.3f} s")
            if name == "bfloat16":
                out[f"prefill_launches_{label}"] = got
                # steady-state time: the kernel path three times, the slow
                # plain path once
                reps = 3 if kernels else 1
                t0 = time.perf_counter()
                for _ in range(reps):
                    step(w, batch)
                torch.cuda.synchronize()
                out[f"prefill_tok_s_{label}"] = (
                    reps * PREFILL_B * PREFILL_S / (time.perf_counter() - t0))
                if kernels:   # phase 5: where a prefill step's time goes
                    trace(torch, "prefill step, bfloat16, kernel path",
                          lambda: (step(w, batch), torch.cuda.synchronize()),
                          what="one step", top=12,
                          focus=("flash_attention", "ssd_scan"))
        del w
    out["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ref32 = logits[("float32", False)]
    scale = float(ref32.abs().max())
    e32 = float((logits[("float32", True)] - ref32).abs().max())
    if e32 > 1e-3 * max(1.0, scale):
        raise AssertionError(f"float32 prefill: kernel path off the plain "
                             f"path by {e32} (max |logit| {scale})")
    # the float64 plain path as the witness: the float32 kernel path's error
    # against it within 1.25x (mean) and 2x (max) the float32 plain path's
    w = models.cast_params(params, torch.float64)
    ref64 = make_prefill_step(cfg, compute_dtype=torch.float64,
                              kernels=False)(w, batch)[:, -1].double()
    del w
    ours64 = (logits[("float32", True)] - ref64).abs()
    theirs64 = (ref32 - ref64).abs()
    w64 = tuple(float(v) for v in (ours64.mean(), ours64.max(),
                                   theirs64.mean(), theirs64.max()))
    print(f"prefill float32 (max |logit| {scale:.3f}): kernel vs plain max "
          f"|err| {e32} (bound 1e-3 x max(1, max |logit|) = "
          f"{1e-3 * max(1.0, scale):.4g}); against the float64 plain path, "
          f"kernel path mean/max |err| {w64[0]:.4g}/{w64[1]:.4g}, plain path "
          f"{w64[2]:.4g}/{w64[3]:.4g} (bound: mean within 1.25x, max within "
          f"2x)")
    if w64[0] > 1.25 * w64[2] or w64[1] > 2 * w64[3]:
        raise AssertionError("float32 prefill: the kernel path is farther "
                             "from the float64 logits than the plain path")
    out.update(prefill_err_f32_vs_f64=w64)
    k16, p16 = logits[("bfloat16", True)], logits[("bfloat16", False)]
    e16 = float((k16 - p16).abs().max())
    ours, theirs = (k16 - ref32).abs(), (p16 - ref32).abs()
    if ours.mean() > 1.25 * theirs.mean() or ours.max() > 2 * theirs.max():
        raise AssertionError(
            f"bfloat16 prefill: the kernel path is farther from the float32 "
            f"logits (mean {float(ours.mean())}, max {float(ours.max())}) "
            f"than the plain path (mean {float(theirs.mean())}, max "
            f"{float(theirs.max())})")
    agree16 = float((k16.argmax(-1) == p16.argmax(-1)).double().mean())
    print(f"prefill last-token logits (max |logit| {scale:.3f}): float32 "
          f"kernel vs plain max |err| {e32}; bfloat16 kernel vs plain max "
          f"|err| {e16}, argmax agreement {agree16}; against the float32 "
          f"plain logits, bfloat16 kernel path mean/max |err| "
          f"{float(ours.mean()):.5f}/{float(ours.max()):.5f}, bfloat16 "
          f"plain path "
          f"{float(theirs.mean()):.5f}/{float(theirs.max()):.5f} (bound: "
          f"mean within 1.25x, max within 2x)")
    out.update(prefill_err_bf16=e16, prefill_err_f32=e32,
               prefill_argmax_agree=agree16)

    # serving ------------------------------------------------------------
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, cfg.vocab, SERVE["prompt"]).tolist(),
             "interactive" if i % 2 == 0 else "batch")
            for i in range(SERVE["requests"])]

    def serve(record=None):
        ctl = AdapTBFController(n_targets=1, capacity_rpc_per_s=2000,
                                window_s=0.05, device=dev)
        eng = ServingEngine(cfg, params, slots=SERVE["slots"],
                            max_len=SERVE["max_len"], controller=ctl,
                            classes={"interactive": 3.0, "batch": 1.0})
        reqs = [Request(prompt=p, max_new_tokens=SERVE["max_new"], klass=k)
                for p, k in work]
        for r in reqs:
            eng.submit(r)
        decode = models.decode_step
        if record is not None:
            def recording(p, cache, cfg_, tokens, pos, **kw):
                lg, cache = decode(p, cache, cfg_, tokens, pos, **kw)
                record.append((tokens.clone(), pos.clone(), lg[:, -1].clone()))
                return lg, cache
            models.decode_step = recording
        try:
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            models.decode_step = decode
        return reqs, done, secs, ctl

    steps_in = []
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    reqs, done, secs, ctl = serve(steps_in)
    got = counts()
    n_steps = len(steps_in)
    want = {"flash_decode": n_steps * (cfg.n_layers // cfg.shared_attn_every)}
    if {k: v for k, v in got.items() if v} != want:
        raise AssertionError(f"engine: launches {got}, expected {want}")
    if len(done) != len(reqs) or any(len(r.output) != SERVE["max_new"]
                                     for r in reqs):
        raise AssertionError(f"engine answered {len(done)}/{len(reqs)}")
    n_tok = sum(len(r.output) for r in reqs)
    out.update(engine_launches=got, engine_steps=n_steps,
               engine_tok_s=n_tok / secs, engine_answered=len(done),
               engine_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               engine_windows=ctl.windows_run)
    print(f"engine ({LM_ARCH}, float32, {SERVE}): answered "
          f"{len(done)}/{len(reqs)}, {n_tok} tokens in {n_steps} steps, "
          f"{secs:.3f} s ({n_tok / secs:.2f} generated tokens/s); AdapTBF "
          f"windows {ctl.windows_run}; launches {got}; peak device memory "
          f"{out['engine_peak_gib']:.2f} GiB")

    # the plain path, teacher-forced on the kernel run's inputs
    cache = models.init_cache(cfg, SERVE["slots"], SERVE["max_len"],
                              dtype=torch.float32, device=dev)
    worst, agree = 0.0, []
    zero_counts()
    for t, (tok, pos, lg) in enumerate(steps_in):
        plg, cache = models.decode_step(params, cache, cfg, tok, pos,
                                        dtype=torch.float32, kernels=False)
        plg = plg[:, -1]
        e = float((plg.double() - lg.double()).abs().max())
        bound = 1e-3 * max(1.0, float(plg.abs().max()))
        if e > bound:
            raise AssertionError(f"engine step {t}: kernel path off the "
                                 f"plain path by {e} > {bound}")
        worst = max(worst, e)
        agree.append(float((plg.argmax(-1) == lg.argmax(-1)).double().mean()))
    if any(counts().values()):
        raise AssertionError(f"plain replay launched kernels: {counts()}")
    out.update(engine_err=worst, engine_argmax_agree=float(np.mean(agree)))
    print(f"engine, plain path teacher-forced over the {n_steps} steps: "
          f"logits max |err| {worst} (bound 1e-3 x max(1, max |logit|) a "
          f"step), argmax agreement {np.mean(agree)}")

    trace(torch, "engine", lambda: serve(), what=f"{n_steps} steps",
          focus=("flash_decode",))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params
    return out


# ---------------------------------------------------- the LM training path


def attention_bwd_work(b, s, h, d, elem):
    """(bytes, operations) of causal attention's backward: q, k, v, o and
    dO read and dq, dk, dv written once, lse [B,S,H] float32 read once;
    five products of 2*B*H*S^2*D/2 (S and dP, dV, dK, dQ over the causal
    half)."""
    return (elem * 8 * b * s * h * d + 4 * b * s * h,
            5 * 2 * b * h * s * s * d // 2)


def check_attention_bwd_kernel(torch, attn_ops, dev):
    """B4's backward against its plain version (``ref.gqa_bwd``), dq, dk
    and dv: the training shape (B=4, S=2048, 32 heads of 80, causal) in
    both types; GQA 32/8, non-causal, S not a multiple of the 64-row tiles,
    D of 64 and 128, B=1.  float32 within 1e-4 x max(1, max |g|); bfloat16
    no farther from the float32 plain gradients than the bfloat16 plain
    version is (mean within 1.25x, max within 2x).  Each call launches the
    kernel once; two calls are bitwise equal (no atomics).  Returns the
    training-shape bfloat16 inputs and the largest float32 error relative
    (absolute) error."""
    gen = torch.Generator(device=dev).manual_seed(59)
    both = ("float32", "bfloat16")
    cases = [(TRAIN_B, TRAIN_S, TRAIN_S, 32, 32, 80, True, dt) for dt in both]
    cases += [(1, 1024, 1024, 32, 8, 80, True, dt) for dt in both]
    cases += [(2, 300, 500, 8, 8, 64, False, dt) for dt in both]
    cases += [(1, 1000, 1000, 8, 2, 80, True, dt) for dt in both]
    cases += [(2, 200, 200, 8, 2, d, True, dt) for d in (64, 128)
              for dt in both]
    worst, timed = 0.0, None
    for b, s, t, hq, hkv, d, causal, name in cases:
        dt = getattr(torch, name)
        q = _randn(torch, gen, (b, s, hq, d), dt)
        k = _randn(torch, gen, (b, t, hkv, d), dt)
        v = _randn(torch, gen, (b, t, hkv, d), dt)
        do = _randn(torch, gen, (b, s, hq, d), dt)
        o, lse = attn_ops.attention_lse(q, k, v, causal=causal)
        before = attn_ops.launches["flash_attention_bwd"]
        got = attn_ops.attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = attn_ops.attention_bwd(q, k, v, o, lse, do, causal=causal)
        if attn_ops.launches["flash_attention_bwd"] != before + 2 and dev.type == "cuda":
            raise AssertionError("attention_bwd did not launch its kernel")
        if not all(bool(torch.equal(x, y)) for x, y in zip(got, again)):
            raise AssertionError("attention_bwd is not deterministic")
        want = attn_ops.ref.gqa_bwd(q, k, v, o, lse, do, causal)
        label = (f"flash_attention_bwd kernel vs plain, B={b} S={s} T={t} "
                 f"Hq={hq} Hkv={hkv} D={d} causal={causal} {name}")
        if name == "float32":
            errs = []
            for g, w in zip(got, want):
                if not bool(g.isfinite().all()):
                    raise AssertionError(f"{label}: non-finite gradient")
                e = float((g.double() - w.double()).abs().max())
                worst = max(worst, e)
                errs.append(e / max(1.0, float(w.abs().max())))
            if max(errs) > 1e-4:
                raise AssertionError(f"{label}: off by {errs} x max(1, "
                                     "max |g|) (bound 1e-4)")
            print(f"{label}: max |err| / max(1, max |g|) dq {errs[0]:.3g}, "
                  f"dk {errs[1]:.3g}, dv {errs[2]:.3g} (bound 1e-4)")
        else:
            f32 = [x.float() for x in (q, k, v, do)]
            o32, lse32 = attn_ops.ref.mha_lse(
                f32[0], attn_ops.ref.broadcast_kv(f32[1], hq),
                attn_ops.ref.broadcast_kv(f32[2], hq), causal=causal)
            w32 = attn_ops.ref.gqa_bwd(f32[0], f32[1], f32[2], o32, lse32,
                                       f32[3], causal)
            parts = []
            for n, g, w, r in zip("qkv", got, want, w32):
                ours, theirs = (g.double() - r).abs(), (w.double() - r).abs()
                if not bool(g.isfinite().all()) or \
                        ours.mean() > 1.25 * theirs.mean() or \
                        ours.max() > 2 * theirs.max():
                    raise AssertionError(
                        f"{label}: d{n} farther from the float32 plain "
                        f"gradient (mean {float(ours.mean())}, max "
                        f"{float(ours.max())}) than the bfloat16 plain path "
                        f"(mean {float(theirs.mean())}, max "
                        f"{float(theirs.max())})")
                parts.append(f"d{n} {float(ours.mean()):.3g}/"
                             f"{float(ours.max()):.3g} vs plain "
                             f"{float(theirs.mean()):.3g}/"
                             f"{float(theirs.max()):.3g}")
            print(f"{label}: mean/max |err| against the float32 plain "
                  f"gradients: " + "; ".join(parts)
                  + " (bound: mean within 1.25x, max within 2x)")
            if s == TRAIN_S:
                timed = (q, k, v, o, lse, do)
        del q, k, v, do, o, lse, got, again, want
    return timed, worst


def ssd_bwd_work(b, s, h, p, n, elem, q=64):
    """(bytes, operations) of the SSD backward: x, gy, B, C read and dx, dB,
    dC written once in the compute type, dt read and ddt written once in
    float32; per chunk of a (sequence, head) the needed products: the
    states again (2 Q N P), the scores and dw (2 Q^2 N, 2 Q^2 P), d(xw),
    dC and dB of the quadratic form (2 Q^2 P, 4 Q^2 N), and four state
    products (8 Q N P): 6 Q^2 N + 4 Q^2 P + 10 Q N P, about 2.5 times the
    forward's."""
    nc = -(-s // q)
    n_bytes = elem * (3 * b * s * h * p + 4 * b * s * n) + 4 * 2 * b * s * h
    return n_bytes, b * h * nc * (6 * q * q * n + 4 * q * q * p
                                  + 10 * q * n * p)


def ssd_autograd(torch, ssd_ops, args, gy, gs):
    """The gradients of ``ref.ssd_chunked`` by autograd (the oracle), one
    for each input (None where the input is None; zeros where it is
    unused)."""
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in args]
    y, st = ssd_ops.ref.ssd_chunked(*leaves[:5], d_skip=leaves[5],
                                    initial_state=leaves[6])
    outs = [(o, g.to(o.dtype)) for o, g in ((y, gy), (st, gs))
            if g is not None]
    idx = [i for i, t in enumerate(leaves) if t is not None]
    got = torch.autograd.grad([o for o, _ in outs], [leaves[i] for i in idx],
                              [g for _, g in outs], allow_unused=True)
    out = [None] * 7
    for i, g in zip(idx, got):
        out[i] = torch.zeros_like(leaves[i]) if g is None else g
    return out


def check_ssd_bwd_kernel(torch, ssd_ops, dev):
    """B6-bwd against autograd of ``ref.ssd_chunked`` on the card, every
    gradient (dx, ddt, da, dB, dC, d(d_skip), d(initial_state)): the
    training shape (B=4, S=2048, 80 heads of P=64, N=64) in both types,
    S=1000 and S=1, a warm start, ``d_skip=None``, gy only, gstate only,
    P=16 with N=128.  float32 within 1e-4 x max(1, max |g|) a gradient;
    bfloat16 no farther from the float32 autograd gradients than the
    bfloat16 plain path's autograd (mean within 1.25x, max within 2x).
    Each call launches the kernel once (bfloat16: the walk, the chunk
    kernel and the reduction; float32: the scan and the reduction); two
    calls are bitwise equal.  Returns the training-shape
    bfloat16 inputs and the largest float32 absolute error."""
    gen = torch.Generator(device=dev).manual_seed(61)
    names = ("dx", "ddt", "da", "dB", "dC", "dD", "dh0")
    both = ("float32", "bfloat16")
    # (b, s, h, p, n, warm start, d_skip, gy, gstate)
    cases = [(TRAIN_B, TRAIN_S, 80, 64, 64, False, True, True, False, dt)
             for dt in both]
    cases += [(2, 1000, 8, 64, 64, True, True, True, True, dt) for dt in both]
    cases += [(2, 1, 8, 64, 64, True, True, True, True, dt) for dt in both]
    cases += [(2, 300, 8, 64, 64, False, False, True, True, dt)
              for dt in both]
    cases += [(2, 300, 8, 64, 64, True, True, True, False, dt) for dt in both]
    cases += [(2, 300, 8, 64, 64, True, True, False, True, dt) for dt in both]
    cases += [(2, 300, 8, 16, 128, True, True, True, True, dt) for dt in both]
    worst, timed = 0.0, None
    for b, s, h, p, n, warm, skip, use_gy, use_gs, name in cases:
        dt = getattr(torch, name)
        x, dtt, a, B, C, d = ssd_inputs(torch, gen, b, s, h, p, n, dt)
        h0 = _randn(torch, gen, (b, h, p, n), torch.float32) if warm else None
        gy = _randn(torch, gen, (b, s, h, p), dt) if use_gy else None
        gs = (_randn(torch, gen, (b, h, p, n), torch.float32) if use_gs
              else None)
        args = [x, dtt, a, B, C, d if skip else None, h0]
        before = ssd_ops.launches_bwd
        got = ssd_ops.ssd_bwd(*args, gy=gy, gstate=gs)
        again = ssd_ops.ssd_bwd(*args, gy=gy, gstate=gs)
        if ssd_ops.launches_bwd != before + 2:
            raise AssertionError("ssd_bwd did not launch its kernel")
        for nm, g, g2, t in zip(names, got, again, args):
            if (g is None) != (t is None):
                raise AssertionError(f"ssd_bwd: {nm} given for a None input "
                                     "or missing")
            if g is not None and not bool(torch.equal(g, g2)):
                raise AssertionError(f"ssd_bwd is not deterministic ({nm})")
        want = ssd_autograd(torch, ssd_ops, args, gy, gs)
        label = (f"ssd_scan_bwd kernel vs autograd of the plain scan, B={b} "
                 f"S={s} H={h} P={p} N={n} warm={warm} d_skip={skip} "
                 f"gy={use_gy} gstate={use_gs} {name}")
        if name == "float32":
            errs = {}
            for nm, g, w in zip(names, got, want):
                if g is None:
                    continue
                if not bool(g.isfinite().all()):
                    raise AssertionError(f"{label}: non-finite {nm}")
                e = float((g.double() - w.double()).abs().max())
                worst = max(worst, e)
                errs[nm] = e / max(1.0, float(w.abs().max()))
            if max(errs.values()) > 1e-4:
                raise AssertionError(f"{label}: off by {errs} x max(1, "
                                     "max |g|) (bound 1e-4)")
            print(f"{label}: max |err| / max(1, max |g|) "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + " (bound 1e-4)")
        else:
            # the float32 yardstick of the bfloat16 function: its inputs
            # as float32, the warm start rounded to x's type as the scan
            # casts it
            f32 = [None if t is None else t.float() for t in args]
            if h0 is not None:
                f32[6] = h0.to(dt).float()
            w32 = ssd_autograd(torch, ssd_ops, f32,
                               None if gy is None else gy.float(), gs)
            parts = []
            for nm, g, w, r in zip(names, got, want, w32):
                if g is None:
                    continue
                ours, theirs = (g.double() - r.double()).abs(), \
                    (w.double() - r.double()).abs()
                if not bool(g.isfinite().all()) or \
                        float(ours.mean()) > 1.25 * float(theirs.mean()) \
                        + 1e-12 or \
                        float(ours.max()) > 2 * float(theirs.max()) + 1e-12:
                    raise AssertionError(
                        f"{label}: {nm} farther from the float32 gradient "
                        f"(mean {float(ours.mean())}, max {float(ours.max())})"
                        f" than the bfloat16 plain path (mean "
                        f"{float(theirs.mean())}, max {float(theirs.max())})")
                parts.append(f"{nm} {float(ours.mean()):.3g}/"
                             f"{float(ours.max()):.3g} vs plain "
                             f"{float(theirs.mean()):.3g}/"
                             f"{float(theirs.max()):.3g}")
            print(f"{label}: mean/max |err| against the float32 autograd "
                  "gradients: " + "; ".join(parts)
                  + " (bound: mean within 1.25x, max within 2x)")
            if s == TRAIN_S:
                timed = (args, gy)
        del x, dtt, a, B, C, d, h0, gy, gs, args, got, again, want
    return timed, worst


def lm_train_path(torch, dev, counts, zero_counts, card):
    """zamba2-2.7b training at full width and depth on weights from
    ``torch.Generator(0)`` and the batch of ``TokenPipeline(32000, 2048,
    4)``: (a) ``loss_fn`` forward and backward in float32, kernel path
    against plain path and each against a float64 plain run; (b) the same
    in bfloat16 against the float32 plain gradients, held to the bfloat16
    plain path's own error; (c) five
    ``make_train_step`` steps (bfloat16 compute, float32 masters, AdamW in
    place), each launching B4 forward 18 times, its backward 9
    times, B6 108 times and B6's backward 54 times; then one step under the
    profiler (phase 5).  Returns the numbers for the report."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.ssd.ops import (BACKWARD_RANGE,
                                             KERNEL_BACKWARD_RANGE)
    from repro_torch.launch import steps
    from repro_torch.pytree import leaves_with_paths
    cfg = get_config(LM_ARCH)
    n_attn = cfg.n_layers // cfg.shared_attn_every
    want_k = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
              "ssd_scan": 2 * cfg.n_layers, "ssd_scan_bwd": cfg.n_layers}
    out = {}
    gib = 2**30
    print(f"training {LM_ARCH} at B={TRAIN_B} S={TRAIN_S}, remat "
          f"{cfg.remat!r}; memory reckoned before the run: float32 params "
          f"{cfg.param_count() * 4 / 1e9:.1f} GB, gradients the same, m and "
          f"v {cfg.param_count() * 8 / 1e9:.1f} GB, the bfloat16 cast "
          f"{cfg.param_count() * 2 / 1e9:.1f} GB, activations under remat "
          f"a few GB: about 45-55 GB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.0f}")
    torch.cuda.reset_peak_memory_stats()
    params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    pipe = TokenPipeline(cfg.vocab, TRAIN_S, TRAIN_B)

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    batch = on_card(pipe.batch(0))
    paths = [p for p, _ in leaves_with_paths(params)]

    def loss_and_grads(dtype, kernels, weights=None):
        """(loss, gradient leaves, seconds) of one loss_fn forward and
        backward at ``weights`` (default ``params``), its launches
        checked."""
        zero_counts()
        t0 = time.perf_counter()
        loss, grads = steps._value_and_grad(
            lambda p, b: models.loss_fn(p, cfg, b, dtype=dtype,
                                        kernels=kernels),
            params if weights is None else weights, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: v for k, v in counts().items() if v}
        want = want_k if kernels else {}
        if got != want:
            raise AssertionError(f"loss_fn ({dtype}, kernels={kernels}): "
                                 f"launches {got}, expected {want}")
        loss = float(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"loss_fn ({dtype}, kernels={kernels}): "
                                 f"loss {loss}")
        print(f"loss_fn forward and backward, {str(dtype)[6:]}, "
              f"{'kernel' if kernels else 'plain'} path: loss "
              f"{loss:.6f}, launches {got}, {secs:.3f} s")
        return loss, [g for _, g in leaves_with_paths(grads)], secs

    def against(grads, want):
        """(mean |err| over every element, max |err|, and the worst leaf's
        max |err| / max(1, max |want|) with its path) of ``grads`` against
        ``want``."""
        total, top, n, worst = 0.0, 0.0, 0, (0.0, "")
        for path, a, b in zip(paths, grads, want):
            if not bool(a.isfinite().all()):
                raise AssertionError(f"gradient {path} not finite")
            d = (a.double() - b.double()).abs()
            total, top, n = total + float(d.sum()), max(top, float(d.max())), \
                n + d.numel()
            top_b = max(1.0, float(b.abs().max()))
            worst = max(worst, (float(d.max()) / top_b, path))
        return total / n, top, worst

    # (a) float32 at init_params' weights, kernel path against plain path,
    # and each against the float64 plain path (the witness): the kernel
    # path's gradients within 1.25x (mean) and 2x (worst leaf) the float32
    # plain path's own error
    w = models.common.map_tree(lambda t: t.double(), params)
    l_64, g_64, _ = loss_and_grads(torch.float64, False, w)
    del w
    l_32, g_32, _ = loss_and_grads(torch.float32, False)
    theirs64 = against(g_32, g_64)
    l_k, g_k, _ = loss_and_grads(torch.float32, True)
    ours64 = against(g_k, g_64)
    worst = against(g_k, g_32)[2]
    del g_k, g_64
    rel = abs(l_k - l_32) / abs(l_32)
    print(f"float32 loss_fn, kernel vs plain path: loss rel err {rel:.3g} "
          f"(bound 1e-4); worst gradient leaf {worst[1]}: max |err| / max(1, "
          f"max |g|) {worst[0]:.3g} over {len(paths)} leaves.  Against the "
          f"float64 plain path (loss {l_64:.6f}): kernel path gradients mean "
          f"|err| {ours64[0]:.4g}, worst leaf {ours64[2][1]} "
          f"{ours64[2][0]:.4g}; plain path {theirs64[0]:.4g}, worst leaf "
          f"{theirs64[2][1]} {theirs64[2][0]:.4g} (bound: mean within "
          f"1.25x, worst leaf within 2x)")
    if rel > 1e-4:
        raise AssertionError("float32 loss_fn: kernel path's loss off the "
                             "plain path's")
    if ours64[0] > 1.25 * theirs64[0] or ours64[2][0] > 2 * theirs64[2][0]:
        raise AssertionError("float32 loss_fn: the kernel path's gradients "
                             "are farther from float64 than the plain path's")
    out.update(train_f32_loss_rel=rel, train_f32_grad_err=worst,
               train_f32_vs_f64=(ours64[0], ours64[2], theirs64[0],
                                 theirs64[2]))

    # (b) bfloat16, held to the bfloat16 plain path's own error
    def against_f32(grads):
        return against(grads, g_32)[:2]

    l_k16, g, _ = loss_and_grads(torch.bfloat16, True)
    ours = against_f32(g)
    del g
    l_p16, g, _ = loss_and_grads(torch.bfloat16, False)
    theirs = against_f32(g)
    del g, g_32
    print(f"bfloat16 loss_fn against the float32 plain path (loss "
          f"{l_32:.6f}): kernel path loss {l_k16:.6f}, gradients mean/max "
          f"|err| {ours[0]:.4g}/{ours[1]:.4g}; plain path loss {l_p16:.6f}, "
          f"{theirs[0]:.4g}/{theirs[1]:.4g} (bound: mean within 1.25x, max "
          f"within 2x)")
    if ours[0] > 1.25 * theirs[0] or ours[1] > 2 * theirs[1]:
        raise AssertionError("bfloat16 loss_fn: the kernel path's gradients "
                             "are farther from float32 than the plain path's")
    out.update(train_bf16_err=ours, train_bf16_plain_err=theirs)
    out["grad_peak_gib"] = torch.cuda.max_memory_allocated() / gib

    # (c) five train steps: bfloat16 compute, float32 masters, AdamW
    torch.cuda.reset_peak_memory_stats()
    state = steps.TrainState(params, steps.adamw_init(params))
    del params
    step_fn = steps.make_train_step(cfg)
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        b = on_card(pipe.batch(i))
        zero_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = {k: v for k, v in counts().items() if v}
        if got != want_k:
            raise AssertionError(f"train step {i}: launches {got}, expected "
                                 f"{want_k}")
        losses.append(float(metrics["loss"]))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"train step {i}: loss {losses[-1]}")
    for path, x in leaves_with_paths(state):
        if x.is_floating_point() and not bool(x.isfinite().all()):
            raise AssertionError(f"after {TRAIN_STEPS} steps: {path} is not "
                                 "finite")
    step_ms = 1e3 * statistics.median(secs[-4:])
    out.update(train_launches_per_step=want_k,
               train_launches={k: TRAIN_STEPS * v for k, v in want_k.items()},
               train_losses=losses, train_step_ms=step_ms,
               train_tok_s=TRAIN_B * TRAIN_S / (step_ms / 1e3),
               train_peak_gib=torch.cuda.max_memory_allocated() / gib)
    print(f"train steps ({LM_ARCH}, B={TRAIN_B} S={TRAIN_S}, bfloat16 "
          f"compute, float32 masters, AdamW) on {card}: losses "
          f"{[round(x, 4) for x in losses]}; launches a step {want_k} in "
          f"every step; step times {[round(x * 1e3, 1) for x in secs]} ms; "
          f"median of the last four {step_ms:.1f} ms = "
          f"{out['train_tok_s']:.1f} train tokens/s; every parameter and "
          f"moment finite; peak device memory "
          f"{out['train_peak_gib']:.2f} GiB (loss_fn checks: "
          f"{out['grad_peak_gib']:.2f} GiB)")

    # phase 5: where a train step's time goes
    b = on_card(pipe.batch(TRAIN_STEPS))
    tr = trace(torch, "train step, bfloat16, kernel path",
               lambda: (step_fn(state, b), torch.cuda.synchronize()),
               what="one step", top=12,
               focus=("flash_attention", "flash_bwd", "flash_bwd_dkdv_tc",
                      "flash_bwd_dq_tc", "ssd_scan", "ssd_bwd",
                      "ssd_bwd_walk_tc", "ssd_bwd_chunk_tc", "ssd_bwd_reduce",
                      "ssd_bwd_scan"),
               ranges=(KERNEL_BACKWARD_RANGE, BACKWARD_RANGE))
    if tr:
        busy = tr[0]
        tc = {k: tr[2][k][0] for k in ("flash_bwd_dkdv_tc", "flash_bwd_dq_tc")}
        if tc != {k: n_attn for k in tc}:
            raise AssertionError(f"train step: the bfloat16 attention "
                                 f"backward's tensor-core kernels launched "
                                 f"{tc}, expected {n_attn} each")
        sb = {k: tr[2][k][0] for k in ("ssd_bwd_walk_tc", "ssd_bwd_chunk_tc",
                                       "ssd_bwd_reduce", "ssd_bwd_scan")}
        want_sb = {k: cfg.n_layers for k in sb}
        want_sb["ssd_bwd_scan"] = 0
        if sb != want_sb:
            raise AssertionError(f"train step: the bfloat16 SSD backward's "
                                 f"kernels launched {sb}, expected {want_sb}")
        if tr[2][BACKWARD_RANGE][0] or \
                tr[2][KERNEL_BACKWARD_RANGE][0] != cfg.n_layers:
            raise AssertionError(
                f"train step: {tr[2][BACKWARD_RANGE][0]} plain SSD backward "
                f"ranges and {tr[2][KERNEL_BACKWARD_RANGE][0]} kernel ranges, "
                f"expected 0 and {cfg.n_layers}")
        shares = {k: v[1] / busy for k, v in tr[2].items()}
        print(f"train step device time shares on {card}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
              + f"; idle share {tr[1]:.3f} under the profiler, "
              f"{1 - busy / step_ms:.3f} of the unprofiled step "
              f"({busy:.1f} ms of device time in {step_ms:.1f} ms)")
        out.update(train_trace=tr, train_shares=shares)
    del state
    return out


# -------------------------------- sharded training and the examples (3i)

SHARDED_DEPTH = 12      # of zamba2-2.7b's 54 layers: two shared-attention
                        # applications, and 2-4 ranks with whole gathered
                        # weights fit one 80 GB card
#: (world, meshes): one group of gloo ranks on cuda:0 each, in turn
TRAIN_GROUPS = [(2, [(1, 2), (2, 1)]), (4, [(2, 2)])]
TRAIN_BF16_STEPS = 2    # bfloat16 steps a mesh; the first warms up
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
EXAMPLES = {"quickstart": [], "fleet_allocation": [], "serve_llm": [],
            "train_lm": ["--ckpt-dir", str(ROOT / "build" /
                                           "chip_smoke_train_lm")]}
EXAMPLES_TIMEOUT_S = 300


def sharded_cfg():
    """zamba2-2.7b at full width, its depth cut to ``SHARDED_DEPTH``."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), n_layers=SHARDED_DEPTH)


def train_batches(torch, cfg, dev, n):
    """The first ``n`` batches of ``TokenPipeline(vocab, 2048, 4)``."""
    from repro_torch.data import TokenPipeline
    pipe = TokenPipeline(cfg.vocab, TRAIN_S, TRAIN_B)
    return [{k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch(i).items()} for i in range(n)]


def lm_launches() -> dict:
    """The launch counts of the train step's four kernels."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"flash_attention": attn_ops.launches["flash_attention"],
            "flash_attention_bwd": attn_ops.launches["flash_attention_bwd"],
            "ssd_scan": ssd_ops.launches, "ssd_scan_bwd": ssd_ops.launches_bwd}


def zero_lm_launches() -> None:
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    for name in attn_ops.launches:
        attn_ops.launches[name] = 0
    ssd_ops.launches = ssd_ops.launches_bwd = 0


def train_rank_mesh(torch, cfg, mesh, dev, batches, want, tmp, rank):
    """One rank's work on one mesh: the float32 gates (``1x2``: two steps,
    the gathered state's per-leaf digests on rank 0; otherwise the loss
    and all-reduced gradients at the initial state, each leaf against the
    unsharded step's over the same split of the batch, which the parent
    left in ``tmp``), then
    ``TRAIN_BF16_STEPS`` bfloat16 steps timed, with the rank's peak device
    memory and one step's collectives.  The launches of every pass."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.launch import roofline, sharded
    from repro_torch.launch.mesh import data_axis_size
    from repro_torch.optim import global_norm
    from repro_torch.pytree import leaves_with_paths
    rec = {"mesh": "x".join(str(mesh.shape[a]) for a in mesh.shape),
           "launches": []}

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def counted(fn):
        zero_lm_launches()
        out = fn()
        torch.cuda.synchronize()
        rec["launches"].append(lm_launches())
        return out

    f32 = dict(compute_dtype=torch.float32)
    state = sharded.init_sharded_train_state(cfg, gen(), mesh)
    if data_axis_size(mesh) == 1:
        fn = sharded.make_sharded_train_step(cfg, mesh, **f32)
        rec["metrics"] = []
        for b in batches[:2]:
            state, m = counted(lambda: fn(state, b))
            rec["metrics"].append([float(m["loss"]), float(m["grad_norm"])])
        whole = sharded.gather_train_state(cfg, state, mesh)
        if rank == 0:
            rec["bitwise"] = leaf_digests(whole) == want["digests"]
        del whole
    else:
        loss, g = counted(lambda: sharded.sharded_value_and_grad(
            cfg, mesh, state.params, batches[0], **f32))
        rec["loss"], rec["grad_norm"] = float(loss), float(global_norm(g))
        worst, same = [0.0, ""], True
        for i, (path, x) in enumerate(leaves_with_paths(g)):
            w = torch.from_numpy(np.load(Path(tmp) / f"grad-{i:04d}.npy"))
            w = w.to(dev)
            err = float((x - w).abs().max()) / max(1.0, float(w.abs().max()))
            worst = max(worst, [err, path])
            same = same and torch.equal(x, w)
        rec["grad_err"], rec["grad_bitwise"] = worst, same
        del g
    del state
    torch.cuda.empty_cache()

    state = sharded.init_sharded_train_state(cfg, gen(), mesh)
    fn = sharded.make_sharded_train_step(cfg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec["secs"] = []
    for b in batches[:TRAIN_BF16_STEPS]:
        M.reset_collectives()
        dist.barrier()
        t0 = time.perf_counter()
        state, m = counted(lambda: fn(state, b))
        rec["secs"].append(time.perf_counter() - t0)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"sharded bf16 step ({rec['mesh']}, rank "
                                 f"{rank}): loss {float(m['loss'])}")
    rec["coll"] = roofline.collective_stats()
    rec["coll_secs"] = sum(c["seconds"] for c in M.collectives.values())
    rec["peak"] = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return rec


def train_shard_rank(rank, world, tmp, meshes):
    """One rank of the sharded-training phase: join a gloo group (a file
    rendezvous; every rank on ``cuda:0``), run ``train_rank_mesh`` on each
    of ``meshes`` and write its records to ``tmp``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, rank_device
    tmp = Path(tmp)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous-"
                            f"{world}", rank=rank, world_size=world)
    try:
        want = json.loads((tmp / "unsharded.json").read_text())
        cfg = sharded_cfg()
        dev = rank_device()
        batches = train_batches(torch, cfg, dev, TRAIN_BF16_STEPS)
        records = [train_rank_mesh(torch, cfg, make_mesh(shape, ("data",
                                                                 "model")),
                                   dev, batches, want, tmp, rank)
                   for shape in meshes]
        (tmp / f"ranks-{world}-{rank}.json").write_text(json.dumps(records))
        dist.barrier()         # no rank leaves the group while one works
    finally:
        dist.destroy_process_group()


def train_shard_phase(torch, dev, card, lm, train):
    """Sharded training on the card (phase 3i): zamba2-2.7b at full width
    and ``SHARDED_DEPTH`` layers, B=4 x S=2048 of ``TokenPipeline``,
    float32 masters.  The parent runs the unsharded step at that depth:
    float32 gradients at the initial state (left per leaf in
    ``TRAIN_DIR``), two float32 steps (per-leaf digests), bfloat16 steps
    timed.  The float32 gradients of the step's whole batch in one pass
    and in two microbatches (the split of the batch over the data axes of
    2x1 and 2x2) are each held to a float64 pass: the split's mean error
    within 1.25x and worst leaf within 2x the one pass's (phase 3f's
    rule; two float32 reduction orders differ by more than 1e-4 x max(1,
    max |g|) on ``conv_b``).  Then each group of ``TRAIN_GROUPS`` in turn
    (gloo ranks sharing ``cuda:0``): ``1x2`` bitwise the unsharded state
    after two float32 steps; ``2x1`` and ``2x2`` the loss within 1e-5
    relative and the all-reduced gradients within 1e-4 x max(1, max |g|) a
    leaf of the unsharded step's over the same split of the batch; every
    rank's B4, B4-bwd, B6 and B6-bwd launches in every pass equal to the
    unsharded step's; bfloat16 train tokens/s, peak memory a rank,
    collective bytes and host seconds a step, the roofline's terms.  Also
    the roofline shares of phase 3f's train step and phase 3e's prefill
    step.  Returns each kernel's launches a step per rank by mesh."""
    import shutil

    import torch.multiprocessing as mp
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import roofline, steps
    from repro_torch.optim import global_norm
    from repro_torch.pytree import leaves_with_paths
    cfg = sharded_cfg()
    n_attn = cfg.n_layers // cfg.shared_attn_every
    want_k = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
              "ssd_scan": 2 * cfg.n_layers, "ssd_scan_bwd": cfg.n_layers}
    cell = ShapeCell("train", TRAIN_S, TRAIN_B, "train")
    print(f"sharded training: {LM_ARCH} at full width, depth cut to "
          f"{cfg.n_layers} of {get_config(LM_ARCH).n_layers} layers "
          f"({n_attn} shared-attention applications), "
          f"{cfg.param_count() / 1e9:.3f} B parameters "
          f"({cfg.param_count() * 4 / 1e9:.2f} GB float32), B={TRAIN_B} "
          f"S={TRAIN_S}; meshes {[m for _, ms in TRAIN_GROUPS for m in ms]} "
          "as gloo ranks sharing one card")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    out = {name: {} for name in want_k}
    try:
        batches = train_batches(torch, cfg, dev, TRAIN_BF16_STEPS)

        def fresh():
            return steps.init_train_state(
                cfg, torch.Generator(device=dev).manual_seed(0))

        def counted(label, fn):
            zero_lm_launches()
            res = fn()
            torch.cuda.synchronize()
            if lm_launches() != want_k:
                raise AssertionError(f"unsharded {label}: launches "
                                     f"{lm_launches()}, expected {want_k}")
            return res

        state = fresh()
        # the float32 gradients at the initial state: in one pass, and in
        # two microbatches (the batch split as the data axes split it),
        # each against a float64 pass (the witness, as phase 3f's)
        w64 = models.common.map_tree(lambda t: t.double(), state.params)
        _, g64 = steps._value_and_grad(
            lambda p, b: models.loss_fn(p, cfg, b, dtype=torch.float64,
                                        kernels=False), w64, batches[0])
        del w64
        g64 = [g for _, g in leaves_with_paths(g64)]
        loss0, g0 = counted("float32 gradients", lambda: steps.loss_and_grads(
            cfg, state.params, batches[0], 1, torch.float32))
        zero_lm_launches()
        loss2, g2 = steps.loss_and_grads(cfg, state.params, batches[0], 2,
                                          torch.float32)
        torch.cuda.synchronize()
        if lm_launches() != {k: 2 * v for k, v in want_k.items()}:
            raise AssertionError(f"unsharded float32 gradients in two "
                                 f"microbatches: launches {lm_launches()}")
        paths = [p for p, _ in leaves_with_paths(g0)]
        g0 = [g for _, g in leaves_with_paths(g0)]
        norm0, norm2 = float(global_norm(g0)), float(global_norm(g2))
        g2 = [g for _, g in leaves_with_paths(g2)]
        witness = {}
        for tag, gs in (("one pass", g0), ("two microbatches", g2)):
            total, n, worst = 0.0, 0, [0.0, ""]
            for path, a, w in zip(paths, gs, g64):
                d = (a.double() - w).abs()
                total, n = total + float(d.sum()), n + d.numel()
                worst = max(worst, [float(d.max()) / max(
                    1.0, float(w.abs().max())), path])
            witness[tag] = (total / n, worst)
        split = max([float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())), p] for p, a, b in zip(paths, g2, g0))
        del g64, g0
        for i, g in enumerate(g2):
            np.save(TRAIN_DIR / f"grad-{i:04d}.npy", g.cpu().numpy())
        del g2
        (m0, w0), (m2, w2) = witness["one pass"], witness["two microbatches"]
        print(f"sharded training, float32 gradients at the initial state, "
              f"against a float64 pass: one pass mean |err| {m0:.4g}, worst "
              f"leaf {w0[1]} {w0[0]:.4g}; two microbatches (the 2x1 and 2x2 "
              f"meshes' split of the batch) {m2:.4g}, worst leaf {w2[1]} "
              f"{w2[0]:.4g} (bound: mean within 1.25x, worst leaf within "
              f"2x); two microbatches against one pass: loss rel err "
              f"{abs(float(loss2) - float(loss0)) / abs(float(loss0)):.3g}, "
              f"worst leaf {split[1]} max |err| / max(1, max |g|) "
              f"{split[0]:.3g}, grad norm {norm2:.6f} vs {norm0:.6f}")
        if m2 > 1.25 * m0 or w2[0] > 2 * w0[0]:
            raise AssertionError("sharded training: the gradients over the "
                                 "data axes' split of the batch are farther "
                                 "from float64 than the one-pass gradients")
        fn = steps.make_train_step(cfg, compute_dtype=torch.float32)
        metrics = []
        for b in batches[:2]:
            state, m = counted("float32 step", lambda: fn(state, b))
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        digests = leaf_digests(state)
        del state
        torch.cuda.empty_cache()
        state = fresh()
        fn = steps.make_train_step(cfg)
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for b in batches:
            t0 = time.perf_counter()
            state, m = counted("bfloat16 step", lambda: fn(state, b))
            secs.append(time.perf_counter() - t0)
        base_s = statistics.median(secs[1:])
        base_peak = torch.cuda.max_memory_allocated()
        del state
        torch.cuda.empty_cache()
        base = roofline.roofline_terms(
            roofline.analytic_cost(cfg, cell), {}, 1,
            roofline.model_flops_for(cfg, cell), {})
        print(f"sharded training, the unsharded step at {cfg.n_layers} "
              f"layers on {card}: float32 loss {float(loss0):.6f}, grad norm "
              f"{norm0:.6f}, two steps {metrics}; bfloat16 step "
              f"{base_s * 1e3:.1f} ms = {TRAIN_B * TRAIN_S / base_s:.1f} "
              f"train tokens/s, peak device memory {base_peak / 2**30:.2f} "
              f"GiB; launches a step {want_k}; roofline (one card) compute "
              f"{base['compute_s'] * 1e3:.2f} ms, memory "
              f"{base['memory_s'] * 1e3:.2f} ms; model_flops_for / (step "
              f"seconds x peak) "
              f"{base['model_flops'] / (base_s * roofline.PEAK_FLOPS):.4f}")
        (TRAIN_DIR / "unsharded.json").write_text(json.dumps(
            dict(digests=digests)))
        for world, meshes in TRAIN_GROUPS:
            t0 = time.perf_counter()
            mp.spawn(train_shard_rank, args=(world, str(TRAIN_DIR), meshes),
                     nprocs=world, join=True)
            wall = time.perf_counter() - t0
            ranks = [json.loads((TRAIN_DIR / f"ranks-{world}-{r}.json")
                                .read_text()) for r in range(world)]
            for k, shape in enumerate(meshes):
                recs = [rk[k] for rk in ranks]
                label = "x".join(map(str, shape))
                train_shard_check(label, recs, want_k, float(loss2), norm2,
                                  metrics)
                for name in out:
                    out[name][label] = [rec["launches"][-1][name]
                                        for rec in recs]
                terms = roofline.roofline_terms(
                    roofline.analytic_cost(cfg, cell), recs[0]["coll"],
                    world, roofline.model_flops_for(cfg, cell), {})
                step_s = statistics.median(
                    max(rec["secs"][i] for rec in recs)
                    for i in range(1, TRAIN_BF16_STEPS))
                coll = recs[0]["coll"]
                print(f"  sharded {label} (gloo x{world} on one card: not a "
                      f"scaling figure; spawn to exit {wall:.1f} s) on "
                      f"{card}: bfloat16 step {step_s * 1e3:.1f} ms (slowest "
                      f"rank, median of {TRAIN_BF16_STEPS - 1} after one to "
                      "warm up) = "
                      f"{TRAIN_B * TRAIN_S / step_s:.1f} train tokens/s "
                      f"(unsharded {TRAIN_B * TRAIN_S / base_s:.1f}); peak "
                      f"device memory per rank "
                      f"{[round(r['peak'] / 2**30, 2) for r in recs]} GiB "
                      f"(unsharded {base_peak / 2**30:.2f}); collectives a "
                      f"step, rank 0: "
                      + ", ".join(f"{k} {int(v['count'])} calls, "
                                  f"{v['operand_bytes']:,.0f} B operand, "
                                  f"{v['ring_bytes']:,.0f} B ring"
                                  for k, v in coll.items())
                      + f"; host seconds in collectives a step "
                      f"{max(r['coll_secs'] for r in recs):.3f} (slowest "
                      f"rank); roofline ({world} cards) compute "
                      f"{terms['compute_s'] * 1e3:.2f} ms, memory "
                      f"{terms['memory_s'] * 1e3:.2f} ms, collective_ring "
                      f"{terms['collective_ring_s'] * 1e3:.2f} ms")
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    full = get_config(LM_ARCH)
    train_s = train["train_step_ms"] / 1e3
    prefill_s = PREFILL_B * PREFILL_S / lm["prefill_tok_s_kernel"]
    shares = {
        "train": roofline.model_flops_for(full, cell) / (
            train_s * roofline.PEAK_FLOPS),
        "prefill": roofline.model_flops_for(full, ShapeCell(
            "prefill", PREFILL_S, PREFILL_B, "prefill")) / (
            prefill_s * roofline.PEAK_FLOPS)}
    print(f"roofline shares of the unsharded full-depth {LM_ARCH} steps on "
          f"{card}: model_flops_for / (step seconds x {roofline.PEAK_FLOPS:g}"
          f" FLOP/s): train (3f, {train_s * 1e3:.1f} ms) "
          f"{shares['train']:.4f}, prefill (3e, {prefill_s * 1e3:.1f} ms) "
          f"{shares['prefill']:.4f}")
    return out


def train_shard_check(label, recs, want_k, loss0, norm0, metrics):
    """Phase 3i's gates on one mesh's rank records."""
    for r, rec in enumerate(recs):
        for i, got in enumerate(rec["launches"]):
            if got != want_k:
                raise AssertionError(f"sharded {label} rank {r} pass {i}: "
                                     f"launches {got}, expected {want_k}")
    if label == "1x2":
        if not recs[0]["bitwise"]:
            raise AssertionError("sharded 1x2: the gathered state after two "
                                 "float32 steps is not bitwise the unsharded "
                                 "state")
        if any(rec["metrics"] != metrics for rec in recs):
            raise AssertionError(f"sharded 1x2: metrics "
                                 f"{[r['metrics'] for r in recs]}, unsharded "
                                 f"{metrics}")
        print(f"  sharded 1x2, float32: the gathered state bitwise the "
              f"unsharded state after two steps (per-leaf SHA-256); losses "
              f"and grad norms {recs[0]['metrics']} equal")
        return
    for r, rec in enumerate(recs):
        rel = abs(rec["loss"] - loss0) / abs(loss0)
        if rel > 1e-5 or rec["grad_err"][0] > 1e-4:
            raise AssertionError(
                f"sharded {label} rank {r}: loss rel err {rel:.3g} (bound "
                f"1e-5), worst gradient leaf {rec['grad_err']} (bound 1e-4)")
    worst = max(rec["grad_err"] for rec in recs)
    print(f"  sharded {label}, float32, against the unsharded step over the "
          f"same split of the batch: loss {recs[0]['loss']:.6f} (unsharded "
          f"{loss0:.6f}, rel err "
          f"{max(abs(r['loss'] - loss0) for r in recs) / abs(loss0):.3g}); "
          f"grad norm {recs[0]['grad_norm']:.6f} (unsharded {norm0:.6f}); "
          f"worst gradient leaf {worst[1]}: max |err| / max(1, max |g|) "
          f"{worst[0]:.3g} over every rank; bitwise on every rank: "
          f"{all(r['grad_bitwise'] for r in recs)}")


def examples_phase(card):
    """The four examples, ``python -m repro_torch.examples.<name>`` on the
    card, started together; each must exit 0 within
    ``EXAMPLES_TIMEOUT_S`` with no traceback in its output (a background
    checkpoint thread's failure does not change the exit code).  Prints
    each one's seconds and last lines."""
    import os
    import shutil
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs, t0 = {}, time.perf_counter()
    for name, extra in EXAMPLES.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.examples.{name}", *extra],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    done = {}
    try:
        for name, p in procs.items():
            left = max(1.0, EXAMPLES_TIMEOUT_S - (time.perf_counter() - t0))
            text = p.communicate(timeout=left)[0]
            done[name] = (p.returncode, time.perf_counter() - t0, text)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(ROOT / "build" / "chip_smoke_train_lm",
                      ignore_errors=True)
    for name, (rc, secs, text) in done.items():
        tail = [ln for ln in text.splitlines() if ln.strip()][-4:]
        print(f"example {name} on {card}: exit {rc} (done by "
              f"{secs:.1f} s); last lines: " + " | ".join(tail))
        if rc != 0 or "Traceback" in text:
            raise AssertionError(f"example {name} exited {rc}:\n{text}")
    return done


# ----------------------------------- the MoE block and the frontends (3g)

# (arch, depth of its bfloat16 full-width run, depth of its float32 gates):
# moonshot fits the card only in bfloat16 (52.3 GiB at full depth);
# phi3.5-moe does not fit at full depth even in bfloat16 (78.0 GiB), so its
# run takes 16 of its 32 layers; the float32 gates cut the depth where
# float32 weights would not fit
FRONTIER = [("moonshot-v1-16b-a3b", 48, 4), ("phi3.5-moe-42b-a6.6b", 16, 2),
            ("hubert-xlarge", 48, 48), ("pixtral-12b", 40, 10)]
HUBERT_S = 1500                   # 30 s of 50 Hz frames
PIXTRAL_PATCHES = 1024            # patch embeddings ahead of 1024 tokens
FLIP_LIMIT = 1e-3                 # float32 routing flips, share of positions


def frontier_batch(torch, cfg, dev):
    """The phase's seeded batch: B=4 rows of 2048 tokens (pixtral: 1024
    patch embeddings, then tokens) or, for the audio encoder, 1500 frames
    with a masked-unit label each."""
    rng = np.random.default_rng(0)
    s = HUBERT_S if cfg.frontend == "audio" else PREFILL_S
    batch = {"labels": rng.integers(0, cfg.vocab, (PREFILL_B, s))}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (PREFILL_B, s, cfg.frontend_dim), dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (PREFILL_B, s))
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (PREFILL_B, PIXTRAL_PATCHES, cfg.frontend_dim), dtype=np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


class Watch:
    """While active: counts the calls of the plain attention versions
    (``ref.mha``, ``ref.decode_attention``; a kernel path makes none) and
    records each MoE call's chosen and kept experts per token ([B, S, E]
    bools, from ``layers.moe_route`` and ``moe_sort`` on the same input),
    and the first MoE call's (weights, input, output)."""

    def __init__(self, torch):
        from repro_torch.kernels.attention import ref
        from repro_torch.models import layers
        self.torch, self.ref, self.L = torch, ref, layers
        self.plain, self.routes, self.first = 0, [], None

    def __enter__(self):
        torch, ref, L = self.torch, self.ref, self.L
        self.saved = (ref.mha, ref.decode_attention, L.moe_apply)
        mha, dec, moe = self.saved

        def plain(fn):
            def counted(*a, **kw):
                self.plain += 1
                return fn(*a, **kw)
            return counted

        def routed(p, x, cfg):
            y = moe(p, x, cfg)
            b, s, _ = x.shape
            idx, _ = L.moe_route(p, x, cfg)
            rank = L.moe_sort(idx.reshape(b, -1), cfg.n_experts)[3]
            keep = rank.reshape(idx.shape) < L.moe_capacity(s, cfg)
            none = torch.zeros(b, s, cfg.n_experts, dtype=torch.bool,
                               device=x.device)
            self.routes.append((none.scatter(-1, idx, True),
                                none.scatter(-1, idx, keep)))
            if self.first is None:
                self.first = (p, x, y)
            return y

        ref.mha, ref.decode_attention = plain(mha), plain(dec)
        L.moe_apply = routed
        return self

    def __exit__(self, *exc):
        self.ref.mha, self.ref.decode_attention, self.L.moe_apply = self.saved


def routing_diff(torch, a, b):
    """Positions [B, S] whose chosen experts differ in any layer between two
    runs' records, and the positions that agree: in each row, those before
    its first position whose chosen or kept experts differ in any layer (a
    flip reaches later positions of its row through causal attention and
    through the capacity of the experts it joins or leaves)."""
    flips = changed = None
    for (ca, ka), (cb, kb) in zip(a, b):
        f = (ca != cb).any(-1)
        c = f | (ka != kb).any(-1)
        flips = f if flips is None else flips | f
        changed = c if changed is None else changed | c
    s = changed.shape[1]
    pos = torch.arange(s, device=changed.device)
    first = torch.where(changed, pos, s).min(-1).values         # [B]
    return flips, pos[None, :] < first[:, None]


def frontier_gates(torch, cfg, depth, dev):
    """The float32 and bfloat16 gates at full width and ``depth`` layers on
    weights from ``torch.Generator(0)``, at the positions whose routing
    agrees in the float32 kernel, float32 plain and float64 plain runs (MoE:
    at most FLIP_LIMIT of positions flip between the two float32 paths).
    float32: the kernel path's error from the float64 plain logits within
    1.25x (mean) and 2x (max) the float32 plain path's, and the kernel path
    within 1e-3 x max(1, max |logit|) of the plain path where float32
    itself holds the logits to that bound on average (the plain path's mean
    error from float64 below it); hubert's float32 ``loss_fn`` within 1e-4
    relative.  bfloat16: the kernel path's mean error from the float32 plain
    logits within 1.25x the bfloat16 plain path's.  Returns the numbers for
    the report."""
    import dataclasses
    from repro_torch import models
    cut = dataclasses.replace(cfg, n_layers=depth)
    batch = frontier_batch(torch, cfg, dev)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    moe = cfg.block == "moe"
    params = models.init_params(cut, torch.Generator(device=dev).manual_seed(0))
    out = {"depth": depth}

    def run(dtype, kernels, w):
        with torch.no_grad(), Watch(torch) as watch:
            lg = models.forward(w, cut, inputs, dtype=dtype, kernels=kernels)
        if kernels and watch.plain:
            raise AssertionError(f"{cfg.name}: the kernel path called the "
                                 f"plain attention {watch.plain} times")
        if not bool(lg.isfinite().all()):
            raise AssertionError(f"{cfg.name} ({dtype}, kernels={kernels}): "
                                 "logits not finite")
        return lg, watch.routes

    p32, r32 = run(torch.float32, False, params)
    k32, rk = run(torch.float32, True, params)
    if cfg.frontend == "audio":
        losses = {}
        for kernels in (True, False):
            with torch.no_grad():
                losses[kernels] = float(models.loss_fn(
                    params, cut, batch, dtype=torch.float32, kernels=kernels))
        rel = abs(losses[True] - losses[False]) / abs(losses[False])
        print(f"{cfg.name} float32 loss_fn (masked-unit cross-entropy): "
              f"kernel path {losses[True]:.6f}, plain path "
              f"{losses[False]:.6f}, rel err {rel:.3g} (bound 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"{cfg.name}: float32 loss_fn off by {rel}")
        out["loss_rel"] = rel
    w16 = models.cast_params(params, torch.bfloat16)
    w64 = models.cast_params(params, torch.float64)
    del params
    p64, r64 = run(torch.float64, False, w64)
    del w64
    n_pos = p32.shape[0] * p32.shape[1]
    agree = torch.ones(p32.shape[:2], dtype=torch.bool, device=dev)
    n_flip = 0
    if moe:
        flips, agree = routing_diff(torch, rk, r32)
        n_flip = int(flips.sum())
        for a, b in ((rk, r64), (r32, r64)):
            agree &= routing_diff(torch, a, b)[1]
    n_agree = int(agree.sum())
    scale = float(p32.abs().max())
    bound = 1e-3 * max(1.0, scale)

    def err(a, b):
        d = (a.double() - b)[agree].abs()
        return float(d.mean()), float(d.max())

    ek, ep = err(k32, p64), err(p32, p64)
    e32 = float((k32 - p32)[agree].abs().max())
    del k32, p64, rk, r32, r64
    gated = ep[0] <= bound
    print(f"{cfg.name} float32 at {depth} layers, B={p32.shape[0]} "
          f"S={p32.shape[1]}, over "
          + (f"the {n_agree} of {n_pos} positions whose routing agrees in "
             f"the three runs" if moe else f"all {n_pos} positions")
          + ": against the float64 plain "
          f"logits, kernel path mean/max |err| {ek[0]:.4g}/{ek[1]:.4g}, "
          f"plain path {ep[0]:.4g}/{ep[1]:.4g} (bound: mean within 1.25x, "
          f"max within 2x); kernel vs plain max |err| {e32:.4g} (bound 1e-3 "
          f"x max(1, max |logit| {scale:.3f}) = {bound:.4g}, "
          + ("gated" if gated else "not gated: the float32 plain path's mean "
             "error from float64 exceeds it")
          + ")" + (f"; routing flips between the two float32 paths at "
                   f"{n_flip} positions ({n_flip / n_pos:.2e}, bound "
                   f"{FLIP_LIMIT})" if moe else ""))
    if ek[0] > 1.25 * ep[0] or ek[1] > 2 * ep[1]:
        raise AssertionError(f"{cfg.name} float32: the kernel path is farther "
                             "from float64 than the plain path")
    if gated and e32 > bound:
        raise AssertionError(f"{cfg.name} float32: kernel path off the plain "
                             f"path by {e32}")
    if n_flip > FLIP_LIMIT * n_pos:
        raise AssertionError(f"{cfg.name} float32: routing flips at {n_flip} "
                             f"of {n_pos} positions")
    out.update(f32_err=e32, f32_gated=gated, f32_vs_f64=(ek, ep),
               f32_flips=n_flip, f32_agree=n_agree, positions=n_pos)

    errs = {}
    for kernels in (True, False):
        lg, _ = run(torch.bfloat16, kernels, w16)
        d = (lg.float() - p32).abs()
        errs[kernels] = (float(d.mean(dtype=torch.float64)), float(d.max()))
        del lg, d
    del w16, p32
    (km, kx), (pm, px) = errs[True], errs[False]
    print(f"{cfg.name} bfloat16 at {depth} layers against the float32 plain "
          f"logits: kernel path mean/max |err| {km:.5f}/{kx:.4f}, plain path "
          f"{pm:.5f}/{px:.4f} (bound: mean within 1.25x; the max is not "
          f"gated)")
    if km > 1.25 * pm:
        raise AssertionError(f"{cfg.name} bfloat16: the kernel path is "
                             "farther from the float32 logits than the "
                             "plain path")
    out.update(bf16_err=errs[True], bf16_plain_err=errs[False])
    torch.cuda.empty_cache()
    return out


def frontier_run(torch, cfg, depth, dev, counts, zero_counts, card, out):
    """The full-width bfloat16 run at ``depth`` layers on weights made in
    bfloat16 from ``torch.Generator(0)``: the prefill step (hubert: the
    encoder's forward) on the kernels, launches counted, no plain attention
    call, logits finite; then on the plain path for the argmax agreement
    (and, for MoE, the routing flips between the two); tokens/s and peak
    memory.  For moonshot at full depth also the serving engine.  Returns
    the weights for the engine."""
    import dataclasses
    from repro_torch import models
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers as L
    cut = dataclasses.replace(cfg, n_layers=depth)
    name = cfg.name
    batch = frontier_batch(torch, cfg, dev)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    n_tok = inputs[next(iter(inputs))].shape[0] * inputs[
        next(iter(inputs))].shape[1]
    encoder = cfg.frontend == "audio"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(cut, torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"{name}: {depth} of {cfg.n_layers} layers in bfloat16 on the card "
          f"in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def step(kernels):
        if encoder:
            return models.forward(params, cut, inputs, dtype=torch.bfloat16,
                                  kernels=kernels)
        return make_prefill_step(cut, compute_dtype=torch.bfloat16,
                                 kernels=kernels)(params, inputs)

    res = {}
    for kernels in (True, False):
        zero_counts()
        with torch.no_grad(), Watch(torch) as watch:
            t0 = time.perf_counter()
            lg = step(kernels)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
        got = {k: v for k, v in counts().items() if v}
        want = {"flash_attention": depth} if kernels else {}
        if got != want:
            raise AssertionError(f"{name} ({'kernel' if kernels else 'plain'}"
                                 f" path): launches {got}, expected {want}")
        if kernels and watch.plain:
            raise AssertionError(f"{name}: the kernel path called the plain "
                                 f"attention {watch.plain} times")
        if not bool(lg.isfinite().all()):
            raise AssertionError(f"{name}: logits not finite")
        res[kernels] = (lg[:, -1] if not encoder else lg, watch.routes,
                        watch.first, first)
        if kernels:
            out["launches"] = got
            reps = 3
            with torch.no_grad():
                t0 = time.perf_counter()
                for _ in range(reps):
                    step(True)
                torch.cuda.synchronize()
            out["tok_s"] = reps * n_tok / (time.perf_counter() - t0)
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            if name == FRONTIER[0][0]:   # phase 5: where its step's time goes
                with torch.no_grad():
                    out["trace"] = trace(
                        torch, f"{name} prefill step, bfloat16, kernel path",
                        lambda: (step(True), torch.cuda.synchronize()),
                        what="one step", top=10, focus=("flash_attention",))
    (k16, rk, moe_first, secs), (p16, rp, _, _) = res[True], res[False]
    agree = float((k16.argmax(-1) == p16.argmax(-1)).double().mean())
    line = (f"{name} bfloat16, {depth} layers, B={PREFILL_B} x "
            f"{n_tok // PREFILL_B} {'frames (encoder forward)' if encoder else 'positions (prefill step)'} "
            f"on {card}: launches {out['launches']} (first call {secs:.2f} "
            f"s); {out['tok_s']:.1f} tokens/s (3 synchronised calls); peak "
            f"device memory {out['peak_gib']:.2f} GiB; argmax agreement "
            f"with the bfloat16 plain path {agree} over {k16.shape[0] * (k16.shape[1] if encoder else 1)} "
            f"{'positions' if encoder else 'last tokens'}")
    out["argmax_agree"] = agree
    if moe_first is not None:
        flips, _ = routing_diff(torch, rk, rp)
        out["flips"] = int(flips.sum())
        # two MoE calls on the same input, bitwise equal to each other and
        # to the call inside the step
        p, x, y = moe_first
        with torch.no_grad():
            a, b = L.moe_apply(p, x, cut), L.moe_apply(p, x, cut)
        if not (torch.equal(a, b) and torch.equal(a, y)):
            raise AssertionError(f"{name}: two MoE calls on the same input "
                                 "differ")
        line += (f"; routing flips between the two paths at {out['flips']} "
                 f"of {n_tok} positions; layer 0's MoE called twice on the "
                 f"same input: bitwise equal")
    print(line)
    del res, k16, p16, rk, rp, moe_first
    return params


def frontier_engine(torch, cfg, params, dev, counts, zero_counts, card, out):
    """The serving launcher's workload through ServingEngine and
    AdapTBFController in bfloat16 (8 requests, 16 new tokens, 4 slots,
    max_len 128), launches counted; the plain path teacher-forced on the
    kernel run's inputs for the argmax agreement."""
    from repro_torch import models
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.storage import AdapTBFController
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, cfg.vocab, SERVE["prompt"]).tolist(),
             "interactive" if i % 2 == 0 else "batch")
            for i in range(SERVE["requests"])]
    ctl = AdapTBFController(n_targets=1, capacity_rpc_per_s=2000,
                            window_s=0.05, device=dev)
    eng = ServingEngine(cfg, params, slots=SERVE["slots"],
                        max_len=SERVE["max_len"], controller=ctl,
                        classes={"interactive": 3.0, "batch": 1.0},
                        compute_dtype=torch.bfloat16)
    reqs = [Request(prompt=p, max_new_tokens=SERVE["max_new"], klass=k)
            for p, k in work]
    for r in reqs:
        eng.submit(r)
    record, decode = [], models.decode_step

    def recording(p, cache, cfg_, tokens, pos, **kw):
        lg, cache = decode(p, cache, cfg_, tokens, pos, **kw)
        record.append((tokens.clone(), pos.clone(), lg[:, -1].clone()))
        return lg, cache

    models.decode_step = recording
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    try:
        with torch.no_grad(), Watch(torch) as watch:
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        models.decode_step = decode
    got = {k: v for k, v in counts().items() if v}
    n_steps = len(record)
    want = {"flash_decode": n_steps * cfg.n_layers}
    if got != want or watch.plain:
        raise AssertionError(f"{cfg.name} engine: launches {got}, expected "
                             f"{want}; plain attention calls {watch.plain}")
    if len(done) != len(reqs) or any(len(r.output) != SERVE["max_new"]
                                     for r in reqs):
        raise AssertionError(f"{cfg.name} engine answered "
                             f"{len(done)}/{len(reqs)}")
    if not all(bool(lg.isfinite().all()) for _, _, lg in record):
        raise AssertionError(f"{cfg.name} engine: logits not finite")
    n_tok = sum(len(r.output) for r in reqs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # at one token a group every expert holds one slot, so a decode step
    # reads every expert's weights, as the reference's does
    expert_bytes = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff * 2
    cache = models.init_cache(cfg, SERVE["slots"], SERVE["max_len"],
                              dtype=torch.bfloat16, device=dev)
    agree, worst = [], 0.0
    with torch.no_grad():
        for tok, pos, lg in record:
            plg, cache = models.decode_step(params, cache, cfg, tok, pos,
                                            dtype=torch.bfloat16,
                                            kernels=False)
            plg = plg[:, -1]
            worst = max(worst, float((plg.float() - lg.float()).abs().max()))
            agree.append(float((plg.argmax(-1) == lg.argmax(-1)).double()
                               .mean()))
    del cache
    out.update(engine_launches=got, engine_steps=n_steps,
               engine_tok_s=n_tok / secs, engine_peak_gib=peak,
               engine_step_ms=1e3 * secs / n_steps,
               engine_expert_gb=expert_bytes / 1e9,
               engine_argmax_agree=float(np.mean(agree)),
               engine_windows=ctl.windows_run)
    print(f"{cfg.name} engine (bfloat16, {SERVE}) on {card}: answered "
          f"{len(done)}/{len(reqs)}, {n_tok} tokens in {n_steps} steps, "
          f"{secs:.3f} s ({n_tok / secs:.2f} generated tokens/s, "
          f"{1e3 * secs / n_steps:.1f} ms a step); AdapTBF windows "
          f"{ctl.windows_run}; launches {got}; peak device memory {peak:.2f} "
          f"GiB; a decode step reads every expert's weights, "
          f"{expert_bytes / 1e9:.1f} GB = {expert_bytes / HBM_BYTES_S * 1e3:.2f}"
          f" ms at {HBM_BYTES_S / 1e12} TB/s; the plain path teacher-forced: "
          f"argmax agreement {np.mean(agree)}, max |err| {worst:.4f} "
          f"(bfloat16, not gated)")


def check_attention_frontier(torch, attn_ops, dev):
    """B4 and B5 against their plain versions at the phase's shapes: B4
    causal at moonshot's (B=4, S=2048, 16 heads of 128) and pixtral's and
    phi3.5-moe's (GQA 32/8, D=128), non-causal at hubert's (B=4, S=1500, 16
    heads of 80), in both types; B5 at moonshot's engine shape (4 slots,
    T=128, 16 heads of 128, lengths {1, 37, 128, 128}) in both types.
    Returns the bfloat16 moonshot-shape inputs of each and the largest
    errors."""
    gen = torch.Generator(device=dev).manual_seed(59)
    both = ("float32", "bfloat16")
    cases = [(PREFILL_B, PREFILL_S, 16, 16, 128, True, dt) for dt in both]
    cases += [(PREFILL_B, PREFILL_S, 32, 8, 128, True, dt) for dt in both]
    cases += [(PREFILL_B, HUBERT_S, 16, 16, 80, False, dt) for dt in both]
    fa_err, fa_in = 0.0, None
    for b, s, hq, hkv, d, causal, name in cases:
        dt = getattr(torch, name)
        q = _randn(torch, gen, (b, s, hq, d), dt)
        k = _randn(torch, gen, (b, s, hkv, d), dt)
        v = _randn(torch, gen, (b, s, hkv, d), dt)
        o, lse = attn_ops.attention_lse(q, k, v, causal=causal)
        wo, wl = attn_ops.ref.mha_lse(q, attn_ops.ref.broadcast_kv(k, hq),
                                      attn_ops.ref.broadcast_kv(v, hq),
                                      causal=causal)
        e_o = close_err(o, wo, ATTN_TOL[name])
        e_l = close_err(lse, wl, ATTN_TOL[name])
        print(f"flash_attention kernel vs plain, B={b} S={s} Hq={hq} "
              f"Hkv={hkv} D={d} causal={causal} {name}: max |err| o {e_o}, "
              f"lse {e_l} (atol = rtol = {ATTN_TOL[name]})")
        fa_err = max(fa_err, e_o)
        if (hq, hkv, d, name) == (16, 16, 128, "bfloat16"):
            fa_in = (q, k, v)
    fd_err, fd_in = 0.0, None
    lens = (1, 37, 128, 128)
    for name in both:
        dt = getattr(torch, name)
        b, t, h, d = len(lens), SERVE["max_len"], 16, 128
        q = _randn(torch, gen, (b, 1, h, d), dt)
        kc = _randn(torch, gen, (b, t, h * d), dt).view(b, t, h, d)
        vc = _randn(torch, gen, (b, t, h * d), dt).view(b, t, h, d)
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = attn_ops.decode_attention(q, kc, vc, length)
        want = attn_ops.ref.decode_attention(q, kc, vc, length)
        err = close_err(got, want, ATTN_TOL[name])
        print(f"flash_decode kernel vs plain, B={b} T={t} Hq={h} Hkv={h} "
              f"D={d} lengths {list(lens)} {name}: max |err| {err} "
              f"(atol = rtol = {ATTN_TOL[name]})")
        fd_err = max(fd_err, err)
        if name == "bfloat16":
            fd_in = (q, kc, vc, length)
    return fa_in, fa_err, fd_in, fd_err


def time_attention_frontier(torch, attn_ops, fa_in, fd_in, dev, card):
    """B4 at moonshot's prefill shape and B5 at its engine shape, bfloat16:
    kernel, plain version and the library call (SDPA; with a length mask for
    decode) between CUDA events, beside the bound."""
    q, k, v = fa_in
    b, s, h, d = q.shape
    fa = dict(
        ms=cuda_ms(lambda: attn_ops.attention(q, k, v, causal=True), reps=20),
        plain_ms=cuda_ms(lambda: attn_ops.ref.mha(q, k, v, causal=True),
                         reps=2, groups=3),
        library_ms=cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in fa_in), is_causal=True), reps=20))
    fa["bound_ms"], fa["bound_by"] = bound_ms(*attention_work(b, s, h, d, 2),
                                              BF16_OPS_S)
    q, kc, vc, length = fd_in
    mask = (torch.arange(kc.shape[1], device=dev)[None, :]
            < length[:, None])[:, None, None, :]
    fd = dict(
        ms=cuda_ms(lambda: attn_ops.decode_attention(q, kc, vc, length),
                   reps=20),
        plain_ms=cuda_ms(lambda: attn_ops.ref.decode_attention(
            q, kc, vc, length), reps=20),
        library_ms=cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask), reps=20))
    lens = [int(x) for x in length.tolist()]
    fd["bound_ms"], fd["bound_by"] = bound_ms(
        *decode_work(lens, q.shape[2], kc.shape[2], q.shape[3], 2))
    print(f"LM kernel times at moonshot-v1-16b-a3b's shapes on {card}: "
          f"flash_attention (B={b} S={s} H={h} D={d} causal bfloat16) "
          f"{fa['ms']:.4f} ms (plain {fa['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention {fa['library_ms']:.4f} ms, bound "
          f"{fa['bound_ms']:.4f} ms by {fa['bound_by']}); flash_decode "
          f"(engine shape, 4 slots, T={kc.shape[1]}, lengths {lens}, 16 "
          f"heads of 128, bfloat16) {fd['ms']:.4f} ms (plain "
          f"{fd['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{fd['library_ms']:.4f} ms, bound {fd['bound_ms']:.5f} ms by "
          f"{fd['bound_by']})")
    return fa, fd


def frontier_entry(frontier, name: str, key: str) -> dict:
    """Phase 3g's keys of a kernel's entry in the ``kernels`` line: its
    launches on each of the phase's paths, its time, plain time, bound and
    library time at moonshot's shape, and its largest error there."""
    own = frontier[name]
    return {
        "launches_3g": {a: r[key][name] for a, r in frontier["configs"].items()
                        if name in r.get(key, {})},
        **{f"{k}_moonshot": v for k, v in own.items()}}


def frontier_phase(torch, attn_ops, dev, counts, zero_counts, card):
    """Phase 3g: the MoE block and the audio and vision frontends.  Sizes
    from ``param_shapes``/``cache_shapes`` printed before anything is
    allocated; B4 and B5 checked at the phase's shapes; then per config the
    float32 and bfloat16 gates at reduced depth (``frontier_gates``) and the
    bfloat16 full-width run (``frontier_run``), moonshot's with the serving
    engine.  Returns the numbers for the report."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels.window_mega.ops import _leaves
    t_phase = time.perf_counter()
    gib = 2**30
    cfgs = {arch: get_config(arch) for arch, _, _ in FRONTIER}
    for arch, depth, gate in FRONTIER:
        cfg = cfgs[arch]
        full = sum(t.numel() for t in _leaves(models.param_shapes(cfg)))
        per_layer = sum(t.numel() for t in _leaves(
            models.param_shapes(cfg)["layers"][0]))
        run = (full - (cfg.n_layers - depth) * per_layer) * 2
        gates = (full - (cfg.n_layers - gate) * per_layer) * 4
        cache = ""
        if arch == FRONTIER[0][0]:
            cache = sum(t.numel() * t.element_size() for t in _leaves(
                models.cache_shapes(cfg, SERVE["slots"], SERVE["max_len"])))
            cache = f"; the engine's bfloat16 cache {cache / gib:.3f} GiB"
        meta = all(t.device.type == "meta"
                   for t in _leaves(models.param_shapes(cfg)))
        print(f"planned ({arch}, from param_shapes on the meta device: "
              f"{meta}): {full} parameters, {full * 2 / gib:.1f} GiB in "
              f"bfloat16 and {full * 4 / gib:.1f} GiB in float32 at full "
              f"depth; the run at {depth} of {cfg.n_layers} layers "
              f"{run / gib:.1f} GiB (bfloat16), the float32 gates at {gate} "
              f"{gates / gib:.1f} GiB{cache}")
        if run > 0.9 * torch.cuda.get_device_properties(0).total_memory:
            raise AssertionError(f"{arch}: {run / gib:.1f} GiB of bfloat16 "
                                 "weights would not fit the card")
    fa_in, fa_err, fd_in, fd_err = check_attention_frontier(torch, attn_ops,
                                                            dev)
    fa, fd = time_attention_frontier(torch, attn_ops, fa_in, fd_in, dev, card)
    del fa_in, fd_in
    out = {"flash_attention": dict(fa, max_abs_err=fa_err),
           "flash_decode": dict(fd, max_abs_err=fd_err), "configs": {}}
    for arch, depth, gate in FRONTIER:
        cfg = cfgs[arch]
        t0 = time.perf_counter()
        res = frontier_gates(torch, cfg, gate, dev)
        params = frontier_run(torch, cfg, depth, dev, counts, zero_counts,
                              card, res)
        if arch == FRONTIER[0][0]:
            frontier_engine(torch, cfg, params, dev, counts, zero_counts,
                            card, res)
        del params
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        out["configs"][arch] = res
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 3g (the MoE block and the frontends) on {card}: "
          + "; ".join(f"{a} {r['seconds']:.1f} s" for a, r in
                      out["configs"].items())
          + f"; {out['seconds']:.1f} s in all")
    return out


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)  # keep lines if cut short
    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this smoke run needs one GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(f"{ROOT} is not a checkout of the repository "
                     "(src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.window_mega import ops as mega_ops
    from repro_torch.storage import FLEET_CONTROL_CODES, random_fleet

    dev = torch.device(DEVICE)
    card = _smi()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    fleet = {"fleet_window": fw_ops, "adaptbf_alloc": alloc_ops,
             "window_mega": mega_ops}
    names = [*fleet, "flash_attention", "flash_attention_bwd", "flash_decode",
             "ssd_scan", "ssd_scan_bwd"]

    def counts():
        """Every kernel wrapper's launch count."""
        got = {name: mod.launches for name, mod in fleet.items()}
        got.update(attn_ops.launches, ssd_scan=ssd_ops.launches,
                   ssd_scan_bwd=ssd_ops.launches_bwd)
        return got

    def zero_counts():
        for mod in fleet.values():
            mod.launches = 0
        for name in attn_ops.launches:
            attn_ops.launches[name] = 0
        ssd_ops.launches = 0
        ssd_ops.launches_bwd = 0

    laps = [("start", time.perf_counter())]

    def lap(label):
        """Mark the end of a phase (seconds printed at the end)."""
        laps.append((label, time.perf_counter()))

    # 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build([*names, "launch_floor"])
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(names)} kernels "
          "and an empty one, one nvcc each, in parallel)")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for lib, label, mark in (("flash_attention", "bfloat16", "Li80E"),
                             ("flash_attention_bwd", "bfloat16", "Li80E"),
                             ("ssd_scan", "bfloat16", "ssd_scan_tc"),
                             ("ssd_scan_bwd", "bfloat16", "_tc")):
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[lib])],
                              capture_output=True, text=True,
                              check=True).stdout
        per_fn, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif "HGMMA" in line:
                per_fn[fn] = per_fn.get(fn, 0) + 1
        n_hgmma = sum(per_fn.values())
        print(f"{lib} SASS: {n_hgmma} HGMMA (wgmma) instructions in "
              f"{len(per_fn)} functions; "
              + ", ".join(f"{k}: {v}" for k, v in per_fn.items() if mark in k))
        if n_hgmma == 0:
            raise AssertionError(f"the {label} {lib} library holds no "
                                 "tensor-core (HGMMA) instruction")
        if lib == "ssd_scan_bwd":
            for kernel in ("ssd_bwd_walk_tc", "ssd_bwd_chunk_tc"):
                if not any(kernel in k and v for k, v in per_fn.items()):
                    raise AssertionError(f"the bfloat16 SSD backward kernel "
                                         f"{kernel} holds no HGMMA instruction")
    print("ssd_scan_tc dynamic shared memory (bytes): N <= 64: "
          f"{ssd_ops.tc_smem_bytes(64)}, N <= 128: {ssd_ops.tc_smem_bytes(128)}")
    cufilt = Path(_build._nvcc()).parent / "cu++filt"
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        for line in lines:
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:                    # the kernel and its template arguments
                full = subprocess.run([str(cufilt), entry.group(1)],
                                      capture_output=True, text=True,
                                      check=True).stdout.strip()
                print(f"  {_without_params(full).removeprefix('void ')}:")
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # the fleet kernels at the main path's width (8 lanes a thread)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    occupancy = {}
    for name, marker in (
            ("fleet_window", ("fleet_window_kernelILi8E", "RowBlockILb0E")),
            ("adaptbf_alloc", ("adaptbf_alloc_kernelILi8E", "RowBlockILb0E")),
            ("window_mega", ("window_mega_kernelILi8ELi0ELb0E",
                             "RowBlockILb0E"))):
        regs, stores, loads, smem = ptxas_of(
            libs[name].with_suffix(".log"), marker)
        blocks, dyn = _build.occupancy(name, J)
        occupancy[name] = blocks
        print(f"{name} at J={J} (8 lanes a thread): {regs} registers, "
              f"{stores} B spill stores, {loads} B spill loads, {smem} B "
              f"static + {dyn} B dynamic shared memory a block; {blocks} "
              f"blocks an SM, {blocks * n_sm} rows a wave on {n_sm} SMs "
              f"(O={O}: {-(-O // max(blocks * n_sm, 1))} wave(s))")
    clusters = wide_build_summary(libs, n_sm)
    narrow_build_summary(libs, n_sm, occupancy)

    # the bfloat16 SSD backward's kernels at the training shape (N = 64)
    for kernel, entry in (("ssd_bwd_walk_tcILi64E", "ssd_bwd_walk_occupancy"),
                          ("ssd_bwd_chunk_tcILi64E", "ssd_scan_bwd_occupancy")):
        regs, stores, loads, smem = ptxas_of(
            libs["ssd_scan_bwd"].with_suffix(".log"), kernel)
        dyn = ctypes.c_int(0)
        blocks = _build.load(entry, [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                             lib="ssd_scan_bwd")(64, ctypes.byref(dyn))
        occupancy[kernel[:-6]] = blocks
        print(f"{kernel[:-6]}<64>: {regs} registers (consumers raise theirs "
              f"by setmaxnreg), {stores} B spill stores, {loads} B spill "
              f"loads, {smem} B static + {dyn.value} B dynamic shared memory "
              f"a block; {blocks} blocks an SM")
        if blocks < 1:
            raise AssertionError(f"{kernel[:-6]} fits no block on an SM")

    lap("1 build")
    # 2. each kernel against its plain version, at the main path's shapes
    fw_args, fw_err = check_window_kernel(torch, fw_ops, dev)
    fw_err = max(fw_err, check_window_edges(torch, fw_ops, dev))
    al_args, al_err = check_alloc_kernel(torch, alloc_ops, dev)
    al_err = max(al_err, check_alloc_edges(torch, alloc_ops, dev))
    mega_args, mega_err = check_mega_kernel(torch, mega_ops, dev)
    stress_err = check_alloc_stress(torch, alloc_ops, mega_ops, dev)
    al_err, mega_err = max(al_err, stress_err), max(mega_err, stress_err)
    wide_err = check_wide_kernels(torch, fw_ops, alloc_ops, mega_ops, dev,
                                  clusters)
    narrow_err = check_narrow_kernels(torch, fw_ops, alloc_ops, mega_ops, dev)
    fw_err = max(fw_err, narrow_err["fleet_window"])
    al_err = max(al_err, narrow_err["adaptbf_alloc"])
    mega_err = max(mega_err, narrow_err["window_mega"])
    fa_args, fa_err = check_attention_kernel(torch, attn_ops, dev)
    fd_args, fd_err, fd_long = check_decode_kernel(torch, attn_ops, dev)
    ssd_args, ssd_err = check_ssd_kernel(torch, ssd_ops, dev)
    ssd_err = max(ssd_err, check_ssd_warm_start(torch, ssd_ops, dev))
    fb_args, fb_err = check_attention_bwd_kernel(torch, attn_ops, dev)
    sb_args, sb_err = check_ssd_bwd_kernel(torch, ssd_ops, dev)

    lap("2 kernel checks")
    # 3. the main paths ---------------------------------------------------
    t0 = time.perf_counter()
    scn = random_fleet(0, n_ost=O, n_jobs=J, profile="mixed", duration_s=2.0)
    print(f"fleet: random_fleet(0, n_ost={O}, n_jobs={J}, mixed, 2.0 s) "
          f"built in {time.perf_counter() - t0:.1f} s; rates "
          f"{scn.issue_rate.shape}, {scn.issue_rate.nbytes / 1e6:.0f} MB")
    inputs = dict(nodes=torch.as_tensor(scn.nodes, device=dev),
                  rates=torch.as_tensor(scn.issue_rate, device=dev),
                  volume=torch.as_tensor(scn.volume, device=dev),
                  cap=torch.as_tensor(scn.capacity_per_tick, device=dev),
                  backlog=torch.as_tensor(scn.max_backlog, device=dev))
    inputs["trace_windows"] = scn.issue_rate.shape[0] // W
    cap_w = inputs["cap"].double() * W

    def run(serve, alloc, control="adaptbf", code=None,
            telemetry="trajectory", n_windows=N_WINDOWS, fault_plan=None):
        return fleet_run(torch, dev, inputs, serve, alloc, control, code,
                         telemetry, n_windows, fault_plan)

    def counted(label, want, *config, **kw):
        """One run with every launch counter set to 0 just before it and
        read just after; ``want`` maps each kernel to its expected count
        (every other kernel: 0)."""
        zero_counts()
        res = run(*config, **kw)
        got = counts()
        print(f"main path ({label}), {N_WINDOWS} windows: launches {got}")
        want = {name: want.get(name, 0) for name in names}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        return res, got

    def compare(label, res, base):
        return compare_runs(torch, label, res, base)

    kernel_res, launches = counted(
        "fused, pallas", {"fleet_window": N_WINDOWS,
                          "adaptbf_alloc": N_WINDOWS, "window_mega": 0},
        "fused", "pallas")
    plain_res = run("scan", "core")
    check_main_path(torch, "fused/pallas", kernel_res, inputs, cap_w)
    check_main_path(torch, "scan/core", plain_res, inputs, cap_w)
    first = first_window_err(kernel_res, plain_res)
    if first > 1e-3:
        raise AssertionError(f"first window: kernel path off by {first}")
    per_window, rel, same = compare("fused/pallas vs scan/core", kernel_res,
                                    plain_res)
    print(f"kernel path vs plain path: first window max |err| {first}; "
          f"alloc/record max |err| over all {N_WINDOWS} windows {per_window}; "
          f"horizon served per OST max rel err {rel}; bitwise equal: {same}; "
          "invariants hold on both")
    del plain_res
    # one window's observation at the main shape, for phase 5's fold
    fold_inputs = tuple(getattr(kernel_res, f)[-1].clone()
                        for f in ("served", "demand", "alloc"))

    mega_res, mega_launches = counted(
        "mega", {"fleet_window": 0, "adaptbf_alloc": 0,
                 "window_mega": N_WINDOWS}, "mega", "core")
    check_main_path(torch, "mega", mega_res, inputs, cap_w)
    per_window, rel, same = compare("mega vs fused/pallas", mega_res,
                                    kernel_res)
    print(f"mega path vs fused/pallas path: alloc/record max |err| over all "
          f"{N_WINDOWS} windows {per_window}; horizon served per OST max rel "
          f"err {rel}; bitwise equal: {same}; invariants hold")
    code = FLEET_CONTROL_CODES["adaptbf"]
    coded_res, _ = counted(
        f"mega, coded, code {code}", {"fleet_window": 0, "adaptbf_alloc": 0,
                                      "window_mega": N_WINDOWS},
        "mega", "core", "coded", code)
    for f in ("served", "demand", "alloc", "record", "queue_final"):
        if not torch.equal(getattr(coded_res, f), getattr(mega_res, f)):
            raise AssertionError(f"coded (code {code}) differs from direct "
                                 f"adaptbf in {f}")
    print(f"coded dispatch, code {code} (adaptbf), under mega: bitwise equal "
          "to direct adaptbf in served, demand, alloc, record, queue_final")

    lap("3 fleet main paths")
    # 3b. streaming telemetry and the online service ----------------------
    online = fleet_online(torch, dev, inputs, scn, run, counted, zero_counts,
                          counts, {"fused/pallas": kernel_res,
                                   "mega": mega_res, "coded": coded_res})
    del kernel_res, coded_res, mega_res
    torch.cuda.empty_cache()

    lap("3b streaming, service")
    # 3c. the tenant axis: many fleets in one run -------------------------
    tenants = tenant_phase(torch, dev, inputs, scn, counts, zero_counts,
                           names, card)
    torch.cuda.empty_cache()

    lap("3c tenants")
    # 3d. sharding: ost_shard and fleet_shard on torch.distributed ------
    shards = shard_phase(torch, dev, scn, card)
    torch.cuda.empty_cache()

    lap("3d sharding")
    # 3e. the LM serving path: zamba2-2.7b prefill and engine ------------
    lm = lm_main_path(torch, dev, counts, zero_counts)
    torch.cuda.empty_cache()

    lap("3e LM serving")
    # 3f. the LM training path: zamba2-2.7b loss_fn, gradients, AdamW ----
    train = lm_train_path(torch, dev, counts, zero_counts, card)
    torch.cuda.empty_cache()

    lap("3f LM training")
    # 3g. the MoE block and the frontends: moonshot, phi3.5-moe, hubert,
    # pixtral at full width ------------------------------------------------
    frontier = frontier_phase(torch, attn_ops, dev, counts, zero_counts, card)
    torch.cuda.empty_cache()

    lap("3g MoE, frontends")
    # 3h. the fleet main path on rows over clusters: wide-16k, wide-64k ---
    wide = wide_phase(torch, dev, counts, zero_counts, names, card)

    lap("3h rows over clusters")
    # 3i. sharded training on meshes of ranks, and the four examples -------
    sharded = train_shard_phase(torch, dev, card, lm, train)
    examples_phase(card)

    lap("3i sharded training, examples")
    # 4. times -----------------------------------------------------------
    fw_ms, al_ms, mega_ms = fleet_kernel_ms(fw_ops, alloc_ops, mega_ops,
                                            fw_args, al_args, mega_args)
    fw_plain = cuda_ms(lambda: fw_ops.fleet_window_ref(*fw_args), reps=3,
                       groups=3)
    al_plain = cuda_ms(lambda: alloc_ops.fleet_alloc_ref(*al_args), reps=3,
                       groups=3)
    mega_plain = cuda_ms(lambda: mega_ops.ref.mega_round_ref(*mega_args),
                         reps=3, groups=3)
    fa_ms = cuda_ms(lambda: attn_ops.attention(*fa_args), reps=20)
    fa_plain = cuda_ms(lambda: attn_ops.ref.mha(
        fa_args[0], *(attn_ops.ref.broadcast_kv(x, 32) for x in fa_args[1:])),
        reps=2, groups=3)
    fa_lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in fa_args), is_causal=True), reps=20)
    q, kc, vc, length = fd_args
    fd_ms = cuda_ms(lambda: attn_ops.decode_attention(q, kc, vc, length),
                    reps=20)
    fd_plain = cuda_ms(lambda: attn_ops.ref.decode_attention(
        q, kc, vc, length), reps=20)
    t_mask = (torch.arange(kc.shape[1], device=dev)[None, :]
              < length[:, None])[:, None, None, :]
    fd_lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=t_mask), reps=20)
    ssd_ms = cuda_ms(lambda: ssd_ops.ssd(*ssd_args[:5], d_skip=ssd_args[5]),
                     reps=20)
    ssd_plain = cuda_ms(lambda: ssd_ops.ref.ssd_chunked(
        *ssd_args[:5], d_skip=ssd_args[5]), reps=2, groups=3)
    fb_ms = cuda_ms(lambda: attn_ops.attention_bwd(*fb_args), reps=5,
                    groups=3)
    fb_plain = cuda_ms(lambda: attn_ops.ref.gqa_bwd(*fb_args, True), reps=1,
                       groups=3)
    fq, fk, fv = (x.transpose(1, 2).detach().requires_grad_()
                  for x in fb_args[:3])
    fdo = fb_args[5].transpose(1, 2)

    def sdpa_fwd():
        return torch.nn.functional.scaled_dot_product_attention(
            fq, fk, fv, is_causal=True)

    fb_lib_fb = cuda_ms(lambda: torch.autograd.grad(sdpa_fwd(), (fq, fk, fv),
                                                    fdo), reps=10)
    fb_lib_f = cuda_ms(sdpa_fwd, reps=10)
    fb_lib = fb_lib_fb - fb_lib_f
    fb_b, fb_by = bound_ms(*attention_bwd_work(TRAIN_B, TRAIN_S, 32, 80, 2),
                           BF16_OPS_S)
    del fq, fk, fv, fdo
    sb_in, sb_gy = sb_args
    before = ssd_ops.launches_bwd
    sb_ms = cuda_ms(lambda: ssd_ops.ssd_bwd(*sb_in, gy=sb_gy), reps=5,
                    groups=3)
    sb_calls = ssd_ops.launches_bwd - before
    sb_plain = cuda_ms(lambda: ssd_ops.ref.ssd_chunked_bwd(*sb_in, gy=sb_gy),
                       reps=1, groups=3)
    sb_f32_in = [None if t is None else t.float() for t in sb_in]
    sb_f32_gy = sb_gy.float()
    sb_f32 = cuda_ms(lambda: ssd_ops.ssd_bwd(*sb_f32_in, gy=sb_f32_gy),
                     reps=2, groups=3)
    del sb_f32_in, sb_f32_gy
    sb_b, sb_by = bound_ms(*ssd_bwd_work(TRAIN_B, TRAIN_S, 80, 64, 64, 2),
                           BF16_OPS_S)
    lens = [int(x) for x in length.tolist()]
    fa_b, fa_by = bound_ms(*attention_work(PREFILL_B, PREFILL_S, 32, 80, 2),
                           BF16_OPS_S)
    fd_b, fd_by = bound_ms(*decode_work(lens, 32, 32, 80, 4))
    ssd_b, ssd_by = bound_ms(*ssd_work(PREFILL_B, PREFILL_S, 80, 64, 64, 2),
                             BF16_OPS_S)
    rates, spread = {}, {}
    for serve, alloc, telemetry in (
            ("fused", "pallas", "trajectory"), ("mega", "core", "trajectory"),
            ("scan", "core", "trajectory"), ("fused", "pallas", "streaming"),
            ("mega", "core", "streaming")):
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            run(serve, alloc, telemetry=telemetry)
            secs.append(time.perf_counter() - t0)
        key = f"{serve}/{alloc}" + (", streaming" if telemetry == "streaming"
                                    else "")
        rates[key] = N_WINDOWS / statistics.median(secs)
        spread[key] = (N_WINDOWS / max(secs), N_WINDOWS / min(secs))
    time_wide_kernels(torch, fw_ops, alloc_ops, mega_ops, dev, card, wide,
                      clusters, n_sm)
    for label, *_ in WIDE_CELLS:
        for name, k in wide[label]["kernels"].items():
            k["max_abs_err"] = max(k["max_abs_err"], wide_err[name])
    s1_share = s1_sum_phase(torch, dev, fw_ops, fw_args, fw_ms, inputs, scn,
                            tenants, wide, card)
    fw_b, fw_by = bound_ms(*window_work(
        O, J, W, s1_share=s1_share[f"{O}x{J}"]["fixture"]))
    al_b, al_by = bound_ms(*alloc_work(O, J))
    mega_b, mega_by = bound_ms(*mega_work(O, J, W))
    card = _smi()
    print(f"kernel times at O={O} J={J} W={W} on {card}: fleet_window "
          f"{fw_ms:.4f} ms (plain {fw_plain:.4f} ms, bound {fw_b:.4f} ms); "
          f"adaptbf_alloc {al_ms:.4f} ms (plain {al_plain:.4f} ms, bound "
          f"{al_b:.4f} ms); window_mega (adaptbf) {mega_ms:.4f} ms (plain "
          f"{mega_plain:.4f} ms, bound {mega_b:.4f} ms by {mega_by})")
    print(f"main path windows/s at O={O} J={J} on {card} (median of 5 "
          f"runs, [slowest, fastest]): "
          + ", ".join(f"{k} {v:.2f} [{spread[k][0]:.2f}, {spread[k][1]:.2f}]"
                      for k, v in rates.items()))
    print(f"FleetService.step latency (streaming, {N_WINDOWS} windows, p50 / "
          f"p99 ms) on {card}: "
          + "; ".join(f"{lab} rates on the card {online[f'lat_{lab}_card'][0]:.3f}"
                      f" / {online[f'lat_{lab}_card'][1]:.3f}, as numpy (a "
                      f"{W * O * J * 4 / 1e6:.1f} MB copy a window) "
                      f"{online[f'lat_{lab}_numpy'][0]:.3f} / "
                      f"{online[f'lat_{lab}_numpy'][1]:.3f}"
                      for lab in ("fused/pallas", "mega")))
    print(f"LM kernel times on {card}: flash_attention (B={PREFILL_B} "
          f"S={PREFILL_S} H=32 D=80 causal bfloat16) {fa_ms:.4f} ms (plain "
          f"{fa_plain:.4f} ms, scaled_dot_product_attention {fa_lib:.4f} ms, "
          f"bound {fa_b:.4f} ms by {fa_by}); flash_decode (engine shape, 4 "
          f"slots, T=128, lengths {lens}, float32) {fd_ms:.4f} ms (plain "
          f"{fd_plain:.4f} ms, scaled_dot_product_attention {fd_lib:.4f} ms, "
          f"bound {fd_b:.5f} ms by {fd_by}); ssd_scan (B={PREFILL_B} "
          f"S={PREFILL_S} H=80 P=64 N=64 bfloat16) {ssd_ms:.4f} ms (plain "
          f"{ssd_plain:.4f} ms, bound {ssd_b:.4f} ms by {ssd_by})")
    print(f"LM training kernel times on {card}: flash_attention_bwd "
          f"(B={TRAIN_B} S={TRAIN_S} H=32 D=80 causal bfloat16) {fb_ms:.4f} "
          f"ms (plain {fb_plain:.4f} ms; scaled_dot_product_attention "
          f"forward+backward {fb_lib_fb:.4f} ms minus forward {fb_lib_f:.4f} "
          f"ms = {fb_lib:.4f} ms; bound {fb_b:.4f} ms by {fb_by}); "
          f"ssd_scan_bwd (B={TRAIN_B} S={TRAIN_S} H=80 P=64 N=64 bfloat16, "
          f"gy only) {sb_ms:.4f} ms (one call: the walk, the chunk kernel "
          f"and the reduction; {sb_calls} calls timed; plain reverse scan "
          f"{sb_plain:.4f} ms; the float32 SIMT kernel at the same shape "
          f"{sb_f32:.4f} ms; bound {sb_b:.4f} ms by {sb_by}; no single "
          f"PyTorch call computes it)")
    print(f"{LM_ARCH} training on {card}: B={TRAIN_B} S={TRAIN_S} bfloat16 "
          f"step {train['train_step_ms']:.1f} ms, "
          f"{train['train_tok_s']:.1f} train tokens/s; peak device memory "
          f"{train['train_peak_gib']:.2f} GiB")
    print(f"{LM_ARCH} on {card}: prefill (B={PREFILL_B} S={PREFILL_S}, "
          f"bfloat16) {lm['prefill_tok_s_kernel']:.1f} tokens/s on the "
          f"kernels, {lm['prefill_tok_s_plain']:.1f} on the plain path; "
          f"engine {lm['engine_tok_s']:.2f} generated tokens/s, "
          f"{lm['engine_answered']}/{SERVE['requests']} requests answered; "
          f"peak device memory {lm['prefill_peak_gib']:.2f} GiB over the "
          f"prefill runs, {lm['peak_gib']:.2f} GiB over the engine runs")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    lap("4 times")
    # 5. where the time goes: one run of each kernel path under the profiler
    main_trace = trace_fleet_cell(torch, dev, "main cell", inputs, O, J,
                                  N_WINDOWS, card)
    busy = main_trace.get("fused/pallas", {}).get("busy_ms_per_window")
    busy = None if busy is None else busy * N_WINDOWS
    if busy is not None:
        print(f"trace (fused/pallas): device busy {busy:.2f} ms, idle "
              f"share {main_trace['fused/pallas']['idle_share']:.3f}; with "
              f"the allocation at one block an SM "
              f"{ONE_BLOCK_FUSED_TRACE[0]} ms, {ONE_BLOCK_FUSED_TRACE[1]}")
    streaming = trace(torch, "fused/pallas, streaming",
                      lambda: run("fused", "pallas", telemetry="streaming"),
                      focus=("fleet_window", "adaptbf_alloc"))
    from repro_torch.storage import telemetry as tel
    stats0 = tel.init_stats(O, J, dev)
    cap_w_dev = inputs["cap"] * W

    def folds():
        stats = stats0
        for _ in range(N_WINDOWS):
            stats = tel.update_stats(stats, *fold_inputs, cap_w_dev)
        torch.cuda.synchronize()

    fold = trace(torch, "telemetry fold", folds,
                 what=f"{N_WINDOWS} folds at O={O} J={J}", top=12)
    fold_ms = cuda_ms(lambda: tel.update_stats(stats0, *fold_inputs,
                                               cap_w_dev), reps=20)
    if fold and streaming:
        (n1, t1), (n2, t2) = (streaming[2]["fleet_window"],
                              streaming[2]["adaptbf_alloc"])
        print(f"telemetry fold on {card}: {fold[0] / N_WINDOWS:.4f} ms of "
              f"device time a window (profiler; {fold_ms:.4f} ms a fold "
              f"between CUDA events) beside fleet_window "
              f"{t1 / max(n1, 1):.4f} ms and adaptbf_alloc "
              f"{t2 / max(n2, 1):.4f} ms a launch; streaming fused/pallas "
              f"device busy {streaming[0]:.2f} ms, idle share "
              f"{streaming[1]:.3f} (trajectory: "
              f"{busy if busy is not None else float('nan'):.2f} ms)")

    trace_wide(torch, dev, wide, card)

    lap("5 traces")
    kernels = [
        {"name": "fleet_window", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fleet_window.cu",
         "replaces": "src/repro/kernels/fleet_window/kernel.py:77",
         "launches": launches["fleet_window"], "max_abs_err": fw_err,
         "ms": fw_ms, "plain_ms": fw_plain, "bound_ms": fw_b,
         "bound_by": fw_by, "library_ms": None,
         "blocks_per_sm": occupancy["fleet_window"],
         "narrow_blocks_per_sm": occupancy["fleet_window_narrow"],
         "s1_sum_share": s1_share,
         **tenant_entry(tenants, "fleet_window", 0),
         "shard_launches_per_rank": shards["fleet_window"],
         **wide_entry(wide, "fleet_window")},
        {"name": "adaptbf_alloc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/adaptbf_alloc.cu",
         "replaces": "src/repro/kernels/adaptbf_alloc/kernel.py:135",
         "launches": launches["adaptbf_alloc"], "max_abs_err": al_err,
         "ms": al_ms, "plain_ms": al_plain, "bound_ms": al_b,
         "bound_by": al_by, "library_ms": None,
         "blocks_per_sm": occupancy["adaptbf_alloc"],
         "narrow_blocks_per_sm": occupancy["adaptbf_alloc_narrow"],
         **tenant_entry(tenants, "adaptbf_alloc", 1),
         "shard_launches_per_rank": shards["adaptbf_alloc"],
         **wide_entry(wide, "adaptbf_alloc")},
        {"name": "window_mega", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/window_mega.cu",
         "replaces": "src/repro/kernels/window_mega/kernel.py:168",
         "launches": mega_launches["window_mega"], "max_abs_err": mega_err,
         "ms": mega_ms, "plain_ms": mega_plain, "bound_ms": mega_b,
         "bound_by": mega_by, "library_ms": None,
         "blocks_per_sm": occupancy["window_mega"],
         "narrow_blocks_per_sm": occupancy["window_mega_narrow"],
         **tenant_entry(tenants, "window_mega", 2),
         "shard_launches_per_rank": shards["window_mega"],
         **wide_entry(wide, "window_mega")},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/attention/kernel.py:79",
         "launches": lm["prefill_launches_kernel"]["flash_attention"],
         "max_abs_err": fa_err, "ms": fa_ms, "plain_ms": fa_plain,
         "bound_ms": fa_b, "bound_by": fa_by, "library_ms": fa_lib,
         "train_launches": train["train_launches"]["flash_attention"],
         "sharded_train_launches_per_step": sharded["flash_attention"],
         **frontier_entry(frontier, "flash_attention", "launches")},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/attention/ref.py:76",
         "launches": train["train_launches"]["flash_attention_bwd"],
         "launches_per_step":
             train["train_launches_per_step"]["flash_attention_bwd"],
         "sharded_train_launches_per_step": sharded["flash_attention_bwd"],
         "max_abs_err": fb_err, "ms": fb_ms, "plain_ms": fb_plain,
         "bound_ms": fb_b, "bound_by": fb_by, "library_ms": fb_lib},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
         "replaces": "src/repro/kernels/ssd/ref.py:26",
         "launches": train["train_launches"]["ssd_scan_bwd"],
         "launches_per_step":
             train["train_launches_per_step"]["ssd_scan_bwd"],
         "sharded_train_launches_per_step": sharded["ssd_scan_bwd"],
         "device_kernels_per_call": ["ssd_bwd_walk_tc", "ssd_bwd_chunk_tc",
                                     "ssd_bwd_reduce"],
         "max_abs_err": sb_err, "ms": sb_ms, "plain_ms": sb_plain,
         "float32_ms": sb_f32, "bound_ms": sb_b, "bound_by": sb_by,
         "library_ms": None,
         "blocks_per_sm": {k: occupancy[k] for k in ("ssd_bwd_walk_tc",
                                                     "ssd_bwd_chunk_tc")}},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/attention/kernel.py:184",
         "launches": lm["engine_launches"]["flash_decode"],
         "max_abs_err": fd_err, "ms": fd_ms, "plain_ms": fd_plain,
         "bound_ms": fd_b, "bound_by": fd_by, "library_ms": fd_lib,
         **fd_long, **frontier_entry(frontier, "flash_decode",
                                     "engine_launches")},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd/kernel.py:78",
         "launches": lm["prefill_launches_kernel"]["ssd_scan"],
         "max_abs_err": ssd_err, "ms": ssd_ms, "plain_ms": ssd_plain,
         "bound_ms": ssd_b, "bound_by": ssd_by, "library_ms": None,
         "train_launches": train["train_launches"]["ssd_scan"],
         "sharded_train_launches_per_step": sharded["ssd_scan"]},
    ]
    print(f"seconds by phase on {card}: "
          + ", ".join(f"{label} {t - laps[i][1]:.1f}"
                      for i, (label, t) in enumerate(laps[1:]))
          + f"; {laps[-1][1] - laps[0][1]:.1f} in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
