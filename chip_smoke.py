#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, each of which raises on failure (the run then exits non-zero):

1. Build both CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, on
   seeded fixtures at the main path's shapes (O=256 OSTs, J=4096 jobs,
   W=10 ticks per window); the allocation over chained rounds, so its
   remainder carry is read and checked too.
3. Drive the main path: ``simulate_fleet`` under AdapTBF with
   ``serve_backend="fused"`` and ``alloc_backend="pallas"`` on a seeded
   256-OST x 4096-job fleet (``random_fleet(0, profile="mixed")``, 20
   windows of trace tiled to 60), count the kernel launches, and compare
   with the plain ``("scan", "core")`` run of the same fleet on the card:
   the first window, alloc and record in every window, and per-OST
   horizon service.
4. Time each kernel and its plain version with CUDA events, and both
   main-path configurations in windows per second.
5. Trace one kernel-path run with ``torch.profiler``: device busy time,
   idle share and device time by kernel.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is a JSON object with one entry per kernel.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

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


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


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


def window_work(o, j, w):
    """(bytes, operations) one window's service must move and do: every
    input read once ([W, O, J] rates, four [O, J] arrays, [O] capacity),
    every output written once (three [O, J]); about 24 float operations per
    lane per tick (issue 6, phase 1 8, phase 2 6, update 4)."""
    return 4 * ((w + 7) * o * j + o), 24 * w * o * j


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


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / FP32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


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


def check_main_path(torch, name, res, inputs, cap_w):
    """The invariants, in float64: finite outputs of the expected shape; no
    negative queue, service or allocation; per-OST served <= cap_w;
    moved <= offered; moved <= volume."""
    for field in ("served", "demand", "alloc", "record"):
        x = getattr(res, field)
        if tuple(x.shape) != (N_WINDOWS, O, J):
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
    offered = (inputs["rates"].sum(0, dtype=torch.float64)
               * (N_WINDOWS // inputs["trace_windows"]))
    if (moved > offered + 1e-2).any():
        raise AssertionError(f"{name}: served more than offered")
    vol = inputs["volume"].double()
    if (vol.isfinite() & (moved > vol + 1e-2)).any():
        raise AssertionError(f"{name}: served more than a job's volume")


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
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.storage import FleetConfig, random_fleet, simulate_fleet

    dev = torch.device(DEVICE)
    card = _smi()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build(["fleet_window", "adaptbf_alloc"])
    print(f"build: {time.perf_counter() - t0:.1f} s (both kernels, nvcc "
          "in parallel)")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        for line in lines:
            lpt = re.search(r"entry function .*_kernelILi(\d+)E", line)
            if lpt:                              # the template argument
                print(f"  {name}, {lpt.group(1)} lanes a thread:")
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 2. each kernel against its plain version, at the main path's shapes
    fw_args, fw_err = check_window_kernel(torch, fw_ops, dev)
    al_args, al_err = check_alloc_kernel(torch, alloc_ops, dev)

    # 3. the main path ---------------------------------------------------
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

    def run(serve, alloc):
        cfg = FleetConfig(control="adaptbf", serve_backend=serve,
                          alloc_backend=alloc)
        res = simulate_fleet(cfg, inputs["nodes"], inputs["rates"],
                             inputs["volume"], inputs["cap"],
                             inputs["backlog"], n_windows=N_WINDOWS,
                             device=dev)
        torch.cuda.synchronize()
        return res

    fw_ops.launches = alloc_ops.launches = 0
    kernel_res = run("fused", "pallas")
    launches = {"fleet_window": fw_ops.launches,
                "adaptbf_alloc": alloc_ops.launches}
    print(f"main path (fused, pallas), {N_WINDOWS} windows: launches "
          f"{launches}")
    for name, n in launches.items():
        if n != N_WINDOWS:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{N_WINDOWS} (one per window)")
    plain_res = run("scan", "core")
    check_main_path(torch, "fused/pallas", kernel_res, inputs, cap_w)
    check_main_path(torch, "scan/core", plain_res, inputs, cap_w)
    first = max(float((getattr(kernel_res, f)[0].double()
                       - getattr(plain_res, f)[0].double()).abs().nan_to_num(0.0).max())
                for f in ("served", "demand", "record"))
    if first > 1e-3:
        raise AssertionError(f"first window: kernel path off by {first}")
    # the integer token state, every window: alloc and record are
    # integer-valued, and alloc reads the remainder carried from window to
    # window, so a wrong carry shows here; held while the closed loop has
    # not forked (it has not on this fleet: the paths agree bitwise)
    per_window = 0.0
    for f in ("alloc", "record"):
        k, p = getattr(kernel_res, f), getattr(plain_res, f)
        if not torch.equal(k.isinf(), p.isinf()):
            raise AssertionError(f"{f}: unruled masks differ between paths")
        fin = k.isfinite()
        e = float((k[fin].double() - p[fin].double()).abs().max())
        if e > 1e-3:
            raise AssertionError(f"{f}: kernel path off by {e} in some window")
        per_window = max(per_window, e)
    k_tot = kernel_res.served.double().sum((0, 2))
    p_tot = plain_res.served.double().sum((0, 2))
    rel = float(((k_tot - p_tot).abs() / p_tot.clamp_min(1.0)).max())
    if rel > 1e-3:
        raise AssertionError(f"horizon served per OST off by {rel} relative")
    same = {f: bool(torch.equal(getattr(kernel_res, f), getattr(plain_res, f)))
            for f in ("served", "demand", "alloc", "record", "queue_final")}
    print(f"kernel path vs plain path: first window max |err| {first}; "
          f"alloc/record max |err| over all {N_WINDOWS} windows {per_window}; "
          f"horizon served per OST max rel err {rel}; bitwise equal: {same}; "
          "invariants hold on both")
    del kernel_res, plain_res

    # 4. times -----------------------------------------------------------
    fw_ms = cuda_ms(lambda: fw_ops.fleet_window_serve(*fw_args), reps=20)
    fw_plain = cuda_ms(lambda: fw_ops.fleet_window_ref(*fw_args), reps=3,
                       groups=3)
    al_ms = cuda_ms(lambda: alloc_ops.fleet_alloc(*al_args), reps=20)
    al_plain = cuda_ms(lambda: alloc_ops.fleet_alloc_ref(*al_args), reps=3,
                       groups=3)
    rates = {}
    for serve, alloc in (("fused", "pallas"), ("scan", "core")):
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(serve, alloc)
            secs.append(time.perf_counter() - t0)
        rates[f"{serve}/{alloc}"] = N_WINDOWS / statistics.median(secs)
    card = _smi()
    print(f"kernel times at O={O} J={J} W={W} on {card}: fleet_window "
          f"{fw_ms:.4f} ms (plain {fw_plain:.4f} ms); adaptbf_alloc "
          f"{al_ms:.4f} ms (plain {al_plain:.4f} ms)")
    print(f"main path windows/s at O={O} J={J} on {card}: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5. where the time goes: one kernel-path run under torch.profiler ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run("fused", "pallas")
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): a CPU op's row repeats
    # the device time of the kernels it launched
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0}
    busy = sum(device_us.values()) / 1e6
    if busy == 0:
        print("trace: the profiler recorded no device time (not measured)")
    else:
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
        print(f"trace (fused/pallas, {N_WINDOWS} windows, {wall * 1e3:.1f} ms "
              f"wall under the profiler): device busy {busy * 1e3:.2f} ms, "
              f"idle share {1 - busy / wall:.3f}; device time by kernel: "
              + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))

    fw_b, fw_by = bound_ms(*window_work(O, J, W))
    al_b, al_by = bound_ms(*alloc_work(O, J))
    kernels = [
        {"name": "fleet_window", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fleet_window.cu",
         "replaces": "src/repro/kernels/fleet_window/kernel.py:77",
         "launches": launches["fleet_window"], "max_abs_err": fw_err,
         "ms": fw_ms, "plain_ms": fw_plain, "bound_ms": fw_b,
         "bound_by": fw_by, "library_ms": None},
        {"name": "adaptbf_alloc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/adaptbf_alloc.cu",
         "replaces": "src/repro/kernels/adaptbf_alloc/kernel.py:135",
         "launches": launches["adaptbf_alloc"], "max_abs_err": al_err,
         "ms": al_ms, "plain_ms": al_plain, "bound_ms": al_b,
         "bound_by": al_by, "library_ms": None},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
