"""Fleet-scale decentralized bandwidth control, end to end.

Part 1 drives the full multi-OST storage simulator (``simulate_fleet``) on
the noisy-neighbor scenario from the registry, under every control policy
in the registry (``repro_torch.storage.list_policies()``) -- the paper's
trio plus the work-conserving static variant and the AIMD feedback
throttler.  Every OST runs its policy independently -- no cross-OST
communication -- yet under adaptbf the noisy job is confined to its 1-node
share on its own stripe set while the fleet stays near fully utilized.

Part 2 shows the raw allocator at leadership-class scale (1024 OSTs x 256
jobs in one device call) through the allocation kernel's wrapper: on a
CUDA device one launch of ``adaptbf_alloc`` a window.

Run:  PYTHONPATH=src python -m repro_torch.examples.fleet_allocation
      [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.kernels.adaptbf_alloc import ops
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.storage import (FleetConfig, get_scenario, list_policies,
                                 metrics, simulate_fleet, utilization)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--duration-s", type=float, default=20.0)
    ap.add_argument("--osts", type=int, default=1024)
    ap.add_argument("--jobs", type=int, default=256)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # -------------------------------------------- part 1: fleet simulation
    scn = get_scenario("fleet_noisy_neighbor", duration_s=args.duration_s)
    print(f"scenario {scn.name}: {scn.n_ost} OSTs x {scn.nodes.shape[0]} "
          f"jobs, {scn.issue_rate.shape[0]} ticks; policies: "
          f"{list_policies()}")
    results = {}
    for control in list_policies():
        cfg = FleetConfig(control=control)
        res = simulate_fleet(cfg, scn.nodes, scn.issue_rate, scn.volume,
                             scn.capacity_per_tick, scn.max_backlog,
                             device=dev)
        served = res.served.cpu().numpy()
        results[control] = served
        util = np.asarray(utilization(res, cfg, scn.capacity_per_tick))
        per_job = served.sum(axis=(0, 1))
        noisy_share = per_job[-1] / per_job.sum()
        print(f"  {control:8s} | fleet util {util.mean():5.1%} | "
              f"noisy job share {noisy_share:5.1%} | "
              f"fairness (Jain, priority-normalized) "
              f"{metrics.fairness(served.sum(axis=1), scn.nodes):.3f}")

    ad, nb = results["adaptbf"], results["nobw"]
    noisy_osts = ad.sum(axis=0)[:, -1] > 0   # the OSTs it stripes on
    print(f"noisy job runs on OSTs {np.flatnonzero(noisy_osts).tolist()}; "
          f"AdapTBF cuts its take there from "
          f"{nb[:, noisy_osts, -1].sum() / nb[:, noisy_osts].sum():.1%} "
          f"(No BW) to "
          f"{ad[:, noisy_osts, -1].sum() / ad[:, noisy_osts].sum():.1%} "
          f"of those targets' traffic -- decided by those OSTs alone.")

    # ---------------------------------- part 2: raw allocator at 1024 OSTs
    n_ost, n_jobs, capacity = args.osts, args.jobs, 20000.0
    rng = np.random.default_rng(0)

    def on(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    nodes = on(rng.integers(1, 512, (n_ost, n_jobs)))
    record = torch.zeros((n_ost, n_jobs), device=dev)
    remainder = torch.zeros((n_ost, n_jobs), device=dev)
    alloc_prev = torch.zeros((n_ost, n_jobs), device=dev)
    cap = torch.full((n_ost,), capacity, device=dev)

    print(f"\nraw allocator: {n_ost} OSTs x {n_jobs} jobs, "
          f"{capacity:.0f} tokens/window/OST on {dev}")
    for window in range(3):
        # bursty demand: ~30% of jobs active per OST per window
        demand = on(rng.integers(0, 4000, (n_ost, n_jobs))
                    * (rng.random((n_ost, n_jobs)) < 0.3))
        _sync(dev)
        t0 = time.perf_counter()
        alloc, record, remainder = ops.fleet_alloc(
            demand, nodes, record, remainder, alloc_prev, cap)
        _sync(dev)
        dt = time.perf_counter() - t0
        alloc_prev = alloc
        # fleet-wide totals in f64 on host: 20.48M tokens is past f32's
        # exact integer range, so an f32 reduction would misreport
        # conservation
        total = alloc.cpu().numpy().astype(np.float64).sum()
        print(f"window {window}: {dt*1e3:7.1f} ms "
              f"({dt/n_ost*1e6:5.1f} us/OST) | "
              f"tokens allocated {total:.0f} "
              f"(= {n_ost}x{capacity:.0f}: "
              f"{'OK' if abs(total - n_ost*capacity) < 1 else 'VIOLATION'})"
              f" | record zero-sum max err "
              f"{float(record.sum(dim=1).abs().max()):.3f}")

    print("\nwork conservation + record conservation hold on every storage "
          "target, every window -- with zero cross-OST communication.")


if __name__ == "__main__":
    main()
