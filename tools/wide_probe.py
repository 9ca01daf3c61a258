#!/usr/bin/env python3
"""The fleet kernels' instances over thread-block clusters (rows of
8192 < J <= 65536) on one GPU, built from whichever ``repro_torch`` is on
``PYTHONPATH``, so that two builds can be compared within one call.

    PYTHONPATH=src python tools/wide_probe.py [--json OUT] [--main]
    PYTHONPATH=build/parent/src python tools/wide_probe.py ...   # another tree

For the package found first on the path it builds B1-B3 (``fleet_window``,
``adaptbf_alloc``, ``window_mega``; each tree builds into its own
``build/``), prints the wide instances' registers, spills and resident
clusters (``chip_smoke.wide_build_summary``), then for each wide cell of
``chip_smoke.py`` (wide-16k: 256 x 16384 over clusters of 2; wide-64k: 64
x 65536 over clusters of 8):

- ``chip_smoke.time_wide_cell`` at the cell's fixtures: allocations equal
  to the plain versions', two calls of B2 and B3 bitwise equal, every
  field within its bound, each kernel timed (CUDA events) beside its
  bound;
- the cell's fleet (``random_fleet(0, ...)``, as phase 3h builds it):
  fused/pallas (B1, B2) and mega (B3) held against each other
  (``chip_smoke.compare_runs``), windows/s of each
  (``chip_smoke.fleet_rates``, median of 3 runs), and one run of each
  under ``torch.profiler`` (``chip_smoke.trace_fleet_cell``): the device
  time a launch of each kernel inside the fleet's own windows, and the
  host time, device busy time and idle share a window.

Before the cells, what a cluster reduction costs against a block's
(``chip_smoke.cluster_reduction_cost``); with ``--main``, after them, the
J=4096 main cell's windows/s under fused/pallas and mega (5 runs each).

The last line of standard output is one JSON object of these numbers,
with the card's name and power limit; ``--json`` also writes it to a file.
Needs a CUDA device and the CUDA toolkit, and nothing of JAX."""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))      # chip_smoke's helpers (it imports no package)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--main", action="store_true",
                    help="also the J=4096 main cell's windows/s")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this probe needs one GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
    from repro_torch.kernels.dispatch import cluster_size
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.kernels.window_mega import ops as mega_ops

    dev = torch.device("cuda")
    card = cs._smi()
    pkg = str(Path(repro_torch.__file__).resolve().parent)
    t0 = time.perf_counter()
    libs = _build.build(["fleet_window", "adaptbf_alloc", "window_mega"])
    print(f"package {pkg} on {card}; built in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(str(p) for p in libs.values()))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = cs.wide_build_summary(libs, n_sm)
    out = dict(package=pkg, card=card, libs={k: str(v) for k, v in libs.items()},
               clusters=clusters, cells={})
    out["reduction_cost"] = cs.cluster_reduction_cost(torch, fw_ops, dev, card,
                                                      clusters, n_sm)
    for label, o, j, n_win in cs.WIDE_CELLS:
        cell = out["cells"][label] = dict(o=o, j=j, c=cluster_size(j))
        cell["kernels"] = k = cs.time_wide_cell(torch, fw_ops, alloc_ops,
                                                mega_ops, dev, o, j, label)
        print(f"{label} fixtures on {card}: "
              + "; ".join(f"{name} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}"
                          f", {t['ms'] / t['bound_ms']:.1f}x; plain "
                          f"{t['plain_ms']:.4f}; max |err| {t['max_abs_err']})"
                          for name, t in k.items()))
        scn, inputs = cs.wide_fleet(torch, dev, o, j)
        del scn
        fused = cs.fleet_run(torch, dev, inputs, "fused", "pallas",
                             n_windows=n_win)
        mega = cs.fleet_run(torch, dev, inputs, "mega", "core",
                            n_windows=n_win)
        per_window, rel, same = cs.compare_runs(
            torch, f"{label}: mega vs fused/pallas", mega, fused)
        print(f"{label}: mega vs fused/pallas: alloc/record max |err| "
              f"{per_window}, horizon served rel {rel}, bitwise {same}")
        del fused, mega
        rates = {k: statistics.median(v) for k, v in
                 cs.fleet_rates(torch, dev, inputs, n_win).items()}
        traced = cs.trace_fleet_cell(torch, dev, label, inputs, o, j, n_win,
                                     card)
        cell.update(rates=rates, trace=traced, bitwise=same)
        print(f"{label} windows/s on {card} (median of 3): "
              + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))
        del inputs
        torch.cuda.empty_cache()
    if args.main:
        scn, inputs = cs.wide_fleet(torch, dev, cs.O, cs.J)
        del scn
        out["main"] = cs.fleet_rates(torch, dev, inputs, cs.N_WINDOWS,
                                     runs=5)
        print(f"main cell (O={cs.O} J={cs.J}, {cs.N_WINDOWS} windows) "
              f"windows/s on {card}, median [slowest, fastest] of 5: "
              + ", ".join(f"{k} {v[2]:.2f} [{v[-1]:.2f}, {v[0]:.2f}]"
                          for k, v in out["main"].items()))
        del inputs
    line = json.dumps(out)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
