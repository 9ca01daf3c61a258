#!/usr/bin/env python3
"""B2 (``adaptbf_alloc``) and B3 (``window_mega``, adaptbf) on narrow rows,
on one GPU.

    PYTHONPATH=src python tools/narrow_probe.py --device [--json OUT]
    PYTHONPATH=<tree>/src python tools/narrow_probe.py --rates [--json OUT]

``--device`` (this tree's package): at the small tenants' shape (fleets of
O=4 OSTs x J=8 jobs; 16, 256 and 1024 fleets: 64, 1024 and 4096 rows) each
kernel is launched by its C entry with the arguments its wrapper passes
(``chip_smoke.captured``, ``chip_smoke.replay``), 20 times each under
``torch.profiler`` beside its one-block instance (``*_one_block``) and an
empty kernel over the warp rows' grid: the device time a launch of each.

``--rates`` (whichever ``repro_torch`` is first on ``PYTHONPATH``, through
its public entry points only, so that a parent tree is timed the same
way): the small tenants' batched fleet-windows/s under fused/pallas and
mega/pallas (``chip_smoke.small_tenant_rate``, as phase 3c), B1-B3's time
a call of the wrappers at those rows (``chip_smoke.time_fleet_launches``)
and at the main cell's fixtures (O=256, J=4096;
``chip_smoke.fleet_kernel_ms``, as phase 4).

Prints a line a measurement and the card's name and power limit;
``--json`` writes the numbers."""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))          # chip_smoke.py
sys.path.append(str(ROOT / "src"))     # repro_torch unless PYTHONPATH names one

import chip_smoke as cs  # noqa: E402

NAMES = ("adaptbf_alloc", "window_mega")


def device_times(torch, dev, card):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    floor = _build.load("launch_floor", [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates, cap, nodes_all, _ = cs.small_tenant_inputs(torch, dev)
    rows_a_block = cs.warp_rows()
    out = {}
    for n_f in cs.SMALL["fleets"]:
        rows = n_f * cs.SMALL["o"]
        calls, _ = cs.fleet_launch_calls(torch, dev, n_f, rates[:cs.W], cap,
                                         nodes_all[:n_f])
        made = {name: cs.captured(call)[0]
                for name, call in zip(NAMES, calls[1:])}
        warp = {name: cs.replay(m) for name, m in made.items()}
        one = {name: cs.replay(m, "_one_block") for name, m in made.items()}
        blocks = -(-rows // rows_a_block)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                for name in NAMES:
                    warp[name]()
                    one[name]()
                floor(blocks, rows_a_block * 32, stream)
            torch.cuda.synchronize()
        dev_us = {}
        for e in prof.key_averages():
            key = e.key
            kind = ("RowWarp" if "RowWarp" in key else "one block"
                    if "RowBlock" in key else "empty" if "empty_kernel" in key
                    else None)
            if kind is None:
                continue
            base = next((n for n in NAMES if n in key), "")
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            dev_us[f"{base} {kind}".strip()] = (total / max(e.count, 1),
                                                e.count)
        out[rows] = dev_us
        print(f"narrow rows at {rows} rows of J={cs.SMALL['j']}, device us a "
              "launch (profiler, launches seen): "
              + "; ".join(f"{k} {v[0]:.2f} ({v[1]})" for k, v in dev_us.items())
              + f" on {card}")
    return out


def rates_and_main(torch, dev, card):
    from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.kernels.window_mega import ops as mega_ops
    from repro_torch.storage import FleetConfig
    inputs = cs.small_tenant_inputs(torch, dev)
    rates, cap, nodes_all, _ = inputs
    out = {"fleet_windows_s": {}, "wrapper_ms": {}}
    for label, (serve, alloc) in (("fused/pallas", ("fused", "pallas")),
                                  ("mega/pallas", ("mega", "pallas"))):
        cfg = FleetConfig(serve_backend=serve, alloc_backend=alloc,
                          telemetry="streaming")
        for n_f in cs.SMALL["fleets"]:
            out["fleet_windows_s"][f"{label} F={n_f}"] = cs.small_tenant_rate(
                torch, dev, cfg, inputs, n_f)
    for n_f in cs.SMALL["fleets"]:
        out["wrapper_ms"][n_f * cs.SMALL["o"]] = cs.time_fleet_launches(
            torch, dev, n_f, rates[:cs.W], cap, nodes_all[:n_f])
    fw_args, _ = cs.check_window_kernel(torch, fw_ops, dev)
    al_args, _ = cs.check_alloc_kernel(torch, alloc_ops, dev)
    mega_args, _ = cs.check_mega_kernel(torch, mega_ops, dev)
    out["main_ms"] = dict(zip(("fleet_window", "adaptbf_alloc", "window_mega"),
                              cs.fleet_kernel_ms(fw_ops, alloc_ops, mega_ops,
                                                 fw_args, al_args, mega_args)))
    print("small tenants, batched fleet-windows/s (streaming adaptbf, "
          f"median of 3): " + "; ".join(
              f"{k} {v:.1f}" for k, v in out["fleet_windows_s"].items())
          + "; B1/B2/B3 ms a wrapper call by rows: " + "; ".join(
              f"{r}: " + ", ".join(f"{x:.4f}" for x in v)
              for r, v in out["wrapper_ms"].items())
          + f"; at O={cs.O} J={cs.J}: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in out["main_ms"].items())
          + f" on {card}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--rates", action="store_true")
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this probe needs one GPU", file=sys.stderr)
        return 1
    import repro_torch
    dev = torch.device("cuda")
    card = cs._smi()
    out = {"card": card, "package": str(Path(repro_torch.__file__).parent)}
    if args.device:
        out["device_us"] = device_times(torch, dev, card)
    if args.rates:
        out["rates"] = rates_and_main(torch, dev, card)
    if args.json:
        args.json.write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
