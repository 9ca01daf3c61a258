#!/usr/bin/env python3
"""The fleet kernels, B1 (``fleet_window``), B2 (``adaptbf_alloc``) and B3
(``window_mega``), on narrow rows and at the cells B1's tick serves, on one
GPU; a parent tree is measured the same way and its outputs compared.

    PYTHONPATH=src python tools/narrow_probe.py --device [--json OUT]
    PYTHONPATH=<tree>/src python tools/narrow_probe.py --rates [--json OUT]
    PYTHONPATH=<tree>/src python tools/narrow_probe.py --cells [--json OUT]
    PYTHONPATH=<tree>/src python tools/narrow_probe.py --trace [--json OUT]
    PYTHONPATH=<tree>/src python tools/narrow_probe.py --outputs DIR
    python tools/narrow_probe.py --compare DIR_A DIR_B

``--device`` (this tree's package): at the small tenants' shape (fleets of
O=4 OSTs x J=8 jobs; 16, 256 and 1024 fleets: 64, 1024 and 4096 rows) each
kernel is launched by its C entry with the arguments its wrapper passes
(``chip_smoke.captured``, ``chip_smoke.replay``), 20 times each under
``torch.profiler`` beside its one-block instance (``*_one_block``) and an
empty kernel over the warp rows' grid: the device time a launch of each.

``--cells`` (whichever ``repro_torch`` is first on ``PYTHONPATH``, through
its public entry points): B1-B3's time a wrapper call (CUDA events, 20
calls, median of 5) at the main cell's fixtures (256 x 4096;
``chip_smoke.fleet_kernel_ms``), over the 16 tenant fleets' 4096 rows and
the small tenants' 4096 (``chip_smoke.time_fleet_launches``), at the wide
cells' fixtures (``chip_smoke.time_wide_cell``); and B3 at every instance
the wrappers launch: each built-in policy, at J of 8 (one warp a row), 100,
1024, 2048, 4096 and 8192 (one block a row at 1, 2, 4, 8 and 16 lanes a
thread), 16384 and 65536 (clusters of 2 and 8), one fleet and two fleets
(a shared trace), about 2^20 lanes a launch.

``--trace``: B1's, B2's and B3's device time a launch inside the fleets'
own windows (``torch.profiler``): the main cell's 60 windows and the wide
cells' (``chip_smoke.trace_fleet_cell``: fused/pallas and mega/core), and
the 16 tenant fleets' 4096 rows (60 windows, coded, streaming,
fused/pallas and mega/pallas).

``--outputs DIR``: B1's and B3's outputs as ``.npy`` files: one call of
each at the fixtures above; and every result leaf of 60 windows of the
main cell (``random_fleet(0, 256, 4096)``; 20 at wide-64k) under
fused/pallas and mega/core, of the 16 tenant fleets (coded, their codes)
and of wide-16k and wide-64k under fused/pallas and mega/pallas, and of
the 1024 small tenants (20 windows), all in streaming telemetry.
``--compare`` holds two such directories bitwise, file by file, and exits
1 on a difference or a missing file.

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

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))          # chip_smoke.py
sys.path.append(str(ROOT / "src"))     # repro_torch unless PYTHONPATH names one

import chip_smoke as cs  # noqa: E402

NAMES = ("fleet_window", "adaptbf_alloc", "window_mega")
#: B3's instances timed by ``--cells``: row widths and rows a launch
MEGA_WIDTHS = ((8, 4096), (100, 4096), (1024, 1024), (2048, 512),
               (4096, 256), (8192, 128), (16384, 64), (65536, 16))


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
                for name, call in zip(NAMES, calls)}
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


def mega_instances(torch, dev):
    """B3 (``mega_window_round``) a call at each policy x ``MEGA_WIDTHS`` x
    one fleet or two fleets sharing a trace (``chip_smoke.mega_case``):
    {"policy J rows fleets": ms}."""
    from repro_torch.core.policies import get_policy
    from repro_torch.kernels.window_mega import ops as mega_ops
    out = {}
    for name in ("adaptbf", "static", "nobw", "static_wc", "aimd"):
        policy = get_policy(name)
        for j, o in MEGA_WIDTHS:
            m_in, rng = cs.mega_case(torch, policy, o, j, cs.W, seed=j + o,
                                     dev=dev)
            ctx, cap_tick, backlog, queue, vol, alloc, held, pstate = m_in
            for fleets in (1, 2):
                rates = torch.as_tensor(rng.integers(
                    0, 3, (cs.W, o // fleets, j)).astype(np.float32),
                    device=dev)
                if fleets > 1:
                    rates = rates.expand(fleets, *rates.shape)
                args = (policy, ctx, cap_tick, backlog, queue, vol, alloc,
                        held, pstate, rates)
                out[f"{name} J={j} rows={o} fleets={fleets}"] = cs.cuda_ms(
                    lambda: mega_ops.mega_window_round(*args), reps=20)
            del m_in, args, rates
    torch.cuda.empty_cache()
    return out


def main_scenario(torch, dev):
    """The main cell's fleet on the card (``random_fleet(0, 256, 4096)``)
    as ``chip_smoke.fleet_run`` takes it, and the scenario."""
    from repro_torch.storage import random_fleet
    scn = random_fleet(0, n_ost=cs.O, n_jobs=cs.J, profile="mixed",
                       duration_s=2.0)
    inputs = dict(nodes=torch.as_tensor(scn.nodes, device=dev),
                  rates=torch.as_tensor(scn.issue_rate, device=dev),
                  volume=torch.as_tensor(scn.volume, device=dev),
                  cap=torch.as_tensor(scn.capacity_per_tick, device=dev),
                  backlog=torch.as_tensor(scn.max_backlog, device=dev))
    return scn, inputs


def tenant_fixture(torch, dev, scn, inputs):
    """The 16 tenant fleets' nodes and volumes and B1-B3's calls over their
    4096 rows (``chip_smoke.fleet_launch_calls``, the trace's first
    window)."""
    nodes, volume = (torch.as_tensor(x, device=dev) for x in
                     cs.wide_tenant_inputs(scn, cs.TENANT_F, cs.O))
    calls, _ = cs.fleet_launch_calls(torch, dev, cs.TENANT_F,
                                     inputs["rates"][:cs.W], inputs["cap"],
                                     nodes)
    return nodes, volume, calls


def cells(torch, dev, card):
    from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.kernels.window_mega import ops as mega_ops
    names = ("fleet_window", "adaptbf_alloc", "window_mega")
    out = {}
    fw_args, _ = cs.check_window_kernel(torch, fw_ops, dev)
    al_args, _ = cs.check_alloc_kernel(torch, alloc_ops, dev)
    mega_args, _ = cs.check_mega_kernel(torch, mega_ops, dev)
    out[f"{cs.O}x{cs.J}"] = dict(zip(names, cs.fleet_kernel_ms(
        fw_ops, alloc_ops, mega_ops, fw_args, al_args, mega_args)))
    del fw_args, al_args, mega_args
    scn, inputs = main_scenario(torch, dev)
    out[f"{cs.TENANT_F * cs.O}x{cs.J}"] = dict(zip(names, cs.time_fleet_launches(
        torch, dev, cs.TENANT_F, inputs["rates"][:cs.W], inputs["cap"],
        tenant_fixture(torch, dev, scn, inputs)[0])))
    del scn, inputs
    rates, cap, nodes_all, _ = cs.small_tenant_inputs(torch, dev)
    n_f = max(cs.SMALL["fleets"])
    out[f"{n_f * cs.SMALL['o']}x{cs.SMALL['j']}"] = dict(zip(
        names, cs.time_fleet_launches(torch, dev, n_f, rates[:cs.W], cap,
                                      nodes_all[:n_f])))
    for label, o, j, _ in cs.WIDE_CELLS:
        got = cs.time_wide_cell(torch, fw_ops, alloc_ops, mega_ops, dev, o, j,
                                label)
        out[label] = {name: k["ms"] for name, k in got.items()}
    torch.cuda.empty_cache()
    out["window_mega instances"] = mega_instances(torch, dev)
    print(f"B1/B2/B3 ms a wrapper call on {card}: " + "; ".join(
        f"{cell}: " + ", ".join(f"{k} {v:.5f}" for k, v in t.items())
        for cell, t in out.items() if cell != "window_mega instances"))
    print(f"window_mega ms a call by instance on {card}: " + "; ".join(
        f"{k} {v:.5f}" for k, v in out["window_mega instances"].items()))
    return out


def traces(torch, dev, card):
    """``--trace``: see the module's docstring.  Returns {cell: {path:
    {kernel: us a launch}}}."""
    from repro_torch.storage import FleetConfig, simulate_tenants
    out = {}

    def per_launch(cell):
        return {key: got["us_per_launch"] for key, got in cell.items()}

    scn, inputs = main_scenario(torch, dev)
    out[f"{cs.O}x{cs.J}"] = per_launch(cs.trace_fleet_cell(
        torch, dev, "main cell", inputs, cs.O, cs.J, cs.N_WINDOWS, card))
    nodes, volume, _ = tenant_fixture(torch, dev, scn, inputs)
    tenants = {}
    for serve, focus in (("fused", ("fleet_window", "adaptbf_alloc")),
                         ("mega", ("window_mega",))):
        cfg = FleetConfig(control="coded", serve_backend=serve,
                          alloc_backend="pallas", telemetry="streaming")

        def run():
            simulate_tenants(cfg, nodes, inputs["rates"], volume,
                             inputs["cap"], inputs["backlog"],
                             control_code=cs.TENANT_CODES,
                             n_windows=cs.N_WINDOWS, device=dev)
            torch.cuda.synchronize()

        run()
        got = cs.trace(torch, f"tenants {serve}", run,
                       what=f"{cs.TENANT_F} fleets, {cs.N_WINDOWS} windows",
                       focus=focus)
        if got is not None:
            tenants[serve] = {k: 1e3 * t / max(n, 1)
                              for k, (n, t) in got[2].items()}
    out[f"{cs.TENANT_F * cs.O}x{cs.J}"] = tenants
    del scn, inputs, nodes, volume
    torch.cuda.empty_cache()
    for label, o, j, n_win in cs.WIDE_CELLS:
        _, inputs = cs.wide_fleet(torch, dev, o, j)
        out[label] = per_launch(cs.trace_fleet_cell(
            torch, dev, label, inputs, o, j, n_win, card))
        del inputs
        torch.cuda.empty_cache()
    print(f"device us a launch inside the fleets' windows on {card}: "
          + "; ".join(f"{cell} {path}: " + ", ".join(
              f"{k} {v:.2f}" for k, v in us.items())
              for cell, paths in out.items() for path, us in paths.items()))
    return out


def save(torch, out_dir: Path, label: str, result) -> int:
    """Every tensor leaf of ``result`` as ``<label><path>.npy``; the count."""
    from repro_torch.pytree import leaves_with_paths
    n = 0
    for path, x in leaves_with_paths(result):
        if torch.is_tensor(x):
            np.save(out_dir / f"{label}{path or '.out'}.npy",
                    x.detach().cpu().numpy())
            n += 1
    return n


def outputs(torch, dev, out_dir: Path, card):
    """``--outputs``: see the module's docstring."""
    from repro_torch.core.policies import get_policy
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.kernels.window_mega import ops as mega_ops
    from repro_torch.storage import FleetConfig, simulate_tenants
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0

    def fixture(label, o, j, seed):
        args = [torch.as_tensor(x, device=dev)
                for x in cs.window_case(o, j, cs.W, seed=seed)]
        m_in, rng = cs.mega_case(torch, get_policy("adaptbf"), o, j, cs.W,
                                 seed=seed, dev=dev)
        rates = torch.as_tensor(rng.integers(0, 3, (cs.W, o, j)).astype(
            np.float32), device=dev)
        return (save(torch, out_dir, f"{label}.fixture.fleet_window",
                     fw_ops.fleet_window_serve(*args))
                + save(torch, out_dir, f"{label}.fixture.window_mega",
                       mega_ops.mega_window_round(get_policy("adaptbf"),
                                                  *m_in, rates)))

    def fleet(label, inputs, n_win):
        k = 0
        for serve, alloc in (("fused", "pallas"), ("mega", "core")):
            k += save(torch, out_dir, f"{label}.{serve}", cs.fleet_run(
                torch, dev, inputs, serve, alloc, telemetry="streaming",
                n_windows=n_win))
        return k

    scn, inputs = main_scenario(torch, dev)
    n += fixture(f"{cs.O}x{cs.J}", cs.O, cs.J, 11)
    n += fleet(f"{cs.O}x{cs.J}", inputs, cs.N_WINDOWS)
    nodes, volume, calls = tenant_fixture(torch, dev, scn, inputs)
    label = f"{cs.TENANT_F * cs.O}x{cs.J}"
    n += save(torch, out_dir, f"{label}.fixture.fleet_window", calls[0]())
    n += save(torch, out_dir, f"{label}.fixture.window_mega", calls[2]())
    for serve in ("fused", "mega"):
        cfg = FleetConfig(control="coded", serve_backend=serve,
                          alloc_backend="pallas", telemetry="streaming")
        n += save(torch, out_dir, f"{label}.{serve}", simulate_tenants(
            cfg, nodes, inputs["rates"], volume, inputs["cap"],
            inputs["backlog"], control_code=cs.TENANT_CODES,
            n_windows=cs.N_WINDOWS, device=dev))
    del scn, inputs, nodes, volume, calls
    torch.cuda.empty_cache()
    small = cs.small_tenant_inputs(torch, dev)
    rates, cap, nodes_all, volume_all = small
    n_f = max(cs.SMALL["fleets"])
    label = f"{n_f * cs.SMALL['o']}x{cs.SMALL['j']}"
    calls, _ = cs.fleet_launch_calls(torch, dev, n_f, rates[:cs.W], cap,
                                     nodes_all)
    n += save(torch, out_dir, f"{label}.fixture.fleet_window", calls[0]())
    n += save(torch, out_dir, f"{label}.fixture.window_mega", calls[2]())
    for serve in ("fused", "mega"):
        cfg = FleetConfig(serve_backend=serve, alloc_backend="pallas",
                          telemetry="streaming")
        n += save(torch, out_dir, f"{label}.{serve}", simulate_tenants(
            cfg, nodes_all, rates, volume_all, cap, device=dev))
    for label, o, j, n_win in cs.WIDE_CELLS:
        n += fixture(label, o, j, 11)
        _, inputs = cs.wide_fleet(torch, dev, o, j)
        n += fleet(label, inputs, n_win)
        del inputs
        torch.cuda.empty_cache()
    print(f"outputs: {n} arrays written to {out_dir} on {card}")
    return n


def compare(a: Path, b: Path) -> int:
    """``--compare``: 0 when every ``.npy`` of either directory is in both
    with the same dtype, shape and bytes."""
    names = sorted({p.name for d in (a, b) for p in d.glob("*.npy")})
    bad = []
    for name in names:
        if not (a / name).exists() or not (b / name).exists():
            bad.append(f"{name}: missing")
            continue
        x, y = np.load(a / name), np.load(b / name)
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            bad.append(f"{name}: differs")
    print(f"compare {a} {b}: {len(names) - len(bad)} of {len(names)} arrays "
          "bitwise equal" + ("" if not bad else "; " + "; ".join(bad[:20])))
    return 1 if bad or not names else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--rates", action="store_true")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--outputs", type=Path)
    ap.add_argument("--compare", type=Path, nargs=2)
    ap.add_argument("--json", type=Path)
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
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
    if args.cells:
        out["cells"] = cells(torch, dev, card)
    if args.trace:
        out["trace"] = traces(torch, dev, card)
    if args.outputs:
        out["outputs"] = outputs(torch, dev, args.outputs, card)
    if args.json:
        args.json.write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
