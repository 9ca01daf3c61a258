"""Serving launcher: continuous-batching engine with AdapTBF class-based
admission, on one CUDA device (``--device cpu`` for the CPU).

  python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke --requests 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serving import Request, ServingEngine
from repro_torch.storage import AdapTBFController


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    controller = AdapTBFController(n_targets=1, capacity_rpc_per_s=2000,
                                   window_s=0.05, device=dev)
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_len=args.max_len, controller=controller,
                           classes={"interactive": 3.0, "batch": 1.0})
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        engine.submit(Request(
            prompt=rng.integers(0, cfg.vocab, 4).tolist(),
            max_new_tokens=args.max_new,
            klass="interactive" if i % 2 == 0 else "batch"))
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)}/{args.requests} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s); "
          f"AdapTBF windows: {controller.windows_run}")
    return done


if __name__ == "__main__":
    main()
