"""Serving example: continuous batching with AdapTBF admission control.

Two request classes share the engine: ``interactive`` (priority 3) and
``batch`` (priority 1).  Class token budgets come from the same
decentralized allocator that guards storage bandwidth (the paper's Section
III-E generalization): under load, interactive requests are admitted first
but the batch class is never starved.  On a CUDA device every decode step
runs the flash decode kernel once a layer.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_llm [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serving import Request, ServingEngine
from repro_torch.storage import AdapTBFController


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("phi3-mini-3.8b")
    params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    controller = AdapTBFController(n_targets=1, capacity_rpc_per_s=2000,
                                   window_s=0.05, device=dev)
    engine = ServingEngine(cfg, params, slots=4, max_len=128,
                           classes={"interactive": 3.0, "batch": 1.0},
                           controller=controller)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        klass = "interactive" if i % 2 == 0 else "batch"
        engine.submit(Request(prompt=rng.integers(0, cfg.vocab, 4).tolist(),
                              max_new_tokens=args.max_new_tokens,
                              klass=klass))

    t0 = time.perf_counter()
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0

    print(f"served {len(done)} requests in {dt:.2f}s "
          f"({sum(len(r.output) for r in done) / dt:.1f} tok/s aggregate)\n")
    for r in sorted(done, key=lambda r: r.id):
        print(f"  [{r.klass:11s}] prompt={r.prompt} -> {r.output}")
    print(f"\nAdapTBF admission windows run: {controller.windows_run}")
    return done


if __name__ == "__main__":
    main()
