"""Training launcher: the AdapTBF-paced token pipeline, the train step and
checkpoints, on one CUDA device (``--device cpu`` for the CPU).

  python -m repro_torch.launch.train --arch zamba2-2.7b --steps 100 \
      --global-batch 8 --seq 128 --smoke [--device cpu]

``--mesh`` takes ``1x1`` (one device, the default here); the reference's
TPU meshes (``production``, ``multipod``, larger grids) are not ported
(ROADMAP.md, queue A, item A.5, "the TPU meshes").
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch import steps
from repro_torch.storage import AdapTBFController
from repro_torch.training.trainer import restore_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--mesh", default="1x1",
                    help='"1x1" (one device); the reference\'s "production", '
                         '"multipod" and larger grids are not ported')
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"mesh {args.mesh!r}: the port trains on one device (--mesh 1x1); "
            "the reference's TPU meshes are not ported (ROADMAP.md, queue A, "
            "item A.5, \"the TPU meshes\")")
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    controller = AdapTBFController(n_targets=4, capacity_rpc_per_s=4000,
                                   device=dev)
    controller.register_job("checkpoint", nodes=1)
    pipeline = TokenPipeline(cfg.vocab, args.seq, args.global_batch,
                             controller=controller)
    step_fn = steps.make_train_step(cfg, microbatches=args.microbatches)

    state = steps.init_train_state(cfg,
                                   torch.Generator(device=dev).manual_seed(0))
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_train_state(args.ckpt_dir, state, cfg)
        print(f"resumed at step {start}")
    for i in range(start, start + args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipeline.batch(i).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:5d} loss {loss:.4f} "
                  f"({(time.perf_counter()-t0)*1e3:.0f} ms)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, state, i + 1,
                            controller=controller, job="checkpoint")
    print(f"done: final loss {loss:.4f}; "
          f"AdapTBF windows run: {controller.windows_run}")
    return state


if __name__ == "__main__":
    main()
