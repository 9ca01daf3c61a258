"""Training launcher: the AdapTBF-paced token pipeline, the train step and
checkpoints, on a mesh of ranks: one CUDA device at ``1x1`` (``--device
cpu`` for the CPU).

  python -m repro_torch.launch.train --arch zamba2-2.7b --steps 100 \
      --global-batch 8 --seq 128 --smoke [--device cpu]
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 2x1 \
      --arch zamba2-2.7b --smoke --device cpu

``--mesh`` takes ``DxM`` (a ``(data, model)`` mesh of D*M ranks),
``production`` (16x16) or ``multipod`` (2x16x16, ``pod`` first), as the
reference's launcher does; its default here is ``1x1``.  Every mesh runs
the same code, ``launch/sharded.py``'s step: at ``1x1`` each block is the
whole leaf and no collective runs.  A mesh of more than one rank needs the
default process group, which this launcher makes from ``torchrun``'s
environment (``env://``: gloo on the CPU, NCCL on cards) unless the
caller has made it; each rank runs on ``mesh.rank_device``.  Checkpoints
hold the global state (gathered, written by rank 0), so a checkpoint of
any mesh restores on any other.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import sharded, steps
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     rank_device)
from repro_torch.storage import AdapTBFController
from repro_torch.training.trainer import restore_train_state


def parse_mesh(text: str):
    """The ``--mesh`` argument as a mesh."""
    if text == "production":
        return make_production_mesh()
    if text == "multipod":
        return make_production_mesh(multi_pod=True)
    try:
        d, m = (int(x) for x in text.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected production, multipod "
                         "or DxM (e.g. 2x1)") from None
    return make_mesh((d, m), ("data", "model"))


def _join_torchrun(device: str) -> None:
    """Make the default group from ``torchrun``'s environment where the
    caller has not made one."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if device == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                          % torch.cuda.device_count())
    dist.init_process_group("nccl", init_method="env://")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--mesh", default="1x1",
                    help='"production", "multipod", or "DxM" (e.g. 1x1)')
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    _join_torchrun(args.device)
    mesh = parse_mesh(args.mesh)
    dev = rank_device(None if args.device == "cuda" else args.device)
    rank = mesh.rank_of(mesh.coords)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    controller = AdapTBFController(n_targets=4, capacity_rpc_per_s=4000,
                                   device=dev)
    controller.register_job("checkpoint", nodes=1)
    pipeline = TokenPipeline(cfg.vocab, args.seq, args.global_batch,
                             controller=controller)

    gen = torch.Generator(device=dev).manual_seed(0)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_train_state(
            args.ckpt_dir, steps.init_train_state(cfg, gen), cfg)
        print(f"resumed at step {start}")
        state = sharded.shard_train_state(cfg, state, mesh)
    else:
        state = sharded.init_sharded_train_state(cfg, gen, mesh)
    step_fn = sharded.make_sharded_train_step(
        cfg, mesh, microbatches=args.microbatches)
    for i in range(start, start + args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipeline.batch(i).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if i % max(args.steps // 10, 1) == 0 and rank == 0:
            print(f"step {i:5d} loss {loss:.4f} "
                  f"({(time.perf_counter()-t0)*1e3:.0f} ms)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_train_state(args.ckpt_dir, cfg, state, mesh, i + 1,
                             controller)
    if rank == 0:
        print(f"done: final loss {loss:.4f}; "
              f"AdapTBF windows run: {controller.windows_run}")
    return state


def save_train_state(directory: str, cfg, state, mesh, step: int,
                     controller=None) -> None:
    """Checkpoint the global train state: every rank of ``mesh`` gathers
    it and rank 0 writes it while the others wait."""
    whole = sharded.gather_train_state(cfg, state, mesh)
    if mesh.rank_of(mesh.coords) == 0:
        save_checkpoint(directory, whole, step, controller=controller,
                        job="checkpoint")
    del whole
    if mesh.size > 1:
        dist.barrier()


if __name__ == "__main__":
    main()
