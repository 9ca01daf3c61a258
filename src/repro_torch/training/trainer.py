"""Fault-tolerant training loop, as in the reference package's
``training/trainer.py``.

* checkpoint/restart: restores the latest checkpoint on construction (the
  port's own, or a reference ``TrainState``'s through
  ``models.train_state_from_numpy``), saves asynchronously every
  ``ckpt_every`` steps (writes paced by AdapTBF).
* determinism contract: synthetic pipeline batches are pure functions of the
  step and the step runs no floating-point atomics, so crash -> restore ->
  continue reproduces the uninterrupted run bit for bit (tested).
* optional gradient compression: stochastic-rounding bf16 cast of gradients
  before the optimizer (halves gradient all-reduce bytes on real meshes).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch import models
from repro_torch.checkpoint.manager import (AsyncCheckpointer,
                                            checkpoint_leaves, checkpoint_meta,
                                            latest_step, restore_checkpoint,
                                            save_checkpoint)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.steps import (TrainState, _value_and_grad,
                                      init_train_state, make_train_step)
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw_update
from repro_torch.pytree import leaves_with_paths, map_leaves


def stochastic_round_bf16(x: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding (unbiased; add uniform 16-bit
    noise below the bf16 mantissa, then truncate).  The noise comes from
    ``generator`` (on x's device): other bits than the reference's
    ``jax.random`` for the same seed, the same distribution."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    noise = torch.randint(0, 1 << 16, tuple(x.shape), generator=generator,
                          dtype=torch.int32, device=x.device)
    bits = (bits + noise) & -(1 << 16)          # & 0xFFFF0000
    return bits.view(torch.float32).to(torch.bfloat16)


def compress_grads(grads, step):
    """Every leaf stochastically rounded to bf16 (and back to its type), the
    noise drawn leaf by leaf in flatten order from one generator seeded
    from (17, step)."""
    leaves = leaves_with_paths(grads)
    gen = torch.Generator(device=leaves[0][1].device)
    gen.manual_seed((17 << 32) + int(step))
    return map_leaves(lambda g: stochastic_round_bf16(g, gen).to(g.dtype),
                      grads)


def restore_train_state(directory: str, like: TrainState, cfg: ModelConfig):
    """(state, step) from the latest checkpoint under ``directory``: the
    port's own (``restore_checkpoint`` into ``like``), or a reference
    ``TrainState``'s, whose stacked leaves ``train_state_from_numpy``
    splits into ``like``'s per-block lists."""
    ours = {p for p, _ in leaves_with_paths(like)}
    if {m["path"] for m in checkpoint_meta(directory)["leaves"]} == ours:
        return restore_checkpoint(directory, like)
    leaves, step = checkpoint_leaves(directory)
    dev = leaves_with_paths(like)[0][1].device
    return models.train_state_from_numpy(cfg, leaves, dev), step


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        ckpt_dir: str,
        data: Optional[TokenPipeline] = None,
        global_batch: int = 8,
        seq_len: int = 128,
        microbatches: int = 1,
        ckpt_every: int = 50,
        keep_ckpts: int = 3,
        controller=None,
        grad_compression: str = "none",   # none | bf16_sr
        compute_dtype=torch.float32,
        seed: int = 0,
        device=None,
        **hyper,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.data = data or TokenPipeline(cfg.vocab, seq_len, global_batch,
                                          controller=controller)
        if controller is not None:
            controller.register_job("checkpoint", nodes=1)
        base_step = make_train_step(cfg, microbatches=microbatches,
                                    compute_dtype=compute_dtype, **hyper)
        self._grad_compression = grad_compression
        self._hyper = hyper
        self._compute_dtype = compute_dtype
        self._step_fn = self._wrap(base_step)

        self.state = init_train_state(
            cfg, torch.Generator(device=self.device).manual_seed(seed))
        self.step = 0
        if latest_step(ckpt_dir) is not None:
            self.state, self.step = restore_train_state(ckpt_dir, self.state,
                                                        cfg)
        self._ckpt = AsyncCheckpointer(ckpt_dir, controller=controller,
                                       keep=keep_ckpts)

    def _wrap(self, base_step):
        if self._grad_compression != "bf16_sr":
            return base_step
        cfg, hyper, dtype = self.cfg, self._hyper, self._compute_dtype

        def step_fn(state: TrainState, batch):
            loss, grads = _value_and_grad(
                lambda p, b: models.loss_fn(p, cfg, b, dtype=dtype),
                state.params, batch)
            grads = compress_grads(grads, state.opt.step)
            new_params, opt, metrics = adamw_update(grads, state.opt,
                                                    state.params, **hyper)
            metrics["loss"] = loss
            return TrainState(new_params, opt), metrics

        return step_fn

    def run(self, n_steps: int) -> List[Dict[str, float]]:
        history = []
        for _ in range(n_steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.data.batch(self.step).items()}
            self.state, metrics = self._step_fn(self.state, batch)
            self.step += 1
            history.append({k: float(v) for k, v in metrics.items()})
            if self.step % self.ckpt_every == 0:
                self._ckpt.submit(self.state, self.step)
        return history

    def save_now(self):
        return save_checkpoint(self.ckpt_dir, self.state, self.step)

    def close(self):
        self._ckpt.close()
