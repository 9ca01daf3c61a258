"""Train, serve and prefill steps shared by the launchers.

``make_train_step`` builds a gradient-accumulating (microbatched) step:
  state, batch -> state, metrics
``make_serve_step`` builds a one-token decode step:
  params, cache, tokens, pos -> (next_tokens, logits, cache)
``make_prefill_step`` builds the prefill forward:
  params, batch -> next-token logits [B,1,V]

The serve and prefill steps cast float32 weights to the compute dtype
inside the call; pass weights cast once (``models.cast_params``) and that
cast is a no-op.  The train step keeps float32 masters and differentiates
through the cast.  ``make_prefill_step(kernels=False)`` (and ``models.loss_fn(...,
kernels=False)``) runs the plain versions of the attention and SSD
kernels, forward and backward (the comparison path).  The train step on a
mesh of ranks is ``launch/sharded.py``'s.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import models
from repro_torch.models.common import map_tree
from repro_torch.optim import OptState, adamw_init, adamw_update
from repro_torch.pytree import leaves_with_paths, map_leaves, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(cfg, generator: torch.Generator,
                     dtype=torch.float32) -> TrainState:
    """Seeded parameters (``models.init_params``) on the generator's device
    and a zero AdamW state."""
    params = models.init_params(cfg, generator, dtype)
    return TrainState(params=params, opt=adamw_init(params))


def _value_and_grad(loss_of, params, batch):
    leaves = [x.detach().requires_grad_(True)
              for _, x in leaves_with_paths(params)]
    loss = loss_of(unflatten(params, leaves), batch)
    # a leaf the loss does not read (the token embedding of an audio
    # encoder) gets zeros, as under jax.grad
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


def loss_and_grads(cfg, params, batch, microbatches: int, compute_dtype):
    """Loss and gradients over ``microbatches`` splits of ``batch`` (one
    after another, so peak activation memory is one microbatch): a running
    sum, divided by the count."""

    def loss_of(params, batch):
        return models.loss_fn(params, cfg, batch, dtype=compute_dtype)

    if microbatches == 1:
        return _value_and_grad(loss_of, params, batch)
    gsum, lsum = None, 0.0
    for i in range(microbatches):
        mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                           + tuple(v.shape[1:]))[i]
              for k, v in batch.items()}
        loss, g = _value_and_grad(loss_of, params, mb)
        gsum = g if gsum is None else map_leaves(torch.add, gsum, g)
        lsum = lsum + loss
    return lsum / microbatches, map_tree(lambda g: g / microbatches, gsum)


def make_train_step(cfg, *, microbatches: int = 1,
                    compute_dtype=torch.bfloat16, **hyper):
    """Gradient accumulation over ``microbatches`` splits of the global batch
    (one after another, so peak activation memory is one microbatch): a
    running sum of the gradients, divided by the count, then one AdamW
    update (``hyper``: ``adamw_update``'s keywords).  The step overwrites
    the state it is given (``adamw_update`` works in place, as the
    reference's launchers donate the state to their jitted step)."""

    def train_step(state: TrainState, batch):
        loss, grads = loss_and_grads(cfg, state.params, batch, microbatches,
                                      compute_dtype)
        new_params, opt, metrics = adamw_update(
            grads, state.opt, state.params, **hyper)
        metrics["loss"] = loss
        return TrainState(new_params, opt), metrics

    return train_step


def make_serve_step(cfg, *, compute_dtype=torch.bfloat16):
    def serve_step(params, cache, tokens, pos):
        logits, cache = models.decode_step(params, cache, cfg, tokens, pos,
                                           dtype=compute_dtype)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache

    return serve_step


def make_prefill_step(cfg, *, compute_dtype=torch.bfloat16,
                      kernels: bool = True):
    def prefill_step(params, batch):
        return models.forward(params, cfg, batch, dtype=compute_dtype,
                              last_only=True, kernels=kernels)

    return prefill_step
