"""Serve and prefill steps shared by the launchers.

``make_serve_step`` builds a one-token decode step:
  params, cache, tokens, pos -> (next_tokens, logits, cache)
``make_prefill_step`` builds the prefill forward:
  params, batch -> next-token logits [B,1,V]

Both cast float32 weights to the compute dtype inside the call; pass
weights cast once (``models.cast_params``) and that cast is a no-op.
``make_prefill_step(kernels=False)`` runs the plain versions of the
attention and SSD kernels (the comparison path).  The train step waits for training (ROADMAP.md,
queue A, item 9).
"""
from __future__ import annotations

import torch

from repro_torch import models


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
