"""AdamW with global-norm clipping and linear-warmup/cosine schedule, as in
the reference package's ``optim/adamw.py``.

The optimizer state mirrors the parameter tree (dicts, and lists of
per-block dicts), so it lives where the parameters live.  Where the
reference returns new arrays (and its launchers donate the old ones to
the jitted step), the port's update writes the new values into the
parameter and moment tensors it is given, leaf by leaf, and returns them:
a step holds one copy of the parameters and moments, not two (at
zamba2-2.7b's 2.4 B parameters, 29 GB rather than 58).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.common import map_tree
from repro_torch.pytree import leaves_with_paths


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor      # int32, 0-d


def adamw_init(params) -> OptState:
    leaf = leaves_with_paths(params)[0][1]
    return OptState(m=map_tree(torch.zeros_like, params),
                    v=map_tree(torch.zeros_like, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=leaf.device))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for _, x in leaves_with_paths(tree)))


def schedule(step, base_lr: float, warmup: int, total: int) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return base_lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def adamw_update(
    grads,
    state: OptState,
    params,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    warmup: int = 100,
    total_steps: int = 10000,
    gnorm: Optional[torch.Tensor] = None,
):
    """Returns (new_params, new_state, metrics): ``params``' and
    ``state``'s own tensors, overwritten in place.  The reference's order:
    clip by the global norm, the moments, the bias-corrected step with the
    decoupled weight decay inside it.  ``gnorm``: the whole gradient's
    norm where ``grads``, ``params`` and the moments are one rank's blocks
    of a sharded state (``launch/sharded.py``); by default ``grads``'."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    step = state.step + 1
    lr_t = schedule(step, lr, warmup, total_steps)
    b1c = 1.0 - torch.pow(torch.tensor(b1, device=step.device),
                          step.to(torch.float32))
    b2c = 1.0 - torch.pow(torch.tensor(b2, device=step.device),
                          step.to(torch.float32))

    def upd(p, m, v, g):
        g = g * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / b1c
        vhat = v_new / b2c
        p.copy_((p - lr_t * (mhat / (torch.sqrt(vhat) + eps)
                             + weight_decay * p)).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)

    with torch.no_grad():
        for xs in zip(*([x for _, x in leaves_with_paths(tree)]
                        for tree in (params, state.m, state.v, grads))):
            upd(*xs)
    return params, OptState(state.m, state.v, step), {
        "grad_norm": gnorm, "lr": lr_t,
    }
