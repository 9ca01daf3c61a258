"""Bandwidth-control baselines from the paper's evaluation (Section IV-C).

* Static BW: static TBF rules sized by each job's share of the *total* system
  resources (not just active jobs); never adapts.
* No BW:     Lustre default -- no token gating at all; the simulator serves
  backlog-proportionally (``policies.NoBWPolicy``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.numerics import row_sum


def static_allocate(nodes: torch.Tensor, capacity) -> torch.Tensor:
    """Static TBF rates: capacity * n_x / sum_all(n), tokens per window.

    nodes: [..., J]; capacity: [...] (a scalar for one target)."""
    nodes = nodes.to(torch.float32)
    share = nodes / torch.clamp_min(row_sum(nodes), 1e-12)
    capacity = torch.as_tensor(capacity, dtype=torch.float32,
                               device=nodes.device)
    return capacity[..., None] * share


def no_bw_allocate(demand: torch.Tensor, capacity) -> torch.Tensor:
    """No-BW 'allocation': every job gets the capacity as its token count,
    effectively unlimited (the simulator then arbitrates by backlog share).

    demand: [..., J] (only its shape and device are read); capacity
    broadcasts against it from the right, as ``jnp.full`` does."""
    capacity = torch.as_tensor(capacity, dtype=torch.float32,
                               device=demand.device)
    return torch.broadcast_to(capacity, demand.shape).clone()
