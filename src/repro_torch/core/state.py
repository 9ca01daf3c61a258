"""Per-OST allocator state (paper Table I: records r_x, remainders rho_x,
alpha^{t-1}).

A fleet's state is the ``[n_ost, n_jobs]`` form of the single-target
``[n_jobs]`` state: no allocator operation mixes rows, so the paper's
decentralization is structural.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AllocatorState(NamedTuple):
    """State carried across observation windows.

    record:     net tokens lent (+) / borrowed (-) per job  (r_x, Eq. 8/16/20)
    remainder:  fractional token carry per job              (rho_x, Eq. 21-25)
    alloc_prev: final allocation of the previous window     (alpha_x^{t-1}, Eq. 3)
    """

    record: torch.Tensor
    remainder: torch.Tensor
    alloc_prev: torch.Tensor


def _zeros_state(shape, device, dtype) -> AllocatorState:
    # one buffer per field, so no two leaves alias
    return AllocatorState(*(torch.zeros(shape, dtype=dtype, device=device)
                            for _ in AllocatorState._fields))


def init_state(n_jobs: int, device=None,
               dtype=torch.float32) -> AllocatorState:
    return _zeros_state((n_jobs,), device, dtype)


def init_fleet_state(n_ost: int, n_jobs: int, device=None,
                     dtype=torch.float32) -> AllocatorState:
    return _zeros_state((n_ost, n_jobs), device, dtype)
