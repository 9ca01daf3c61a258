"""Dispatching wrapper for the fleet allocation kernel.

``alloc_backend="pallas"`` keeps the reference's name for the kernel path;
in this package it names the hand-written CUDA kernel
``kernels/csrc/adaptbf_alloc.cu``.  CUDA tensors launch it; CPU tensors take
the plain version (``ref.py``); anything else raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.adaptbf_alloc import ref
from repro_torch.kernels.dispatch import MAX_JOBS, check_f32, route

#: kernel launches made by ``fleet_alloc`` (never by the plain version)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]


def fleet_alloc(demand, nodes, record, remainder, alloc_prev, capacity,
                *, u_max: float = 64.0):
    """[O, J] tensors + [O] capacity -> (alloc, new_record, new_remainder).

    Integer tokens only, like the reference kernel.  On the card every input
    must be a contiguous float32 CUDA tensor and J <= ``MAX_JOBS``."""
    global launches
    ins = (demand, nodes, record, remainder, alloc_prev)
    if not route(*ins, capacity):
        return ref.fleet_alloc_ref(*ins, capacity, u_max=u_max)[:3]
    o, j = demand.shape
    if j > MAX_JOBS:
        raise ValueError(f"the allocation kernel takes at most {MAX_JOBS} "
                         f"jobs per row, got {j}")
    for name, x in zip(("demand", "nodes", "record", "remainder",
                        "alloc_prev"), ins):
        check_f32(name, x, (o, j))
    check_f32("capacity", capacity, (o,))
    outs = tuple(torch.empty_like(demand) for _ in range(3))
    _build.launch("adaptbf_alloc", _ARGTYPES,
                  *(x.data_ptr() for x in (*ins, capacity, *outs)), o, j,
                  float(u_max),
                  torch.cuda.current_stream(demand.device).cuda_stream)
    launches += 1
    return outs


fleet_alloc_ref = ref.fleet_alloc_ref
