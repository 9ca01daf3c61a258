"""Dispatching wrapper for the fused window-service kernel
(``kernels/csrc/fleet_window.cu``): CUDA tensors launch it, CPU tensors take
the plain version (``ref.py``), anything else raises."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import MAX_JOBS, check_f32, route
from repro_torch.kernels.fleet_window import ref

#: kernel launches made by ``fleet_window_serve`` (never by the plain version)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def fleet_window_serve(queue, vol_left, budget, rates, backlog_cap, cap_tick):
    """One observation window of two-phase NRS-TBF service, fused.

    queue/vol_left/budget/backlog_cap: [O, J]; rates: [W, O, J];
    cap_tick: [O].  Returns (queue, vol_left, served_window).  On the card
    every input must be a contiguous float32 CUDA tensor and
    J <= ``MAX_JOBS``."""
    global launches
    if not route(queue, vol_left, budget, rates, backlog_cap, cap_tick):
        return ref.fleet_window_ref(queue, vol_left, budget, rates,
                                    backlog_cap, cap_tick)
    o, j = queue.shape
    w = rates.shape[0]
    if j > MAX_JOBS:
        raise ValueError(f"the window kernel takes at most {MAX_JOBS} jobs "
                         f"per row, got {j}")
    for name, x in (("queue", queue), ("vol_left", vol_left),
                    ("budget", budget), ("backlog_cap", backlog_cap)):
        check_f32(name, x, (o, j))
    check_f32("rates", rates, (w, o, j))
    check_f32("cap_tick", cap_tick, (o,))
    outs = tuple(torch.empty_like(queue) for _ in range(3))
    _build.launch("fleet_window", _ARGTYPES,
                  *(x.data_ptr() for x in (queue, vol_left, budget,
                                           backlog_cap, rates, cap_tick,
                                           *outs)),
                  o, j, w, torch.cuda.current_stream(queue.device).cuda_stream)
    launches += 1
    return outs


fleet_window_ref = ref.fleet_window_ref
