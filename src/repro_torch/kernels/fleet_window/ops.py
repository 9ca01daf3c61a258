"""Dispatching wrapper for the fused window-service kernel
(``kernels/csrc/fleet_window.cu``): CUDA tensors launch it, CPU tensors take
the plain version (``ref.py``), anything else raises.

On the card a row takes at most ``dispatch.MAX_JOBS`` (65536) jobs
(``dispatch.row_layout``): rows of up to 32 run on one warp, 16 rows a
block, rows of up to 8192 on one thread block, wider rows on a thread-block
cluster of 2, 4 or 8 blocks (``dispatch.cluster_size``).  A wider row
raises ``ValueError`` before any launch; CPU tensors run the plain version
at any width.  The kernel forms a tick's second row sum only where the
tick needs it, with the same bits (``ref.serve_tick_model``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (
    check_f32,
    check_rates,
    cluster_size,
    route,
)
from repro_torch.kernels.fleet_window import ref

#: kernel launches made by ``fleet_window_serve`` (never by the plain version)
launches = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def fleet_window_serve(queue, vol_left, budget, rates, backlog_cap, cap_tick,
                       *, interpret: bool = None):
    """One observation window of two-phase NRS-TBF service, fused.

    queue/vol_left/budget/backlog_cap: [R, J]; cap_tick: [R]; rates:
    [W, R, J], or [F, W, O, J] for F fleets of O rows (R = F * O) with the
    fleet axis of any stride (0 for one trace shared by every fleet).
    Returns (queue, vol_left, served_window).  On the card every input but
    the rates must be a contiguous float32 CUDA tensor (the rates as
    ``dispatch.check_rates`` says) and J <= ``dispatch.MAX_JOBS``.
    ``interpret`` is accepted for the reference's signature and ignored."""
    global launches
    if not route(queue, vol_left, budget, rates, backlog_cap, cap_tick):
        return ref.fleet_window_ref(queue, vol_left, budget, rates,
                                    backlog_cap, cap_tick)
    r, j = queue.shape
    cluster_size(j)   # raises past MAX_JOBS
    for name, x in (("queue", queue), ("vol_left", vol_left),
                    ("budget", budget), ("backlog_cap", backlog_cap)):
        check_f32(name, x, (r, j))
    w, o, fleet_rows = check_rates(rates, r, j)
    check_f32("cap_tick", cap_tick, (r,))
    outs = tuple(torch.empty_like(queue) for _ in range(3))
    _build.launch("fleet_window", _ARGTYPES,
                  *(x.data_ptr() for x in (queue, vol_left, budget,
                                           backlog_cap, rates, cap_tick,
                                           *outs)),
                  r, j, w, o, fleet_rows,
                  torch.cuda.current_stream(queue.device).cuda_stream)
    launches += 1
    return outs


fleet_window_ref = ref.fleet_window_ref
