"""Plain version of the fused window-service kernel: a loop over ticks of
the simulator's own ``_serve_tick`` on ``[R, J]`` rows."""
from __future__ import annotations

import torch

from repro_torch.storage.simulator import _serve_tick


def fleet_window_ref(queue, vol_left, budget, rates, backlog_cap, cap_tick):
    """queue/vol_left/budget/backlog_cap: [R, J]; cap_tick: [R]; rates:
    [W, R, J], or [F, W, O, J] for F fleets of O rows (R = F * O; a shared
    trace's fleet axis may be an ``expand``).  Returns (queue, vol_left,
    served_window)."""
    cap = cap_tick[:, None]
    served_w = torch.zeros_like(queue)
    for t in range(rates.shape[-3]):
        # one tick of every fleet as [R, J] rows (a copy only when the
        # fleets' rows are not adjacent in memory)
        rate_t = rates[..., t, :, :].reshape(queue.shape)
        queue, vol_left, budget, served, _ = _serve_tick(
            queue, vol_left, budget, rate_t, backlog_cap, cap)
        served_w = served_w + served
    return queue, vol_left, served_w
