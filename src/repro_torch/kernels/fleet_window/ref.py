"""Plain version of the fused window-service kernel: a loop over ticks of
the simulator's own ``_serve_tick`` on ``[O, J]`` rows."""
from __future__ import annotations

import torch

from repro_torch.storage.simulator import _serve_tick


def fleet_window_ref(queue, vol_left, budget, rates, backlog_cap, cap_tick):
    """queue/vol_left/budget/backlog_cap: [O, J]; rates: [W, O, J];
    cap_tick: [O].  Returns (queue, vol_left, served_window)."""
    cap = cap_tick[:, None]
    served_w = torch.zeros_like(queue)
    for rate_t in rates:
        queue, vol_left, budget, served, _ = _serve_tick(
            queue, vol_left, budget, rate_t, backlog_cap, cap)
        served_w = served_w + served
    return queue, vol_left, served_w
