"""Plain version of the window megakernel: the control round composed from
the policy's own ``gate`` and ``step`` and the window service's plain
version, so it runs any registered policy."""
from __future__ import annotations

import torch

from repro_torch.core.policies import WindowObs
from repro_torch.kernels.fleet_window.ref import fleet_window_ref


def mega_round_ref(policy, ctx, cap_tick, backlog_cap, queue, vol_left,
                   alloc, held, pstate, rates_w, telem_ok=None, up=None):
    """One control round: gate -> serve all ticks -> observation select ->
    policy step (``alloc_backend="core"``).  Arguments and return tuple as
    ``ops.mega_window_round``."""
    ctx = ctx._replace(alloc_backend="core")
    budget0 = policy.gate(alloc, ctx)
    queue, vol_left, served_w = fleet_window_ref(
        queue, vol_left, budget0, rates_w, backlog_cap, cap_tick)
    demand = served_w + queue
    if telem_ok is None:
        obs = (served_w, demand, alloc)
    else:
        delivered = telem_ok[:, None] > 0
        obs = tuple(torch.where(delivered, new, old)
                    for new, old in zip((served_w, demand, alloc), held))
    pstate, alloc_next = policy.step(
        pstate, WindowObs(*obs, up=None if up is None else up[:, None]), ctx)
    return (queue, vol_left, served_w, demand, *obs, pstate, alloc_next)
