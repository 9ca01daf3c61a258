"""Plain version of the fused window-service kernel: a loop over ticks of
the simulator's own ``_serve_tick`` on ``[R, J]`` rows; and the kernel's
tick as it runs (``serve_tick_model``, for the tests)."""
from __future__ import annotations

import torch

from repro_torch.kernels.numerics import row_sum
from repro_torch.storage.simulator import _EPS, _serve_tick


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


def serve_tick_model(queue, vol_left, budget, rate_t, backlog_cap, capacity):
    """One tick as B1 runs it (``csrc/serve.cuh``): ``_serve_tick`` on
    [R, J] rows with capacity [R, 1], except that the second row sum,
    sum(s1), is read only on the rows that need it: elsewhere spare =
    max(capacity - sum(want1), 0), which is the tick's own where phase 1
    fits the capacity (scale1 == 1, so s1 is want1 and its sum is
    want1's), and where no unruled job waits (sum(want2) == 0) scales only
    zero queues.  Returns ``_serve_tick``'s five tensors, bitwise its own,
    and [R] bools: the rows whose tick formed sum(s1)."""
    headroom = torch.clamp_min(backlog_cap - queue, 0.0)
    issued = torch.minimum(torch.minimum(rate_t, vol_left), headroom)
    queue = torch.clamp_min(queue + issued, 0.0)
    vol_left = vol_left - issued
    ruled = torch.isfinite(budget)
    want1 = torch.where(ruled, torch.minimum(queue, torch.clamp_min(budget, 0.0)),
                        0.0)
    want2 = torch.where(ruled, 0.0, queue)
    wants1, wants2 = row_sum(want1), row_sum(want2)
    scale1 = torch.clamp_max(capacity / torch.clamp_min(wants1, _EPS), 1.0)
    formed = (scale1 != 1.0) & (wants2 != 0.0)
    s1 = want1 * scale1
    # sum(s1) is read on the formed rows only (taken over all rows, so that
    # each row's sum is the one the plain version takes)
    spare = torch.clamp_min(capacity - torch.where(formed, row_sum(s1),
                                                   wants1), 0.0)
    scale2 = torch.clamp_max(spare / torch.clamp_min(wants2, _EPS), 1.0)
    served = torch.minimum(s1 + want2 * scale2, queue)
    return (queue - served, vol_left, budget - served, served, issued,
            formed[..., 0])


def fleet_window_model(queue, vol_left, budget, rates, backlog_cap, cap_tick):
    """``fleet_window_ref`` on ``serve_tick_model``'s ticks.  Returns
    ((queue, vol_left, served_window), [W, R] bools: the row-ticks that
    formed sum(s1))."""
    cap = cap_tick[:, None]
    served_w = torch.zeros_like(queue)
    formed = []
    for t in range(rates.shape[-3]):
        rate_t = rates[..., t, :, :].reshape(queue.shape)
        queue, vol_left, budget, served, _, f = serve_tick_model(
            queue, vol_left, budget, rate_t, backlog_cap, cap)
        served_w = served_w + served
        formed.append(f)
    formed = (torch.stack(formed) if formed else
              torch.zeros((0, queue.shape[0]), dtype=torch.bool,
                          device=queue.device))
    return (queue, vol_left, served_w), formed
