"""Streaming per-window metric accumulators for long-horizon runs.

With ``FleetConfig(telemetry="streaming")`` the window engine folds each
window's observation into the ``StreamStats`` carry below instead of
writing ``[n_windows, O, J]`` trajectories, so device memory does not grow
with the horizon: a handful of ``[O, J]`` sufficient statistics, per-OST
utilization and backlog sums, and a fixed-width log-spaced backlog
histogram per OST.  The numpy finalizers that turn a ``StreamStats`` into
report metrics are ``storage/metrics.py``'s ``streaming_*`` functions.

Every accumulator keeps a leading OST axis and is updated from that OST's
row alone; the one fleet-wide quantity, the busy flag (a window is busy
when any OST served anything), is an int32 count, exact in any order.  A
batch of F fleets (``storage/tenants.py``) folds ``[F*O]`` rows at once,
with one window counter and one busy flag per fleet (``[F]`` int32).
Sharded over ranks (``partition="ost_shard"``/``"fleet_shard"``), each
rank folds its own rows and the busy-OST count is summed over the ``ost``
axis's process group (``axis_name``) before the flag is taken;
``stats_pspecs`` gives the carry's layout over the mesh.

Accuracy at long horizons: a plain float32 running sum stops advancing
once its total passes 2^24 times the increment, so every float sum carries
a Kahan compensation term (``StreamStats.comp``), and pure counters are
int32.  The fold is plain eager PyTorch (no compilation that could
reassociate the compensation away), the same code on the CPU and the card.

dtypes and paths are the reference's: int32 counters (``windows``,
``busy_windows``, ``alloc_windows``, ``last_served`` and the three fault
counters), float32 sums, ``NBINS = 128`` bins over 10^-2 .. 10^6 RPCs.
The field order is the checkpoint naming contract
(``stream_stats_leaf_paths``): extend by appending, never by renaming.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.numerics import row_sum
from repro_torch.launch.mesh import all_reduce_sum
from repro_torch.pytree import leaves_with_paths

NBINS = 128            # backlog histogram resolution
LAG_LOG10_LO = -2.0    # histogram range: 10^-2 .. 10^6 RPCs, log-spaced
LAG_LOG10_HI = 6.0


class StreamComp(NamedTuple):
    """Kahan compensation terms, one per floating-point sum field."""

    served_sum: torch.Tensor
    served_sumsq: torch.Tensor
    demand_sum: torch.Tensor
    demand_sumsq: torch.Tensor
    alloc_sum: torch.Tensor
    alloc_sumsq: torch.Tensor
    util_sum: torch.Tensor
    lag_sum: torch.Tensor
    lag_sumsq: torch.Tensor
    lag_hist: torch.Tensor


class StreamStats(NamedTuple):
    """Sufficient statistics folded into the window carry.

    Per-job arrays are [O, J] ([J] after the single-target squeeze);
    per-target arrays are [O] ([] squeezed); the histogram is [O, NBINS]
    ([NBINS] squeezed); ``windows`` and ``busy_windows`` are 0-d int32
    (``[F]`` in a batch of F fleets, whose every other leaf is then
    ``[F, O, ...]`` as ``simulate_tenants`` returns it).
    Float sums are Kahan-compensated: a finalizer adds the matching
    ``comp`` term for the best estimate.
    """

    windows: torch.Tensor        # () int32: windows accumulated
    served_sum: torch.Tensor     # [O, J] total RPCs served per job
    served_sumsq: torch.Tensor   # [O, J] second moment of per-window served
    demand_sum: torch.Tensor     # [O, J] total observed demand d_x
    demand_sumsq: torch.Tensor   # [O, J]
    alloc_sum: torch.Tensor      # [O, J] finite (ruled) allocations only
    alloc_sumsq: torch.Tensor    # [O, J]
    alloc_windows: torch.Tensor  # [O, J] int32 windows with a finite alloc
    util_sum: torch.Tensor       # [O] sum over windows of per-OST utilization
    busy_windows: torch.Tensor   # () int32: windows where anything was served
    lag_sum: torch.Tensor        # [O] sum of backlog (demand - served)
    lag_sumsq: torch.Tensor      # [O]
    lag_max: torch.Tensor        # [O] max per-job backlog seen
    lag_hist: torch.Tensor       # [O, NBINS] log-spaced backlog histogram
    last_served: torch.Tensor    # [O, J] int32 last window with service (-1)
    comp: StreamComp             # Kahan compensation for the float sums
    # fault counters (appended fields; row-local [O] int32, zero outside
    # fault-injected runs)
    down_windows: torch.Tensor   # [O] windows the OST spent down
    droop_windows: torch.Tensor  # [O] windows up but capacity-degraded
    obs_lost: torch.Tensor       # [O] windows whose observation was lost


def init_stats(n_ost: int, n_jobs: int, device=None,
               n_fleets: Optional[int] = None) -> StreamStats:
    """Zeroed statistics on ``device`` (default: the CPU); every leaf is a
    buffer of its own.  With ``n_fleets``, ``n_ost`` counts the rows of
    every fleet together and ``windows``/``busy_windows`` are
    ``[n_fleets]``."""
    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32, device=device)

    oj, o, oh = (n_ost, n_jobs), (n_ost,), (n_ost, NBINS)
    lead = () if n_fleets is None else (n_fleets,)
    return StreamStats(
        windows=i32(*lead),
        served_sum=f32(*oj), served_sumsq=f32(*oj),
        demand_sum=f32(*oj), demand_sumsq=f32(*oj),
        alloc_sum=f32(*oj), alloc_sumsq=f32(*oj),
        alloc_windows=i32(*oj),
        util_sum=f32(*o),
        busy_windows=i32(*lead),
        lag_sum=f32(*o), lag_sumsq=f32(*o), lag_max=f32(*o),
        lag_hist=f32(*oh),
        last_served=i32(*oj, fill=-1),
        comp=StreamComp(
            served_sum=f32(*oj), served_sumsq=f32(*oj), demand_sum=f32(*oj),
            demand_sumsq=f32(*oj), alloc_sum=f32(*oj), alloc_sumsq=f32(*oj),
            util_sum=f32(*o), lag_sum=f32(*o), lag_sumsq=f32(*o),
            lag_hist=f32(*oh)),
        down_windows=i32(*o), droop_windows=i32(*o), obs_lost=i32(*o),
    )


def stream_stats_leaf_paths() -> Tuple[str, ...]:
    """Path strings of every ``StreamStats`` leaf, in flatten order: the
    checkpoint naming contract, the reference's strings."""
    return tuple(path for path, _ in leaves_with_paths(init_stats(1, 1)))


def stats_pspecs(axis: str, lead: Optional[str] = None) -> StreamStats:
    """The layout of a ``StreamStats`` over a mesh (``launch/mesh.py``):
    one tuple a leaf, an axis name for each dimension split over that
    axis and None for a whole one, as the reference's ``PartitionSpec``s
    read.  Every leaf is row-split over ``axis`` except the two counters,
    which every rank of the axis holds whole.

    ``lead`` names an optional leading fleet axis (the tenant batch of
    ``storage/tenants.simulate_tenants``): every leaf, the two counters
    included (``[F]`` in a batched carry), gains it in front of its row
    layout."""
    front = (lead,) if lead is not None else ()
    oj = (*front, axis, None)
    o = (*front, axis)
    rep = front
    return StreamStats(
        windows=rep,
        served_sum=oj, served_sumsq=oj,
        demand_sum=oj, demand_sumsq=oj,
        alloc_sum=oj, alloc_sumsq=oj,
        alloc_windows=oj,
        util_sum=o,
        busy_windows=rep,
        lag_sum=o, lag_sumsq=o, lag_max=o,
        lag_hist=oj,
        last_served=oj,
        comp=StreamComp(
            served_sum=oj, served_sumsq=oj, demand_sum=oj, demand_sumsq=oj,
            alloc_sum=oj, alloc_sumsq=oj, util_sum=o,
            lag_sum=o, lag_sumsq=o, lag_hist=oj),
        down_windows=o, droop_windows=o, obs_lost=o,
    )


def stats_layout(stats: StreamStats, specs: StreamStats):
    """``[(leaf, spec), ...]`` of a carry and its ``stats_pspecs``, in
    flatten order (a spec is a tuple, so the two trees are walked by
    field)."""
    pairs = []
    for leaf, spec in zip(stats, specs):
        if isinstance(leaf, StreamComp):
            pairs += list(zip(leaf, spec))
        else:
            pairs.append((leaf, spec))
    return pairs


def _kahan(total, comp, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """One compensated-summation step: returns (total', comp').  Three
    eager float32 ops in this order; nothing may reassociate them."""
    y = x - comp
    t = total + y
    return t, (t - total) - y


def lag_bin(lag: torch.Tensor) -> torch.Tensor:
    """Histogram bin index (int32) for a backlog value (zeros land in bin
    0).  The clamp comes before the integer conversion, so +inf lands in
    the last bin and NaN in bin 0, as the reference's saturating
    conversion puts them."""
    f = (torch.log10(torch.clamp_min(lag, 1e-30)) - LAG_LOG10_LO) \
        / (LAG_LOG10_HI - LAG_LOG10_LO) * NBINS
    f = torch.nan_to_num(torch.floor(f), nan=0.0)
    return torch.clamp(f, 0, NBINS - 1).to(torch.int32)


def bin_upper_edge(b) -> float:
    """Upper edge (RPCs) of histogram bin ``b``."""
    return float(10.0 ** (
        LAG_LOG10_LO + (np.asarray(b) + 1) * (LAG_LOG10_HI - LAG_LOG10_LO)
        / NBINS))


def update_stats(stats: StreamStats, served_w, demand, alloc, cap_w,
                 axis_name=None, faults_w=None,
                 n_fleets: Optional[int] = None) -> StreamStats:
    """Fold one window's [O, J] observation into the carry.

    Mirrors the trajectory definitions in ``storage/metrics.py``: per-window
    utilization is ``served.sum(jobs) / cap_w`` (``cap_w`` [O], the
    window's effective capacity: zero while down), a window is busy when
    any OST served anything, and the allocation moments mask unruled
    (infinite) entries.  Row sums accumulate in float64 and round once
    (``numerics.row_sum``), so they can differ from the reference's by an
    ulp; every element-wise field follows the reference op for op.

    ``axis_name``: the ``ost`` axis's process group when the rows are one
    rank's shard (``launch/mesh.py``, ``Mesh.ost_group``): each fleet's
    int32 busy-OST count is summed across it before the flag is taken, so
    the flag is the unsharded run's bit for bit.  None: the rows are the
    whole fleet.

    ``faults_w`` (optional ``faults.FaultPlan`` row, [O] tensors) advances
    the fault counters: windows down, windows up but degraded, observations
    lost.  ``None`` leaves them as they are.

    ``n_fleets``: the rows are F fleets' ``[F*O]`` rows in fleet order,
    and ``stats.windows``/``busy_windows`` are ``[F]``: each fleet's busy
    flag reads its own rows only.
    """
    n_ost = served_w.shape[0]
    served_o = row_sum(served_w)[:, 0]
    util_o = served_o / torch.clamp_min(cap_w, 1e-12)
    n_f = n_fleets or 1
    busy_osts = (served_o.view(n_f, -1) > 0).sum(dim=1, dtype=torch.int32)
    if axis_name is not None:
        busy_osts = all_reduce_sum(busy_osts, axis_name)
    busy = (busy_osts > 0).to(torch.int32).view(stats.busy_windows.shape)
    window_of_row = stats.windows.reshape(n_f).repeat_interleave(
        n_ost // n_f)[:, None]
    lag = demand - served_w
    ruled = torch.isfinite(alloc)
    alloc_f = torch.where(ruled, alloc, 0.0)
    window_hist = torch.zeros((n_ost, NBINS), dtype=torch.float32,
                              device=served_w.device)
    # adds of 1.0 are exact in any order: the scatter is deterministic
    window_hist.scatter_add_(1, lag_bin(lag).to(torch.int64),
                             torch.ones_like(lag))
    c = stats.comp
    served_sum, c_served_sum = _kahan(stats.served_sum, c.served_sum, served_w)
    served_sumsq, c_served_sumsq = _kahan(
        stats.served_sumsq, c.served_sumsq, served_w * served_w)
    demand_sum, c_demand_sum = _kahan(stats.demand_sum, c.demand_sum, demand)
    demand_sumsq, c_demand_sumsq = _kahan(
        stats.demand_sumsq, c.demand_sumsq, demand * demand)
    alloc_sum, c_alloc_sum = _kahan(stats.alloc_sum, c.alloc_sum, alloc_f)
    alloc_sumsq, c_alloc_sumsq = _kahan(
        stats.alloc_sumsq, c.alloc_sumsq, alloc_f * alloc_f)
    util_sum, c_util_sum = _kahan(stats.util_sum, c.util_sum, util_o)
    lag_sum, c_lag_sum = _kahan(stats.lag_sum, c.lag_sum, row_sum(lag)[:, 0])
    lag_sumsq, c_lag_sumsq = _kahan(stats.lag_sumsq, c.lag_sumsq,
                                    row_sum(lag * lag)[:, 0])
    lag_hist, c_lag_hist = _kahan(stats.lag_hist, c.lag_hist, window_hist)
    down_windows, droop_windows, obs_lost = (
        stats.down_windows, stats.droop_windows, stats.obs_lost)
    if faults_w is not None:
        down = faults_w.up <= 0.0
        down_windows = down_windows + down.to(torch.int32)
        droop_windows = droop_windows + (
            ~down & (faults_w.cap_scale < 1.0)).to(torch.int32)
        obs_lost = obs_lost + (faults_w.telem_ok <= 0.0).to(torch.int32)
    return StreamStats(
        windows=stats.windows + 1,
        served_sum=served_sum, served_sumsq=served_sumsq,
        demand_sum=demand_sum, demand_sumsq=demand_sumsq,
        alloc_sum=alloc_sum, alloc_sumsq=alloc_sumsq,
        alloc_windows=stats.alloc_windows + ruled.to(torch.int32),
        util_sum=util_sum,
        busy_windows=stats.busy_windows + busy,
        lag_sum=lag_sum, lag_sumsq=lag_sumsq,
        lag_max=torch.maximum(stats.lag_max, torch.amax(lag, dim=-1)),
        lag_hist=lag_hist,
        last_served=torch.where(served_w > 0, window_of_row,
                                stats.last_served),
        comp=StreamComp(
            served_sum=c_served_sum, served_sumsq=c_served_sumsq,
            demand_sum=c_demand_sum, demand_sumsq=c_demand_sumsq,
            alloc_sum=c_alloc_sum, alloc_sumsq=c_alloc_sumsq,
            util_sum=c_util_sum, lag_sum=c_lag_sum, lag_sumsq=c_lag_sumsq,
            lag_hist=c_lag_hist),
        down_windows=down_windows, droop_windows=droop_windows,
        obs_lost=obs_lost,
    )


def squeeze_stats(stats: StreamStats) -> StreamStats:
    """Drop the O=1 axis for the single-target view."""
    c = stats.comp
    return stats._replace(
        served_sum=stats.served_sum[0], served_sumsq=stats.served_sumsq[0],
        demand_sum=stats.demand_sum[0], demand_sumsq=stats.demand_sumsq[0],
        alloc_sum=stats.alloc_sum[0], alloc_sumsq=stats.alloc_sumsq[0],
        alloc_windows=stats.alloc_windows[0],
        util_sum=stats.util_sum[0],
        lag_sum=stats.lag_sum[0], lag_sumsq=stats.lag_sumsq[0],
        lag_max=stats.lag_max[0],
        lag_hist=stats.lag_hist[0],
        last_served=stats.last_served[0],
        comp=c._replace(
            served_sum=c.served_sum[0], served_sumsq=c.served_sumsq[0],
            demand_sum=c.demand_sum[0], demand_sumsq=c.demand_sumsq[0],
            alloc_sum=c.alloc_sum[0], alloc_sumsq=c.alloc_sumsq[0],
            util_sum=c.util_sum[0], lag_sum=c.lag_sum[0],
            lag_sumsq=c.lag_sumsq[0], lag_hist=c.lag_hist[0]),
        down_windows=stats.down_windows[0],
        droop_windows=stats.droop_windows[0],
        obs_lost=stats.obs_lost[0],
    )
