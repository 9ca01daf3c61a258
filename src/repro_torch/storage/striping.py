"""Client-side striping policies: map job-level RPC streams onto OSTs.

A Lustre client stripes each file over a subset of the fleet's targets.  The
policies here convert a job-level ``Scenario`` trace (``[T, J]`` RPCs/tick)
into the per-target demand arrays ``simulate_fleet`` consumes:

* ``route_round_robin`` -- classic fixed-width striping: each job's stream is
  spread evenly over its ``stripe_count`` targets, placed round-robin by job
  index (Lustre default layout).
* ``route_progressive`` -- progressive file layout (PFL): the stripe width
  grows with the file offset, so small files stay on one OST while large
  files widen out.  Weights are derived tick-by-tick from the cumulative
  issued volume of the trace (a host-side precomputation -- the
  simulator never sees the layout logic).

Both conserve demand exactly: summing the routed ``[T, O, J]`` rates over the
OST axis reproduces the (volume-clipped) job-level trace.  Per-target backlog
caps are the job's full cap on every target it touches, modelling Lustre's
per-OSC ``max_rpcs_in_flight``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class FleetDemand(NamedTuple):
    """Per-target demand for ``simulate_fleet``."""

    issue_rate: np.ndarray   # [T, O, J] RPCs/tick routed to each target
    volume: np.ndarray       # [O, J] total RPCs per job per target
    max_backlog: np.ndarray  # [O, J] client in-flight cap per target


def stripe_targets(job: int, n_ost: int, stripe_count: int) -> np.ndarray:
    """OST indices of a job's stripe set: ``stripe_count`` consecutive targets
    starting at ``job % n_ost`` (round-robin placement)."""
    if not 1 <= stripe_count <= n_ost:
        raise ValueError(f"stripe_count must be in [1, {n_ost}]")
    return (job % n_ost + np.arange(stripe_count)) % n_ost


def stripe_weights(n_jobs: int, n_ost: int,
                   stripe_count: Optional[np.ndarray] = None) -> np.ndarray:
    """[O, J] routing fractions; column j spreads evenly over job j's stripe
    set.  ``stripe_count``: per-job widths (default: full width for all)."""
    if stripe_count is None:
        stripe_count = np.full(n_jobs, n_ost, np.int64)
    else:
        stripe_count = np.asarray(stripe_count, np.int64)
    w = np.zeros((n_ost, n_jobs), np.float32)
    for j in range(n_jobs):
        w[stripe_targets(j, n_ost, int(stripe_count[j])), j] = \
            1.0 / float(stripe_count[j])
    return w


def _clip_to_volume(issue_rate: np.ndarray, volume: np.ndarray) -> np.ndarray:
    """Clip a [T, J] trace so each job's cumulative issuance never exceeds its
    volume (the closed-loop bound the client enforces)."""
    cum = np.cumsum(issue_rate, axis=0)
    capped = np.minimum(cum, np.asarray(volume, np.float64)[None, :])
    return np.diff(capped, axis=0, prepend=0.0).astype(np.float32)


def route_round_robin(
    issue_rate: np.ndarray,
    volume: np.ndarray,
    max_backlog: np.ndarray,
    n_ost: int,
    stripe_count: Optional[np.ndarray] = None,
) -> FleetDemand:
    """Fixed-width striping.  issue_rate [T, J], volume/max_backlog [J]."""
    _, n_jobs = issue_rate.shape
    w = stripe_weights(n_jobs, n_ost, stripe_count)            # [O, J]
    clipped = _clip_to_volume(issue_rate, volume)
    rates = clipped[:, None, :] * w[None, :, :]                # [T, O, J]
    volume = np.asarray(volume, np.float32)
    # inf * weight would be nan on zero-weight targets; keep inf on the
    # stripe set only
    vol_oj = np.where(w > 0, volume[None, :], 0.0) * np.where(w > 0, w, 1.0)
    backlog_oj = np.where(w > 0, np.asarray(max_backlog, np.float32)[None, :], 0.0)
    return FleetDemand(rates.astype(np.float32), vol_oj.astype(np.float32),
                       backlog_oj.astype(np.float32))


DEFAULT_EXTENTS: Tuple[Tuple[float, int], ...] = ((64.0, 1), (1024.0, 4))


def route_progressive(
    issue_rate: np.ndarray,
    volume: np.ndarray,
    max_backlog: np.ndarray,
    n_ost: int,
    extents: Sequence[Tuple[float, int]] = DEFAULT_EXTENTS,
) -> FleetDemand:
    """Progressive file layout: stripe width per extent of the file offset.

    ``extents`` is a sequence of (end_offset_rpcs, stripe_count) pairs; file
    regions past the last boundary stripe over all ``n_ost`` targets.  E.g.
    the default lays the first 64 RPCs (64 MB) on one OST, the next extent up
    to 1024 RPCs over four, and everything beyond over the whole fleet.
    """
    t_total, n_jobs = issue_rate.shape
    clipped = _clip_to_volume(issue_rate, volume)
    offset = np.cumsum(clipped, axis=0) - clipped  # file offset at tick start
    bounds = [float(b) for b, _ in extents] + [np.inf]
    widths = [int(w) for _, w in extents] + [n_ost]
    # per-extent weight tables [E, O, J]
    w_ext = np.stack([
        stripe_weights(n_jobs, n_ost, np.full(n_jobs, w, np.int64))
        for w in widths
    ])
    # extent index of every (tick, job): first boundary strictly above offset
    ext = np.searchsorted(np.asarray(bounds[:-1]), offset, side="right")
    # per-(tick, job) weight column over targets: [T, J, O]
    w_tjo = w_ext[ext, :, np.arange(n_jobs)[None, :]]
    rates = np.transpose(clipped[:, :, None] * w_tjo, (0, 2, 1))  # [T, O, J]
    vol_oj = rates.sum(axis=0)
    unbounded = ~np.isfinite(np.asarray(volume, np.float64))
    if unbounded.any():
        # unbounded jobs keep issuing past the trace horizon: leave their
        # touched targets unbounded too
        vol_oj = np.where((vol_oj > 0) & unbounded[None, :], np.inf, vol_oj)
    backlog_oj = np.broadcast_to(
        np.asarray(max_backlog, np.float32)[None, :], vol_oj.shape).copy()
    return FleetDemand(rates.astype(np.float32), vol_oj.astype(np.float32),
                       backlog_oj.astype(np.float32))


POLICIES = {
    "round_robin": route_round_robin,
    "progressive": route_progressive,
}


def route(policy: str, issue_rate, volume, max_backlog, n_ost, **kw) -> FleetDemand:
    """Route a job-level trace through a named striping policy."""
    try:
        fn = POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown striping policy {policy!r}; have {sorted(POLICIES)}")
    return fn(issue_rate, volume, max_backlog, n_ost, **kw)
