"""Performance/fairness metrics over simulator results.

Host-side numpy.  Every function takes numpy arrays or tensors (on any
device: they are copied to the host first) and returns plain floats or
small numpy arrays, so reports serialize straight to JSON.

Two families:

* post-hoc metrics over ``[W, J]`` / ``[W, O, J]`` trajectory arrays;
* ``streaming_*`` counterparts that finalize a ``telemetry.StreamStats``
  carry from a ``telemetry="streaming"`` run -- each is tested to agree
  with its trajectory twin (``tests/test_torch_metrics.py``), so long
  horizons never have to materialize trajectories just to be measured.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.storage import telemetry


def _host(x, dtype=None) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def jain_index(x) -> float:
    """Jain's fairness index over non-negative shares: 1 = perfectly fair,
    1/n = maximally unfair.  Zeros COUNT: a starved participant is the
    unfairest outcome, so callers must pre-select the participating entries
    (see ``fairness``), not rely on zero-dropping here."""
    x = _host(x, np.float64).ravel()
    if x.size == 0 or not (x > 0).any():
        return 1.0
    return float(x.sum() ** 2 / (x.size * (x ** 2).sum()))


def priority_normalized_throughput(served_wj, nodes) -> np.ndarray:
    """[J] total served per job divided by its priority share -- the quantity
    AdapTBF tries to equalize (a job's bandwidth proportional to its compute
    allocation).  served_wj: [..., J] window trajectories."""
    served = _host(served_wj, np.float64)
    total = served.reshape(-1, served.shape[-1]).sum(axis=0)
    share = _host(nodes, np.float64)
    if share.ndim == 2:
        # engine-shaped [O, J] nodes: a job's priority weight is its row
        # sum (shares are normalized below, so nodes broadcast from [J]
        # give exactly the [J] answer)
        share = share.sum(axis=0)
    share = share / share.sum()
    return total / np.maximum(share, 1e-12)


def fairness(served_wj, nodes, demand_wj=None) -> float:
    """Jain index over priority-normalized per-job throughput.

    Participation: jobs that demanded anything (when ``demand_wj`` is given)
    or, failing that, jobs that were served anything.  A job that demanded
    I/O but got zero stays in as a zero -- starvation must drag the index
    down, not vanish from it."""
    norm = priority_normalized_throughput(served_wj, nodes)
    if demand_wj is not None:
        d = _host(demand_wj, np.float64)
        active = d.reshape(-1, d.shape[-1]).sum(axis=0) > 0
    else:
        active = norm > 0
    return jain_index(norm[active])


def mean_utilization(served, capacity_per_window, busy_only: bool = True) -> float:
    """Mean fraction of disk capacity used per window.

    served: [W, J] (single target) or [W, O, J] (fleet);
    capacity_per_window: scalar or [O].  With ``busy_only``, windows where
    nothing was served anywhere are excluded (cold start / drained tail).
    """
    served = _host(served, np.float64)
    util = served.sum(axis=-1) / np.maximum(
        _host(capacity_per_window, np.float64), 1e-12)
    if util.ndim == 2:  # [W, O] -> average over the fleet per window
        busy = util.sum(axis=-1) > 0
        util = util.mean(axis=-1)
    else:
        busy = util > 0
    if busy_only and busy.any():
        util = util[busy]
    return float(util.mean())


def aggregate_mb(served) -> float:
    """Total data moved (1 RPC = 1 MB)."""
    return float(_host(served, np.float64).sum())


def p99_queue(demand, served) -> float:
    """99th percentile of the standing per-window backlog (demand - served,
    clipped at zero), a proxy for tail latency pressure.

    Semantics (audited, DESIGN.md section 13): the engine's per-window
    ``demand`` signal is served + the queue standing at window end, so
    ``demand - served`` *is* the carried backlog -- queues persisting
    across windows are already counted in every later window, not just the
    window that grew them (pinned against a reconstructed per-window queue
    trajectory in ``tests/test_torch_metrics.py``).  The clip removes the f32
    accumulation noise that could otherwise drive the difference a hair
    negative on drained fleets; backlog is never negative.
    """
    lag = _host(demand, np.float64) - _host(served, np.float64)
    return float(np.percentile(np.maximum(lag, 0.0).ravel(), 99))


def utilization(result, cfg, capacity_per_tick=None):
    """Per-window fraction of disk capacity actually used.

    Single target: [n_windows].  Fleet: [n_windows, O] (pass the per-OST
    ``capacity_per_tick`` array used in the run for heterogeneous fleets).
    The single definition -- ``storage.simulator.utilization`` re-exports it.
    """
    served = _host(result.served, np.float64)
    if served.ndim == 3:  # fleet trajectory [W, O, J]
        if capacity_per_tick is None:
            capacity_per_tick = cfg.capacity_per_tick
        cap_w = _host(capacity_per_tick, np.float64) * cfg.window_ticks
        return served.sum(axis=-1) / cap_w
    return served.sum(axis=-1) / (cfg.capacity_per_tick * cfg.window_ticks)


def job_slowdown(served_wj, capacity_per_window) -> np.ndarray:
    """[J] per-job slowdown: windows-to-completion vs. the unthrottled ideal.

    Completion is the last window in which the job received any service;
    the ideal is the windows its total data would need at the full capacity
    of the targets it actually touched (its stripe set), floored at one
    window (the simulator's resolution).  1.0 = the job ran as if alone;
    NaN = the job was never served.  served_wj: [W, J], [W, O, J], or any
    leading batch axes over those ([F, W, O, J] for a batch of fleets --
    rank >= 3 always reads the trailing axes as [W, O, J]);
    capacity_per_window: scalar, [O], or [F, O].  Returns [..., J]; one
    broadcast path for every rank.
    """
    s = _host(served_wj, np.float64)
    cap = _host(capacity_per_window, np.float64)
    if s.ndim >= 3:  # [..., W, O, J]
        cap = np.broadcast_to(cap, s.shape[:-3] + (s.shape[-2],))
        per_oj = s.sum(axis=-3)                               # [..., O, J]
        eff_cap = (cap[..., None] * (per_oj > 0)).sum(axis=-2)  # stripe set
        s = s.sum(axis=-2)                                    # [..., W, J]
    else:
        # [W, J] carries no stripe info: the ideal runs at the summed
        # capacity of all targets (for the single-target view, the scalar)
        eff_cap = cap.sum() if cap.ndim else cap
    total = s.sum(axis=-2)
    any_w = s > 0
    last = np.where(any_w.any(axis=-2),
                    s.shape[-2] - 1 - any_w[..., ::-1, :].argmax(axis=-2), -1)
    ideal = total / np.maximum(eff_cap, 1e-12)
    return np.where(total > 0, (last + 1) / np.maximum(ideal, 1.0), np.nan)


# ------------------------------------------------- streaming counterparts
#
# Finalizers over a ``telemetry.StreamStats`` carry.  Stats arrays are
# [O, J] from ``simulate_fleet`` and [J] from the single-target squeeze;
# every function accepts both, plus any *leading batch axes* over those
# (an [F, O, J] carry of F stacked fleets, the reference's tenant batch):
# reductions run over the trailing row axes only, and scalar-returning
# finalizers return an [F] (or [F1, F2, ...]) array per fleet, the stack
# of the per-fleet values.


def _ksum(stats, field):
    """A compensated sum field + its Kahan residual, in float64."""
    return (_host(getattr(stats, field), np.float64)
            + _host(getattr(stats.comp, field), np.float64))


def _lead_shape(stats) -> tuple:
    """The leading batch axes of a carry: ``windows`` is a scalar in an
    unbatched carry and carries exactly the fleet axes in a batched one,
    so its shape *is* the batch shape."""
    return _host(stats.windows).shape


def _index_stats(stats, idx):
    """The single-fleet slice of a batched carry at leading index ``idx``."""
    vals = []
    for name, leaf in zip(stats._fields, stats):
        if name == "comp":
            vals.append(type(leaf)(*(_host(x)[idx] for x in leaf)))
        else:
            vals.append(_host(leaf)[idx])
    return type(stats)(*vals)


def _per_job(stats):
    """(served[J], demand[J], last_served[J], fleet: bool) from stats."""
    served = _ksum(stats, "served_sum")
    demand = _ksum(stats, "demand_sum")
    last = _host(stats.last_served)
    if served.ndim == 2:
        return served.sum(axis=0), demand.sum(axis=0), last.max(axis=0), True
    return served, demand, last, False


def streaming_aggregate_mb(stats):
    """Total data moved (1 RPC = 1 MB); twin of ``aggregate_mb``.  Returns
    a float, or [F] totals for a batched carry."""
    served = _ksum(stats, "served_sum")
    lead = _lead_shape(stats)
    total = served.sum(axis=tuple(range(len(lead), served.ndim)))
    return total if lead else float(total)


def streaming_fairness(stats, nodes):
    """Twin of ``fairness`` over the whole horizon: Jain index of
    priority-normalized total throughput, demand-based participation.

    ``nodes``: [J] or engine-shaped [O, J] shared, or batched with the
    carry's leading axes ([F, J] / [F, O, J], the nodes of each fleet).
    A leading-axes match breaks the
    [F, J]-vs-[O, J] rank tie in favor of per-fleet.  Participation
    masks are data-dependent per fleet, so the batched value is defined
    as the stack of per-fleet values."""
    lead = _lead_shape(stats)
    if lead:
        nodes = _host(nodes, np.float64)
        per_fleet_nodes = (nodes.ndim == len(lead) + 2
                           or (nodes.ndim == len(lead) + 1
                               and nodes.shape[:len(lead)] == lead))
        out = [streaming_fairness(_index_stats(stats, i),
                                  nodes[i] if per_fleet_nodes else nodes)
               for i in np.ndindex(lead)]
        return _host(out).reshape(lead)
    served, demand, _, _ = _per_job(stats)
    norm = priority_normalized_throughput(served, nodes)
    return jain_index(norm[demand > 0])


def streaming_mean_utilization(stats, busy_only: bool = True):
    """Twin of ``mean_utilization`` (same busy-window semantics).

    A fleet-idle window contributes zero utilization on every OST, so the
    sum of per-window fleet means over *busy* windows equals the fleet mean
    of the per-OST ``util_sum`` rows -- which is all the carry keeps (the
    per-OST layout is what makes the carry OST-shardable, DESIGN.md
    section 8).  Reductions run over the trailing row axes only, so a
    batched carry yields per-fleet means (each fleet selecting its own
    busy-vs-total denominator)."""
    util = _ksum(stats, "util_sum")
    lead = _lead_shape(stats)
    trail = tuple(range(len(lead), util.ndim))
    util_mean = util.mean(axis=trail) if trail else util
    busy = _host(stats.busy_windows, np.float64)
    windows = np.maximum(_host(stats.windows, np.float64), 1.0)
    denom = np.where(np.logical_and(busy_only, busy > 0), busy, windows)
    out = util_mean / denom
    return out if lead else float(out)


def streaming_p99_queue(stats, q: float = 99.0):
    """Twin of ``p99_queue`` from the log-spaced backlog histogram: returns
    the upper edge of the bin holding the q-th percentile (within one bin
    width, ~16%/bin at the default 128-bin resolution).  Per-fleet edges
    for a batched carry (the quantile search is data-dependent)."""
    lead = _lead_shape(stats)
    if lead:
        out = [streaming_p99_queue(_index_stats(stats, i), q)
               for i in np.ndindex(lead)]
        return _host(out).reshape(lead)
    hist = _ksum(stats, "lag_hist")
    if hist.ndim == 2:  # fleet carry keeps one histogram row per OST
        hist = hist.sum(axis=0)
    total = hist.sum()
    if total == 0:
        return 0.0
    b = int(np.searchsorted(hist.cumsum(), total * q / 100.0))
    return telemetry.bin_upper_edge(min(b, hist.size - 1))


def streaming_job_slowdown(stats, capacity_per_window) -> np.ndarray:
    """Twin of ``job_slowdown`` from carry-resident statistics.

    ``capacity_per_window``: scalar or [O] shared, or batched with the
    carry's leading axes ([F, O]).  Returns [..., J]."""
    lead = _lead_shape(stats)
    if lead:
        cap = _host(capacity_per_window, np.float64)
        per_fleet_cap = cap.ndim == len(lead) + 1
        out = [streaming_job_slowdown(_index_stats(stats, i),
                                      cap[i] if per_fleet_cap else cap)
               for i in np.ndindex(lead)]
        return _host(out).reshape(lead + out[0].shape)
    served, _, last, fleet = _per_job(stats)
    cap = _host(capacity_per_window, np.float64)
    if fleet:
        per_oj = _ksum(stats, "served_sum")
        cap = np.broadcast_to(cap, (per_oj.shape[0],))
        eff_cap = (cap[:, None] * (per_oj > 0)).sum(axis=0)
    else:
        # same broadcast unification as ``job_slowdown``: [J] stats carry
        # no stripe info, so an [O] capacity sums to the total ideal rate
        eff_cap = cap.sum() if cap.ndim else cap
    ideal = served / np.maximum(eff_cap, 1e-12)
    return np.where(served > 0, (last + 1) / np.maximum(ideal, 1.0), np.nan)
