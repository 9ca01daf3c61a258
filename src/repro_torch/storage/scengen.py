"""Procedural scenario construction: a composable trace algebra plus a
seeded fleet generator.

A QoS mechanism is made or broken by workload *shape* (metadata storms,
phase changes, feedback instability; cf. PADLL, arXiv:2302.06418, and
control-theoretic throttling, arXiv:2511.16177).  This module manufactures
arbitrary shapes from a small algebra and draws whole fleets from seeded
profiles.  It is numpy only and gives bitwise the arrays of the reference
package's ``storage/scengen.py`` (``tests/test_torch_scengen.py``).

Trace algebra
-------------
A :class:`Trace` is a lazy ``[T]`` rate builder: calling it with a tick
count materializes a float32 RPCs/tick array.  Primitives::

    constant(r)                   flat rate
    phases((d0, r0), (d1, r1))    piecewise-constant phase changes
    ramp(r0, r1, start, end)      linear rate sweep
    bursts(rpcs, interval, ...)   periodic bursts
    onoff(r, p_on, p_off, seed)   Markov-modulated on-off source
    diurnal(mean, swing, period)  sinusoidal load cycle
    replay(samples) / replay_csv(path)   recorded-trace replay

compose by ``+`` (superposition) and ``*`` (scaling) and transform with
``.shift(ticks)`` (delay), ``.between(a, b)`` (activity window -- job
arrival/departure), and ``.clip(lo, hi)``.

Fleet generation
----------------
:func:`random_fleet` draws a whole multi-OST scenario from a seeded
profile -- ``noisy`` / ``burst`` / ``churn`` / ``saturation`` / ``mixed``
(see ``PROFILES`` and DESIGN.md section 9) -- and routes the per-job
traces through the existing striping policies (``storage/striping.py``)
into a ``FleetScenario``.  The same seed always yields the same arrays
(pure ``numpy.random.default_rng``), so generated scenarios can anchor
regression tests and committed benchmark artifacts.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.storage import faults, striping
from repro_torch.storage.workloads import FleetScenario


# ------------------------------------------------------------ trace algebra


class Trace:
    """A lazy ``[T]`` issue-rate trace: ``trace(t_ticks)`` materializes a
    float32 RPCs/tick array of exactly that length.

    Keeping traces lazy (length-free) is what makes the algebra compose:
    a shifted sum of windowed primitives needs no horizon until a scenario
    finally fixes one.
    """

    __slots__ = ("_fn",)

    #: opt out of numpy's ufunc dispatch: ndarray + Trace must hand the
    #: whole array to __radd__ (-> replay + Trace), not broadcast Trace as
    #: an object scalar into an ndarray of per-element Traces
    __array_ufunc__ = None

    def __init__(self, fn: Callable[[int], np.ndarray]):
        self._fn = fn

    def __call__(self, t_ticks: int) -> np.ndarray:
        t = int(t_ticks)
        if t <= 0:
            raise ValueError(f"t_ticks must be positive, got {t}")
        out = np.asarray(self._fn(t), np.float32)
        if out.shape != (t,):
            raise ValueError(
                f"trace produced shape {out.shape}, expected ({t},)")
        return out

    # -- composition ------------------------------------------------------
    def __add__(self, other) -> "Trace":
        other = as_trace(other)
        return Trace(lambda t: self(t) + other(t))

    def __radd__(self, other) -> "Trace":
        if isinstance(other, (int, float)) and other == 0:
            return self  # so sum(traces) works
        # coerce BEFORE numpy broadcasts us element-wise into an
        # object-dtype array: ndarray + Trace must mean replay + Trace
        return as_trace(other).__add__(self)

    def __mul__(self, k) -> "Trace":
        k32 = np.float32(k)
        return Trace(lambda t: self(t) * k32)

    __rmul__ = __mul__

    # -- transformation ---------------------------------------------------
    def shift(self, ticks: int) -> "Trace":
        """Delay by ``ticks``: zeros before, the original trace after (the
        delayed tail past the horizon is dropped)."""
        k = int(ticks)
        if k < 0:
            raise ValueError(f"shift must be non-negative, got {k}")
        if k == 0:
            return self

        def fn(t):
            out = np.zeros(t, np.float32)
            if k < t:
                out[k:] = self(t - k)
            return out
        return Trace(fn)

    def between(self, start_tick: int, end_tick: Optional[int]) -> "Trace":
        """Zero outside ``[start_tick, end_tick)`` -- a job that arrives at
        ``start_tick`` and departs at ``end_tick`` (None = never)."""
        s = int(start_tick)

        def fn(t):
            out = self(t).copy()
            out[:s] = 0.0
            if end_tick is not None:
                out[int(end_tick):] = 0.0
            return out
        return Trace(fn)

    def clip(self, lo: float = 0.0, hi: Optional[float] = None) -> "Trace":
        return Trace(lambda t: np.clip(self(t), np.float32(lo),
                                       None if hi is None else np.float32(hi)))


def as_trace(x) -> Trace:
    """Coerce a Trace, scalar rate, or 1-D sample array to a Trace."""
    if isinstance(x, Trace):
        return x
    if np.ndim(x) == 0:
        return constant(float(x))
    return replay(np.asarray(x))


def constant(rate: float) -> Trace:
    """A flat ``rate`` RPCs/tick source."""
    return Trace(lambda t: np.full(t, rate, np.float32))


def phases(*segments: Tuple[Optional[int], float]) -> Trace:
    """Piecewise-constant phase changes: ``(duration_ticks, rate)`` pairs
    consumed in order; a ``None`` duration (or trailing time after the last
    segment) holds that rate to the end of the horizon."""
    if not segments:
        raise ValueError("phases() needs at least one (duration, rate) pair")
    if any(dur is None for dur, _ in segments[:-1]):
        raise ValueError("only the final phases() segment may have duration "
                         "None (an earlier one would swallow the rest)")

    def fn(t):
        out = np.empty(t, np.float32)
        pos = 0
        rate = segments[-1][1]
        for dur, r in segments:
            end = t if dur is None else min(pos + int(dur), t)
            out[pos:end] = r
            pos = end
        out[pos:] = rate
        return out
    return Trace(fn)


def ramp(rate0: float, rate1: float, start_tick: int = 0,
         end_tick: Optional[int] = None) -> Trace:
    """Linear sweep from ``rate0`` to ``rate1`` over
    ``[start_tick, end_tick)``; flat before and after."""
    def fn(t):
        end = t if end_tick is None else min(int(end_tick), t)
        out = np.full(t, rate1, np.float32)
        out[:start_tick] = rate0
        n = max(end - start_tick, 0)
        if n:
            out[start_tick:end] = np.linspace(
                rate0, rate1, n, endpoint=False, dtype=np.float32)
        return out
    return Trace(fn)


def bursts(burst_rpcs: float, interval_ticks: int, burst_ticks: int = 2,
           start_tick: int = 0) -> Trace:
    """Short I/O bursts of ``burst_rpcs`` spread over ``burst_ticks`` ticks,
    repeating every ``interval_ticks`` (the primitive behind
    ``workloads.periodic_bursts``, bitwise-pinned)."""
    def fn(t):
        out = np.zeros(t, np.float32)
        per_tick = burst_rpcs / burst_ticks
        for t0 in range(start_tick, t, int(interval_ticks)):
            out[t0: t0 + burst_ticks] += per_tick
        return out
    return Trace(fn)


def onoff(rate: float, p_on: float, p_off: float, seed: int) -> Trace:
    """Markov-modulated on-off source: per tick, an OFF source turns on
    with probability ``p_on`` and an ON source turns off with probability
    ``p_off`` (geometric sojourns; duty cycle ``p_on / (p_on + p_off)``).
    The initial state is drawn from the stationary distribution, so the
    process has no warm-up transient."""
    if not (0.0 < p_on <= 1.0 and 0.0 < p_off <= 1.0):
        raise ValueError(f"p_on/p_off must be in (0, 1], got {p_on}/{p_off}")

    def fn(t):
        rng = np.random.default_rng(seed)
        out = np.zeros(t, np.float32)
        on = rng.random() < p_on / (p_on + p_off)
        pos = 0
        while pos < t:
            dur = int(rng.geometric(p_off if on else p_on))
            if on:
                out[pos: pos + dur] = rate
            pos += dur
            on = not on
        return out
    return Trace(fn)


def diurnal(mean: float, swing: float, period_ticks: int,
            phase_tick: int = 0) -> Trace:
    """Sinusoidal load cycle: ``mean + swing * sin(...)``, floored at zero
    (a swing above the mean produces idle troughs)."""
    def fn(t):
        x = (np.arange(t, dtype=np.float64) + phase_tick) \
            * (2.0 * np.pi / period_ticks)
        return np.maximum(mean + swing * np.sin(x), 0.0).astype(np.float32)
    return Trace(fn)


def replay(samples, scale: float = 1.0, tile: bool = True) -> Trace:
    """Replay a recorded 1-D rate trace: tiled periodically (default) or
    zero-padded to the horizon, truncated when longer."""
    samples = np.asarray(samples, np.float32).ravel() * np.float32(scale)
    if samples.size == 0:
        raise ValueError("replay() needs a non-empty sample array")

    def fn(t):
        if tile:
            reps = -(-t // samples.size)
            return np.tile(samples, reps)[:t]
        out = np.zeros(t, np.float32)
        out[:min(t, samples.size)] = samples[:t]
        return out
    return Trace(fn)


def replay_csv(path, column: int = 0, delimiter: str = ",",
               skip_header: int = 0, scale: float = 1.0,
               tile: bool = True) -> Trace:
    """Replay one column of a CSV file as a rate trace (e.g. an RPCs/tick
    series exported from a Lustre jobstats collector)."""
    data = np.genfromtxt(path, delimiter=delimiter, skip_header=skip_header,
                         usecols=(column,), dtype=np.float64)
    data = np.atleast_1d(data)
    if np.isnan(data).any():
        raise ValueError(f"non-numeric entries in {path!r} column {column}")
    return replay(data, scale=scale, tile=tile)


# ------------------------------------------------------------ churn process


def churn_windows(rng, n_jobs: int, t_ticks: int,
                  arrival_rate: Optional[float] = None,
                  mean_lifetime: Optional[float] = None,
                  initial_active_frac: float = 0.3) -> np.ndarray:
    """Poisson arrival/departure windows: ``[J, 2]`` int (start, end) ticks.

    A fraction of jobs is already running at t=0; the rest arrive as a
    Poisson process (exponential inter-arrivals at ``arrival_rate`` jobs
    per tick) and every job's lifetime is exponential with mean
    ``mean_lifetime`` ticks.  Defaults size both so most jobs arrive and
    depart inside the horizon.  Jobs whose arrival lands past the horizon
    simply never activate -- that is churn too.
    """
    rng = np.random.default_rng(rng) if not isinstance(
        rng, np.random.Generator) else rng
    if arrival_rate is None:
        arrival_rate = n_jobs / (0.6 * t_ticks)
    if mean_lifetime is None:
        mean_lifetime = 0.4 * t_ticks
    starts = np.zeros(n_jobs, np.int64)
    initial = rng.random(n_jobs) < initial_active_frac
    n_late = int((~initial).sum())
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n_late))
    starts[~initial] = arrivals.astype(np.int64)
    ends = starts + np.maximum(
        rng.exponential(mean_lifetime, n_jobs), 1.0).astype(np.int64)
    return np.stack([starts, np.minimum(ends, t_ticks)], axis=1)


def apply_churn(traces: Sequence[Trace], windows: np.ndarray) -> list:
    """Mask each trace to its (start, end) activity window."""
    return [tr.between(int(s), int(e)) for tr, (s, e) in zip(traces, windows)]


# -------------------------------------------------------------- fleet build


class JobSpec(NamedTuple):
    """One job of a generated fleet scenario."""

    trace: Trace                       # aggregate issue rate (RPCs/tick)
    nodes: float                       # compute nodes (priority weight)
    volume: float = np.inf             # total RPCs (inf = unbounded)
    max_backlog: float = 256.0         # client in-flight cap
    stripe_count: Optional[int] = None  # round_robin width (None = full)


def build_fleet(name: str, jobs: Sequence[JobSpec], n_ost: int,
                capacity_per_tick=20.0, duration_s: float = 20.0,
                tick_s: float = 0.01, policy: str = "round_robin",
                **route_kw):
    """Materialize job specs and route them through a striping policy into
    a ``FleetScenario`` for ``simulate_fleet``."""
    if not jobs:
        raise ValueError("build_fleet needs at least one JobSpec")
    if policy != "round_robin" and any(
            spec.stripe_count is not None for spec in jobs):
        raise ValueError(
            f"JobSpec.stripe_count only applies to the round_robin striping "
            f"policy; the {policy!r} policy derives its own widths -- drop "
            "the stripe_count fields or pass policy-specific route kwargs")
    t = int(duration_s / tick_s)
    issue = np.stack([spec.trace(t) for spec in jobs], axis=1)
    nodes = np.asarray([spec.nodes for spec in jobs], np.float32)
    volume = np.asarray([spec.volume for spec in jobs], np.float32)
    backlog = np.asarray([spec.max_backlog for spec in jobs], np.float32)
    capacity = np.broadcast_to(
        np.asarray(capacity_per_tick, np.float32), (n_ost,)).copy()
    if policy == "round_robin" and "stripe_count" not in route_kw:
        route_kw["stripe_count"] = np.asarray(
            [n_ost if spec.stripe_count is None else int(spec.stripe_count)
             for spec in jobs], np.int64)
    demand = striping.route(policy, issue, volume, backlog, n_ost, **route_kw)
    return FleetScenario(name, nodes, demand.issue_rate, demand.volume,
                         demand.max_backlog, capacity, duration_s, tick_s)


# ---------------------------------------------------------------- profiles
#
# Each profile maps (rng, t_ticks, n_ost, n_jobs, cap) -> (jobs, capacity,
# striping policy).  ``share`` below is a job's fleet-wide fair share in
# RPCs/tick (total capacity / jobs); rates are drawn relative to it so a
# profile keeps its contention character at any (n_ost, n_jobs) scale.
# Definitions are documented in DESIGN.md section 9.


def _share(cap: float, n_ost: int, n_jobs: int) -> float:
    return cap * n_ost / n_jobs


def _profile_noisy(rng, t, n_ost, n_jobs, cap):
    """Noisy-neighbor-like: a few low-priority hogs hammer 1-2 stripes with
    sustained traffic several times their share while well-provisioned wide
    jobs (bursty + continuous mix) sweep the whole fleet."""
    share = _share(cap, n_ost, n_jobs)
    n_hogs = max(1, n_jobs // 6)
    jobs = []
    for _ in range(n_hogs):
        jobs.append(JobSpec(
            trace=constant(rng.uniform(1.5, 3.0) * share),
            nodes=float(rng.integers(1, 3)),
            max_backlog=128.0,
            stripe_count=int(rng.integers(1, min(3, n_ost) + 1))))
    for j in range(n_jobs - n_hogs):
        nodes = float(rng.integers(8, 64))
        if j % 2 == 0:
            interval = int(rng.integers(200, 500))
            tr = bursts(burst_rpcs=rng.uniform(2.0, 6.0) * share * interval
                        / 8.0,
                        interval_ticks=interval,
                        burst_ticks=int(rng.integers(20, 80)),
                        start_tick=int(rng.integers(0, interval)))
        else:
            tr = constant(rng.uniform(0.5, 1.2) * share)
        jobs.append(JobSpec(trace=tr, nodes=nodes))
    return jobs, np.full(n_ost, cap, np.float32), "round_robin"


def _profile_burst(rng, t, n_ost, n_jobs, cap):
    """Burst-storm-like: almost every job is a bursty source (periodic
    bursts or Markov on-off) with randomized phase, over a thin continuous
    background; progressive striping so each burst starts narrow and widens
    as its file grows."""
    share = _share(cap, n_ost, n_jobs)
    jobs = []
    for j in range(n_jobs - 1):
        nodes = float(rng.integers(8, 48))
        if rng.random() < 0.5:
            interval = int(rng.integers(150, 600))
            tr = bursts(burst_rpcs=rng.uniform(1.0, 4.0) * share * interval
                        / 4.0,
                        interval_ticks=interval,
                        burst_ticks=int(rng.integers(2, 40)),
                        start_tick=int(rng.integers(0, interval)))
        else:
            duty = rng.uniform(0.15, 0.5)
            p_off = rng.uniform(0.01, 0.05)
            tr = onoff(rate=rng.uniform(2.0, 5.0) * share,
                       p_on=p_off * duty / (1.0 - duty), p_off=p_off,
                       seed=int(rng.integers(2**31)))
        jobs.append(JobSpec(trace=tr, nodes=nodes, max_backlog=256.0))
    jobs.append(JobSpec(trace=constant(0.8 * share),
                        nodes=float(rng.integers(2, 8))))
    return jobs, np.full(n_ost, cap, np.float32), "progressive"


def _profile_churn(rng, t, n_ost, n_jobs, cap):
    """Churn-like: Poisson arrival/departure over steady sources, so every
    OST's active set keeps changing and window-0 cold starts recur."""
    share = _share(cap, n_ost, n_jobs)
    base = []
    for _ in range(n_jobs):
        kind = rng.integers(3)
        if kind == 0:
            tr = constant(rng.uniform(0.8, 2.5) * share)
        elif kind == 1:
            tr = ramp(rng.uniform(0.2, 1.0) * share,
                      rng.uniform(1.5, 3.0) * share, end_tick=t)
        else:
            tr = diurnal(mean=rng.uniform(0.8, 2.0) * share,
                         swing=rng.uniform(0.5, 1.5) * share,
                         period_ticks=int(rng.integers(t // 4, t)),
                         phase_tick=int(rng.integers(t)))
        base.append(tr)
    traces = apply_churn(base, churn_windows(rng, n_jobs, t))
    widths = [1, 2, min(4, n_ost), n_ost]
    jobs = [JobSpec(trace=tr, nodes=float(rng.integers(4, 48)),
                    max_backlog=128.0,
                    stripe_count=int(widths[rng.integers(len(widths))]))
            for tr in traces]
    return jobs, np.full(n_ost, cap, np.float32), "round_robin"


def _profile_saturation(rng, t, n_ost, n_jobs, cap):
    """Adversarial saturation: every job demands a multiple of its share
    for the whole horizon (constant floor + diurnal swell), priorities
    heavily skewed, a third of the jobs bounded so completions keep
    shuffling the contending set, and half the targets degraded."""
    share = _share(cap, n_ost, n_jobs)
    jobs = []
    for _ in range(n_jobs):
        tr = constant(rng.uniform(1.5, 3.0) * share) + diurnal(
            mean=0.0, swing=rng.uniform(0.5, 2.0) * share,
            period_ticks=int(rng.integers(t // 3, t)),
            phase_tick=int(rng.integers(t)))
        volume = np.inf
        if rng.random() < 0.33:
            volume = float(rng.uniform(0.1, 0.5) * share * t)
        # skewed priorities: a few giants dominate the share vector
        nodes = float(rng.integers(1, 8)) if rng.random() < 0.7 \
            else float(rng.integers(32, 128))
        jobs.append(JobSpec(trace=tr, nodes=nodes, volume=volume,
                            max_backlog=float(rng.choice([64.0, 256.0]))))
    # half the targets degraded to 40%: the FaultPlan capacity-droop
    # primitive, horizon-constant and therefore baked into the static
    # capacity vector (a droop that never lifts IS a smaller capacity).
    # Consumed after the per-job loop and bitwise-pinned by
    # tests/test_scengen.py::test_saturation_profile_pinned, so existing
    # seed grids do not shift.
    capacity = faults.degraded_capacity(rng, n_ost, cap,
                                        p_degraded=0.5, scale=0.4)
    return jobs, capacity, "round_robin"


def _profile_mixed(rng, t, n_ost, n_jobs, cap):
    """Mixed draw: each job samples an archetype (continuous / periodic
    burst / Markov on-off / ramp / diurnal), ~40% churned, ~25% volume
    bounded, random stripe widths, mildly heterogeneous targets."""
    share = _share(cap, n_ost, n_jobs)
    base = []
    for _ in range(n_jobs):
        kind = rng.integers(5)
        if kind == 0:
            tr = constant(rng.uniform(0.5, 2.5) * share)
        elif kind == 1:
            interval = int(rng.integers(150, 700))
            tr = bursts(burst_rpcs=rng.uniform(1.0, 5.0) * share * interval
                        / 6.0,
                        interval_ticks=interval,
                        burst_ticks=int(rng.integers(2, 60)),
                        start_tick=int(rng.integers(0, interval)))
        elif kind == 2:
            duty = rng.uniform(0.15, 0.6)
            p_off = rng.uniform(0.005, 0.05)
            tr = onoff(rate=rng.uniform(1.5, 4.0) * share,
                       p_on=p_off * duty / (1.0 - duty), p_off=p_off,
                       seed=int(rng.integers(2**31)))
        elif kind == 3:
            tr = ramp(rng.uniform(0.0, 1.0) * share,
                      rng.uniform(1.5, 3.5) * share, end_tick=t)
        else:
            tr = diurnal(mean=rng.uniform(0.5, 2.0) * share,
                         swing=rng.uniform(0.5, 2.0) * share,
                         period_ticks=int(rng.integers(t // 4, t)),
                         phase_tick=int(rng.integers(t)))
        base.append(tr)
    windows = churn_windows(rng, n_jobs, t, initial_active_frac=1.0)
    churned = rng.random(n_jobs) < 0.4
    jobs = []
    widths = [1, 2, min(4, n_ost), n_ost]
    for j, tr in enumerate(base):
        if churned[j]:
            tr = tr.between(int(windows[j, 0]), int(windows[j, 1]))
        volume = np.inf
        if rng.random() < 0.25:
            volume = float(rng.uniform(0.1, 0.6) * share * t)
        jobs.append(JobSpec(
            trace=tr, nodes=float(rng.integers(1, 64)), volume=volume,
            max_backlog=float(rng.choice([32.0, 128.0, 256.0])),
            stripe_count=int(widths[rng.integers(len(widths))])))
    capacity = rng.uniform(0.6 * cap, 1.2 * cap, n_ost).astype(np.float32)
    return jobs, capacity, "round_robin"


PROFILES: Dict[str, Callable] = {
    "noisy": _profile_noisy,
    "burst": _profile_burst,
    "churn": _profile_churn,
    "saturation": _profile_saturation,
    "mixed": _profile_mixed,
}


def random_fleet(seed: int, n_ost: int = 8, n_jobs: int = 8,
                 profile: str = "mixed", duration_s: float = 20.0,
                 tick_s: float = 0.01, capacity_per_tick: float = 20.0):
    """Draw a whole fleet scenario from a seeded profile.

    Deterministic: the same ``(seed, shape, profile)`` always produces the
    same arrays, so generated scenarios can be pinned in tests and
    committed benchmark artifacts.  Returns a ``FleetScenario``.
    """
    try:
        build = PROFILES[profile]
    except KeyError:
        raise ValueError(
            f"unknown profile {profile!r}; have {sorted(PROFILES)}")
    if n_ost < 1 or n_jobs < 1:
        raise ValueError(f"need n_ost >= 1 and n_jobs >= 1, "
                         f"got {n_ost}/{n_jobs}")
    # fold the profile into the seed stream so equal seeds across profiles
    # do not share draws; derived from the profile NAME, not its position
    # in PROFILES, so registering a new profile never shifts the draws of
    # existing ones (pinned tests and committed artifacts stay valid)
    rng = np.random.default_rng(
        [int(seed), zlib.crc32(profile.encode())])
    t = int(duration_s / tick_s)
    jobs, capacity, policy = build(rng, t, n_ost, n_jobs,
                                   float(capacity_per_tick))
    return build_fleet(f"fleet_gen_{profile}[s{seed}]", jobs, n_ost,
                       capacity_per_tick=capacity, duration_s=duration_s,
                       tick_s=tick_s, policy=policy)
