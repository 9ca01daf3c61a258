"""Synthetic workload scenarios: the paper's Filebench experiments (Sections
IV-D, IV-E, IV-F) plus fleet-scale scenarios, behind a named registry.

Scaling: 1 RPC = 1 MB.  A 16-process x 1 GB file-per-process job is 16384 RPCs
of total volume; client aggregate issue capability is the NIC-side bound
(>= OST capacity, so continuous jobs can saturate the target).  The per-job
client backlog cap models Lustre ``max_rpcs_in_flight`` (~16) x processes.

Registry
--------
Every builder is registered under its scenario name::

    from repro_torch.storage import get_scenario, list_scenarios
    scn = get_scenario("fleet_noisy_neighbor", duration_s=20.0)

Single-target builders return a ``Scenario`` for ``simulator.simulate``;
fleet builders return a ``FleetScenario`` whose job streams have already been
routed across OSTs by a striping policy (``storage.striping``) for
``simulator.simulate_fleet``.  Everything here is numpy, built from the
same seeds as the reference package's ``storage/workloads.py``, so every
registered scenario's arrays equal the reference's bitwise
(``tests/test_torch_workloads.py``).
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, NamedTuple

import numpy as np

from repro_torch.storage import scengen, striping

GB_RPCS = 1024          # RPCs per 1 GB file at 1 MB per RPC
IN_FLIGHT_PER_PROC = 16  # Lustre client max_rpcs_in_flight


class Scenario(NamedTuple):
    name: str
    nodes: np.ndarray        # [J] compute nodes (priorities)
    issue_rate: np.ndarray   # [T, J] RPCs/tick
    volume: np.ndarray       # [J] total RPCs (inf = unbounded)
    max_backlog: np.ndarray  # [J] client in-flight cap
    duration_s: float
    tick_seconds: float = 0.01


class FleetScenario(NamedTuple):
    name: str
    nodes: np.ndarray              # [J] compute nodes (priorities)
    issue_rate: np.ndarray         # [T, O, J] RPCs/tick routed per target
    volume: np.ndarray             # [O, J] total RPCs per target
    max_backlog: np.ndarray        # [O, J] client in-flight cap per target
    capacity_per_tick: np.ndarray  # [O] per-OST service rate (RPCs/tick)
    duration_s: float
    tick_seconds: float = 0.01

    @property
    def n_ost(self) -> int:
        return self.issue_rate.shape[1]


SCENARIOS: Dict[str, Callable] = {}


def _scenario_kind(fn) -> str:
    """"Scenario" | "FleetScenario" | "" from a builder's return annotation
    (``from __future__ import annotations`` makes annotations strings, so
    both the class object and its possibly-dotted name are accepted).  The
    single parser behind registration and ``list_fleet_scenarios`` -- the
    two must never disagree on what a builder returns."""
    ann = getattr(fn, "__annotations__", {}).get("return")
    name = ann.split(".")[-1] if isinstance(ann, str) else \
        getattr(ann, "__name__", "")
    return name if name in ("Scenario", "FleetScenario") else ""


def register_scenario(name: str):
    """Decorator: register a scenario builder under ``name``.

    Builders must annotate their return type (``-> Scenario`` or
    ``-> FleetScenario``): ``list_fleet_scenarios`` keys off that
    annotation, not a naming convention, so a fleet builder is routed to
    the fleet harnesses whatever it is called.
    """
    def deco(fn):
        if not _scenario_kind(fn):
            raise ValueError(
                f"scenario builder {fn!r} must annotate its return type as "
                f"Scenario or FleetScenario (got "
                f"{getattr(fn, '__annotations__', {}).get('return')!r}); "
                "the registry dispatches on it")
        fn.scenario_name = name
        SCENARIOS[name] = fn
        return fn
    return deco


def get_scenario(name: str, **kwargs):
    """Build a registered scenario by name.

    Unknown or invalid keyword arguments raise ``ValueError`` naming the
    builder's signature rather than surfacing a bare ``TypeError`` from
    deep inside the builder.
    """
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; have {list_scenarios()}")
    sig = inspect.signature(builder)
    try:
        sig.bind(**kwargs)
    except TypeError as e:
        raise ValueError(
            f"bad arguments for scenario {name!r}: {e}; "
            f"builder signature is {name}{sig}") from None
    return builder(**kwargs)


def list_scenarios():
    return sorted(SCENARIOS)


def list_fleet_scenarios():
    """Names of scenarios whose builders produce a FleetScenario (keyed off
    the builder's return annotation, not the name)."""
    return sorted(n for n, fn in SCENARIOS.items()
                  if _scenario_kind(fn) == "FleetScenario")


# ----------------------------------------------------------- trace builders
#
# Thin eager wrappers over the ``storage/scengen`` trace algebra, kept for
# the public API and the hand-written builders below.


def continuous(t_ticks: int, rate: float, start_tick: int = 0) -> np.ndarray:
    return scengen.constant(rate).shift(start_tick)(t_ticks)


def active_between(t_ticks: int, rate: float, start_tick: int,
                   end_tick: int) -> np.ndarray:
    """A job that arrives at ``start_tick`` and departs at ``end_tick``."""
    return scengen.constant(rate).between(start_tick, end_tick)(t_ticks)


def periodic_bursts(
    t_ticks: int,
    burst_rpcs: float,
    interval_ticks: int,
    burst_ticks: int = 2,
    start_tick: int = 0,
) -> np.ndarray:
    """Short I/O bursts of ``burst_rpcs`` spread over ``burst_ticks`` ticks,
    repeating every ``interval_ticks``."""
    return scengen.bursts(burst_rpcs, interval_ticks, burst_ticks,
                          start_tick)(t_ticks)


# ------------------------------------------------- paper (single-target)


@register_scenario("allocation_ivd")
def scenario_allocation(duration_s: float = 60.0, tick_s: float = 0.01) -> Scenario:
    """Section IV-D: four identical continuous jobs (16 procs x 1 GB each) with
    priorities 10/10/30/50%; higher priority jobs finish earlier, so the active
    set shrinks over time."""
    t = int(duration_s / tick_s)
    nodes = np.array([10, 10, 30, 50], np.float32)
    client_rate = 40.0  # RPCs/tick aggregate per job (4 GB/s NIC-bound)
    issue = np.stack([continuous(t, client_rate) for _ in range(4)], axis=1)
    volume = np.full(4, 16 * GB_RPCS, np.float32)
    backlog = np.full(4, 16 * IN_FLIGHT_PER_PROC, np.float32)
    return Scenario("allocation_ivd", nodes, issue, volume, backlog, duration_s, tick_s)


@register_scenario("redistribution_ive")
def scenario_redistribution(duration_s: float = 60.0, tick_s: float = 0.01) -> Scenario:
    """Section IV-E: three high-priority (30% each) bursty jobs (2 procs x 1 GB)
    with different burst magnitudes/intervals + one low-priority (10%)
    continuous 16-proc job."""
    t = int(duration_s / tick_s)
    nodes = np.array([30, 30, 30, 10], np.float32)
    issue = np.stack(
        [
            periodic_bursts(t, burst_rpcs=300, interval_ticks=500, start_tick=100),
            periodic_bursts(t, burst_rpcs=420, interval_ticks=700, start_tick=250),
            periodic_bursts(t, burst_rpcs=180, interval_ticks=300, start_tick=50),
            continuous(t, rate=40.0),
        ],
        axis=1,
    )
    volume = np.array(
        [2 * GB_RPCS, 2 * GB_RPCS, 2 * GB_RPCS, 64 * GB_RPCS], np.float32
    )
    backlog = np.array([64, 64, 64, 16 * IN_FLIGHT_PER_PROC], np.float32)
    return Scenario(
        "redistribution_ive", nodes, issue, volume, backlog, duration_s, tick_s
    )


@register_scenario("recompensation_ivf")
def scenario_recompensation(duration_s: float = 120.0, tick_s: float = 0.01) -> Scenario:
    """Section IV-F: equal priorities (25% each).  Jobs 1-3: one process does
    small constant-interval bursts; a second process starts continuous I/O
    after 20/50/80 s.  Job 4 is continuous from t=0."""
    t = int(duration_s / tick_s)
    nodes = np.array([25, 25, 25, 25], np.float32)

    def job(delay_s: float, burst: float, interval: int):
        # small bursts at constant (sub-second) intervals: the job is active
        # with low demand nearly every observation window -> it lends tokens
        bursty = periodic_bursts(t, burst_rpcs=burst, interval_ticks=interval,
                                 burst_ticks=1)
        cont = continuous(t, rate=20.0, start_tick=int(delay_s / tick_s))
        return bursty + cont

    issue = np.stack(
        [
            job(20.0, burst=30, interval=10),
            job(50.0, burst=24, interval=12),
            job(80.0, burst=15, interval=15),
            continuous(t, rate=40.0),
        ],
        axis=1,
    )
    # continuous streams run through the whole experiment
    volume = np.full(4, np.inf, np.float32)
    backlog = np.array([32, 32, 32, 16 * IN_FLIGHT_PER_PROC], np.float32)
    return Scenario(
        "recompensation_ivf", nodes, issue, volume, backlog, duration_s, tick_s
    )


# -------------------------------------------------------- fleet scenarios


def _route(name, nodes, issue, volume, backlog, capacity, duration_s, tick_s,
           policy="round_robin", **route_kw) -> FleetScenario:
    n_ost = capacity.shape[0]
    demand = striping.route(policy, issue, volume, backlog, n_ost, **route_kw)
    return FleetScenario(
        name, nodes, demand.issue_rate, demand.volume, demand.max_backlog,
        capacity.astype(np.float32), duration_s, tick_s)


@register_scenario("fleet_noisy_neighbor")
def scenario_fleet_noisy_neighbor(
    duration_s: float = 30.0, tick_s: float = 0.01, n_ost: int = 8
) -> FleetScenario:
    """Noisy neighbor on a few stripes: a single-node job hammers two OSTs
    with small random writes while four wide-striped, well-provisioned jobs
    sweep the whole fleet -- two of them bursty, so static TBF strands their
    idle share.  Only the noisy job's stripe set should feel it; AdapTBF must
    confine it to its 1-node share there *while* its OSTs lend the bursty
    jobs' idle tokens (work conservation)."""
    t = int(duration_s / tick_s)
    #          2 bursty + 2 continuous wide jobs      noisy neighbor
    nodes = np.array([48, 48, 32, 32, 1], np.float32)
    issue = np.stack(
        [
            periodic_bursts(t, burst_rpcs=2400, interval_ticks=300,
                            burst_ticks=60, start_tick=0),
            periodic_bursts(t, burst_rpcs=2400, interval_ticks=300,
                            burst_ticks=60, start_tick=150),
            continuous(t, rate=25.0),
            continuous(t, rate=25.0),
            continuous(t, rate=60.0),   # small random writes, NIC-bound hog
        ],
        axis=1,
    )
    volume = np.full(5, np.inf, np.float32)
    backlog = np.array([16 * IN_FLIGHT_PER_PROC] * 4 + [128], np.float32)
    stripe_count = np.array([n_ost] * 4 + [2], np.int64)
    return _route(
        "fleet_noisy_neighbor", nodes, issue, volume, backlog,
        np.full(n_ost, 20.0), duration_s, tick_s, stripe_count=stripe_count)


@register_scenario("fleet_ost_imbalance")
def scenario_fleet_ost_imbalance(
    duration_s: float = 30.0, tick_s: float = 0.01, n_ost: int = 8
) -> FleetScenario:
    """Heterogeneous targets: half the fleet serves at full rate, half is
    degraded to 40% (failed disk in the RAID, rebalancing, ...).  Six equal
    wide-striped jobs; the decentralized allocator on each slow OST must
    shrink its own budgets with no global coordination."""
    t = int(duration_s / tick_s)
    n_jobs = 6
    nodes = np.full(n_jobs, 16, np.float32)
    issue = np.stack([continuous(t, rate=35.0) for _ in range(n_jobs)], axis=1)
    volume = np.full(n_jobs, np.inf, np.float32)
    backlog = np.full(n_jobs, 16 * IN_FLIGHT_PER_PROC, np.float32)
    capacity = np.where(np.arange(n_ost) < n_ost // 2, 20.0, 8.0)
    return _route(
        "fleet_ost_imbalance", nodes, issue, volume, backlog,
        capacity, duration_s, tick_s)


@register_scenario("fleet_burst_storm")
def scenario_fleet_burst_storm(
    duration_s: float = 30.0, tick_s: float = 0.01, n_ost: int = 8
) -> FleetScenario:
    """Burst storm with staggered phases: five bursty jobs whose burst phases
    are offset so the storm rolls across time, over a continuous low-priority
    background writer.  Stresses redistribution (Section IV-E) at fleet
    scale: every OST sees a different interleaving of the phases."""
    t = int(duration_s / tick_s)
    nodes = np.array([24, 24, 24, 24, 24, 8], np.float32)
    issue = np.stack(
        [
            periodic_bursts(t, burst_rpcs=600, interval_ticks=400, start_tick=0),
            periodic_bursts(t, burst_rpcs=600, interval_ticks=400, start_tick=80),
            periodic_bursts(t, burst_rpcs=600, interval_ticks=400, start_tick=160),
            periodic_bursts(t, burst_rpcs=600, interval_ticks=400, start_tick=240),
            periodic_bursts(t, burst_rpcs=600, interval_ticks=400, start_tick=320),
            continuous(t, rate=50.0),
        ],
        axis=1,
    )
    volume = np.full(6, np.inf, np.float32)
    backlog = np.array([256] * 5 + [16 * IN_FLIGHT_PER_PROC], np.float32)
    # progressive layout: each burst starts as a small file on one OST and
    # widens as it grows
    return _route(
        "fleet_burst_storm", nodes, issue, volume, backlog,
        np.full(n_ost, 20.0), duration_s, tick_s, policy="progressive")


@register_scenario("fleet_churn")
def scenario_fleet_churn(
    duration_s: float = 30.0, tick_s: float = 0.01, n_ost: int = 8
) -> FleetScenario:
    """Arrival/departure churn: jobs enter and leave throughout the run, so
    every OST's active set keeps changing and window-0 cold starts (no rules
    yet) happen repeatedly at fleet scale."""
    t = int(duration_s / tick_s)
    seg = t // 6
    nodes = np.array([20, 20, 30, 30, 10, 10], np.float32)
    issue = np.stack(
        [
            active_between(t, 40.0, 0, 4 * seg),           # departs mid-run
            active_between(t, 40.0, seg, t),               # arrives at 1/6
            active_between(t, 50.0, 2 * seg, 5 * seg),     # mid-run visitor
            continuous(t, rate=30.0),                      # stays throughout
            active_between(t, 60.0, 3 * seg, t),           # late heavy burst
            active_between(t, 25.0, 0, 2 * seg),           # early leaver
        ],
        axis=1,
    )
    volume = np.full(6, np.inf, np.float32)
    backlog = np.full(6, 128.0, np.float32)
    stripe_count = np.array([n_ost, n_ost, 4, n_ost, 4, 2], np.int64)
    return _route(
        "fleet_churn", nodes, issue, volume, backlog,
        np.full(n_ost, 20.0), duration_s, tick_s, stripe_count=stripe_count)


# --------------------------------------------- generated fleet scenarios
#
# Seeded procedural draws from the ``storage/scengen`` profiles, registered
# like any hand-written scenario.  The defaults are the reference's.


def _register_generated(profile: str):
    def builder(seed: int = 0, n_ost: int = 8, n_jobs: int = 8,
                duration_s: float = 20.0,
                tick_s: float = 0.01) -> FleetScenario:
        return scengen.random_fleet(seed, n_ost=n_ost, n_jobs=n_jobs,
                                    profile=profile, duration_s=duration_s,
                                    tick_s=tick_s)
    builder.__name__ = f"scenario_gen_{profile}"
    builder.__qualname__ = builder.__name__
    builder.__doc__ = (f"Generated fleet scenario: seeded draw from the "
                       f"scengen {profile!r} profile.")
    return register_scenario(f"fleet_gen_{profile}")(builder)


for _profile in sorted(scengen.PROFILES):
    _register_generated(_profile)
del _profile
