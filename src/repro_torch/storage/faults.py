"""Fault plans: OST outages, capacity droop, and telemetry loss as
first-class traced inputs to the window engine.

The paper claims AdapTBF "maintains high storage utilization even under
extreme conditions", but every extreme condition the scenario generator
could previously express is demand-side (bursts, churn, noisy neighbors).
Real Lustre fleets lose OSTs (MTBF/MTTR on the order of days/hours), run
targets degraded (a RAID rebuild drops an OST to ~30% throughput for a
stretch), and drop the RPC-carried statistics the controller feeds on.
A ``FaultPlan`` makes all three reproducible, seeded inputs that ride
through ``simulate_fleet`` the same way ``rates`` does (numpy builders here,
moved to the run's device as float32 by the engine).

Representation
--------------
Dense ``[W, O]`` float32 arrays, one row per observation window, one
column per OST (a plan whose arrays are ``[O]`` is a single window's
*fault row* -- ``plan.row(w)`` slices one out):

* ``up``        -- 1.0 while the OST is serving, 0.0 while it is down.
                   A down OST serves nothing and issues nothing: its
                   queue and remaining volumes freeze (volume
                   conservation holds through an outage).
* ``cap_scale`` -- capacity multiplier in (0, 1]: 0.3 means the OST
                   serves at 30% for that window (droop).  Composes with
                   ``up`` multiplicatively.
* ``telem_ok``  -- 1.0 when the window's observation reached the
                   controller, 0.0 when it was lost.  A lost window means
                   the policy's ``step`` sees the *previous* delivered
                   observation (explicit last-observation-hold, DESIGN.md
                   section 11) -- the engine still serves normally; only
                   the control plane is blind.

Every field is row-local: window ``w``'s fault row for OST ``o`` touches
only that OST's state.

An all-ones plan is arithmetically the identity (multiplying by 1.0 and
selecting on an all-true mask are bitwise no-ops in IEEE-754), so a run
with ``no_faults(...)`` matches a run with no plan at all bit for bit.

Builders are host-side numpy and seeded: the same ``(seed, knobs)``
always produces the same plan, so chaos tests and committed benchmark
artifacts can pin fault scenarios exactly like demand scenarios.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class FaultPlan(NamedTuple):
    """Per-window per-OST fault state (see module docstring).

    Arrays are ``[W, O]`` float32 for a plan, ``[O]`` for a single
    window's fault row.  ``simulate_fleet`` takes a plan of numpy arrays
    or tensors.
    """

    up: np.ndarray         # 1.0 = serving, 0.0 = down
    cap_scale: np.ndarray  # capacity multiplier in (0, 1]
    telem_ok: np.ndarray   # 1.0 = observation delivered, 0.0 = lost

    @property
    def n_windows(self) -> int:
        return self.up.shape[0]

    @property
    def n_ost(self) -> int:
        return self.up.shape[-1]

    def row(self, w: int) -> "FaultPlan":
        """Window ``w``'s fault row (arrays ``[O]``), indexed modularly
        so a finite plan tiles an unbounded online horizon the same way
        rate traces tile past their own length."""
        i = int(w) % self.n_windows
        return FaultPlan(up=self.up[i], cap_scale=self.cap_scale[i],
                         telem_ok=self.telem_ok[i])


def plan_pspecs(lead: Optional[str] = None) -> FaultPlan:
    """The layout of a plan over a mesh (``launch/mesh.py``): its ``[W,
    O]`` leaves split by OST column over the ``ost`` axis, every window
    whole, as the reference shards it (``P(None, "ost")``).  Each rank
    reads only its own OSTs' fault rows, so faults add no communication.
    ``lead`` names a leading fleet axis (``[F, W, O]`` batched plans)."""
    front = (lead,) if lead is not None else ()
    return FaultPlan(*((*front, None, "ost"),) * 3)


def no_faults(n_windows: int, n_ost: int) -> FaultPlan:
    """The identity plan: everything up, full capacity, no loss."""
    ones = np.ones((n_windows, n_ost), np.float32)
    return FaultPlan(up=ones, cap_scale=ones.copy(), telem_ok=ones.copy())


def lost_telemetry_row(n_ost: int, base: Optional[FaultPlan] = None
                       ) -> FaultPlan:
    """A single fault row marking this window's observation lost.

    The watchdog substitution for an online loop: when observation
    delivery misses its deadline the loop advances through this row --
    engine healthy, control plane blind -- instead of stalling.  ``base`` (an ``[O]`` fault row) keeps any real
    outage/droop state and only zeroes ``telem_ok``.
    """
    if base is not None:
        zero = np.zeros_like(np.asarray(base.telem_ok))
        return base._replace(telem_ok=zero)
    ones = np.ones((n_ost,), np.float32)
    return FaultPlan(up=ones, cap_scale=ones.copy(),
                     telem_ok=np.zeros((n_ost,), np.float32))


def compose(a: FaultPlan, b: FaultPlan) -> FaultPlan:
    """Overlay two plans: down if either is down, droops multiply, an
    observation is delivered only if both plans delivered it."""
    return FaultPlan(up=a.up * b.up,
                     cap_scale=a.cap_scale * b.cap_scale,
                     telem_ok=a.telem_ok * b.telem_ok)


def outage(n_windows: int, n_ost: int, start: int, end: int,
           osts=None) -> FaultPlan:
    """Deterministic outage: the given OSTs are down for windows
    ``[start, end)``.  ``osts`` is an index list/array (default: all).
    The workhorse for pinned crash-inside-outage oracles."""
    plan = no_faults(n_windows, n_ost)
    idx = np.arange(n_ost) if osts is None else np.asarray(osts, np.int64)
    lo, hi = max(0, int(start)), min(n_windows, int(end))
    plan.up[lo:hi, idx] = 0.0
    return plan


def droop(n_windows: int, n_ost: int, start: int, end: int, scale: float,
          osts=None) -> FaultPlan:
    """Deterministic capacity droop: the given OSTs serve at ``scale``
    (in (0, 1]) for windows ``[start, end)``."""
    plan = no_faults(n_windows, n_ost)
    idx = np.arange(n_ost) if osts is None else np.asarray(osts, np.int64)
    lo, hi = max(0, int(start)), min(n_windows, int(end))
    plan.cap_scale[lo:hi, idx] = np.float32(scale)
    return plan


def degraded_capacity(rng: np.random.Generator, n_ost: int, capacity: float,
                      p_degraded: float = 0.5,
                      scale: float = 0.4) -> np.ndarray:
    """Horizon-constant capacity droop collapsed to a static ``[O]``
    capacity vector: each OST is degraded to ``scale * capacity`` with
    probability ``p_degraded`` (one uniform draw per OST, in OST order).

    This is the droop primitive behind the ``saturation`` scenario
    profile (``scengen._profile_saturation``): a droop that never lifts
    is just a smaller ``capacity_per_tick``, so the profile bakes it into
    the static capacity vector instead of carrying a constant
    ``cap_scale`` trace.  The arithmetic (`np.where` on the float64
    products, one final f32 cast) is the pre-refactor profile's exactly,
    keeping existing seed grids bitwise stable
    (``tests/test_scengen.py::test_saturation_profile_pinned``).
    """
    healthy = rng.random(n_ost) < (1.0 - p_degraded)
    return np.where(healthy, capacity, scale * capacity).astype(np.float32)


def markov_outages(rng: np.random.Generator, n_windows: int, n_ost: int,
                   mtbf_windows: float, mttr_windows: float) -> np.ndarray:
    """``[W, O]`` up/down trace from a two-state Markov chain per OST.

    Geometric sojourns: an up OST fails with p = 1/MTBF per window, a
    down OST recovers with p = 1/MTTR per window (both clamped to [0, 1];
    every OST starts up).  Expected sojourn lengths are therefore MTBF
    up-windows and MTTR down-windows -- the standard memoryless
    fail/repair model.
    """
    p_fail = min(1.0, 1.0 / max(float(mtbf_windows), 1.0))
    p_repair = min(1.0, 1.0 / max(float(mttr_windows), 1.0))
    flip = rng.random((n_windows, n_ost))
    up = np.empty((n_windows, n_ost), np.float32)
    state = np.ones(n_ost, bool)
    for w in range(n_windows):
        state = np.where(state, flip[w] >= p_fail, flip[w] < p_repair)
        up[w] = state
    return up


def random_droop(rng: np.random.Generator, n_windows: int, n_ost: int,
                 droop_frac: float = 0.25,
                 droop_scale: float = 0.3) -> np.ndarray:
    """``[W, O]`` capacity-scale trace: each OST independently suffers
    (with probability ``droop_frac``) one degraded stretch of random
    placement and length, serving at a scale drawn from
    ``[droop_scale, 0.9]`` -- the RAID-rebuild / failing-disk shape."""
    cap_scale = np.ones((n_windows, n_ost), np.float32)
    for o in range(n_ost):
        hit = rng.random() < droop_frac
        start = int(rng.integers(0, max(1, n_windows)))
        length = int(rng.integers(1, max(2, n_windows // 2 + 1)))
        scale = np.float32(rng.uniform(droop_scale,
                                       max(0.9, float(droop_scale))))
        if hit:
            cap_scale[start:start + length, o] = scale
    return cap_scale


def telemetry_loss(rng: np.random.Generator, n_windows: int, n_ost: int,
                   loss_p: float = 0.05) -> np.ndarray:
    """``[W, O]`` delivered-mask: each OST's window observation is lost
    independently with probability ``loss_p`` (RPC-carried stats dropped
    on the wire)."""
    return (rng.random((n_windows, n_ost)) >= loss_p).astype(np.float32)


def random_fault_plan(seed: int, n_windows: int, n_ost: int,
                      mtbf_windows: float = 80.0, mttr_windows: float = 10.0,
                      droop_frac: float = 0.25, droop_scale: float = 0.3,
                      loss_p: float = 0.05) -> FaultPlan:
    """One seeded draw over all three fault axes.

    Deterministic: equal ``(seed, shape, knobs)`` always produce the same
    plan.  The per-axis draws are consumed in a fixed order (outages,
    droop, loss), so tightening one knob never shifts another axis's
    draws for the same seed.
    """
    rng = np.random.default_rng([int(seed), 0x0F_AA_17])
    return FaultPlan(
        up=markov_outages(rng, n_windows, n_ost, mtbf_windows, mttr_windows),
        cap_scale=random_droop(rng, n_windows, n_ost, droop_frac,
                               droop_scale),
        telem_ok=telemetry_loss(rng, n_windows, n_ost, loss_p),
    )
