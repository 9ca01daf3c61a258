"""Pluggable control policies for the windowed storage engine.

A ``ControlPolicy`` is the control discipline the engine consults once per
observation window: how the first window is gated before any demand has
been observed (``init_alloc``), how the previous window's allocation becomes
a token budget (``gate``), and how the next allocation is computed from what
the window revealed (``step``).  All methods take ``[O, J]`` tensors -- one
row per storage target, one column per job -- and no method mixes rows:
that is the paper's decentralization.  The single-target simulator is the
``O = 1`` view of the same engine.

Under a fault plan the engine hands policies an *effective* ``ctx.cap_w``
(zero while an OST is down, scaled under droop) and a ``WindowObs.up``
liveness column; every policy returns finite, non-negative-or-inf
allocations for any ``cap_w >= 0``.

Policies are registered by name::

    @register_policy("my_policy")
    class MyPolicy(ControlPolicy):
        def init_alloc(self, ctx): ...
        def step(self, state, obs, ctx): ...

Built-in policies:

* ``adaptbf``   -- the paper's adaptive token borrowing allocator
                   (``ctx.alloc_backend``: "core" runs the plain PyTorch
                   allocator, "pallas" the hand-written allocation kernel).
* ``static``    -- static TBF rules sized by global priority share.
* ``nobw``      -- no rules at all (backlog-proportional FCFS fallback).
* ``static_wc`` -- work-conserving static TBF: each window's unused share
                   is re-granted to backlogged jobs by priority.
* ``aimd``      -- additive-increase / multiplicative-decrease throttler
                   driven by server-side saturation.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import adaptbf, baselines
from repro_torch.core.state import AllocatorState, init_fleet_state
from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops

_EPS = 1e-9


class PolicyContext(NamedTuple):
    """Per-run data every policy method receives.

    nodes:          [O, J] compute nodes per job (priorities).
    cap_w:          [O] window token budget per storage target.
    u_max:          utilization-score cap (adaptbf, DESIGN.md deviation 1).
    integer_tokens: integerize allocations with remainder fairness.
    alloc_backend:  "core" (plain PyTorch) | "pallas" (the allocation
                    kernel, ``kernels/adaptbf_alloc``) for adaptbf rounds.
    control_code:   selects the member of a coded policy; None under direct
                    dispatch (coded dispatch is not ported yet).
    """

    nodes: torch.Tensor
    cap_w: torch.Tensor
    u_max: float = 64.0
    integer_tokens: bool = True
    alloc_backend: str = "core"
    control_code: Optional[torch.Tensor] = None


class WindowObs(NamedTuple):
    """What one observation window revealed, per target per job ([O, J]).

    served: RPCs served during the window.
    demand: the allocator's demand signal d_x (served + standing queue).
    alloc:  the allocation that was *applied* this window.
    up:     optional [O, 1] liveness column (1.0 serving, 0.0 down); None
            outside fault-injected runs.
    """

    served: torch.Tensor
    demand: torch.Tensor
    alloc: torch.Tensor
    up: Optional[torch.Tensor] = None


class ControlPolicy:
    """Base control discipline.  Subclass and register with
    ``@register_policy(name)``; override ``init_alloc`` and ``step`` at
    minimum.  All tensors are [O, J]; no method may mix rows."""

    name: str = "?"

    def init_state(self, ctx: PolicyContext) -> Any:
        """Policy state carried across windows (default: none)."""
        return ()

    def init_alloc(self, ctx: PolicyContext) -> torch.Tensor:
        """Window-0 allocation, before any demand has been observed.
        ``inf`` means "no rule": the job is served from the fallback queue."""
        raise NotImplementedError

    def gate(self, alloc: torch.Tensor, ctx: PolicyContext) -> torch.Tensor:
        """Window-start token budget from the last allocation (default: the
        allocation itself; 0 = ruled shut, inf = unruled)."""
        return alloc

    def step(self, state: Any, obs: WindowObs,
             ctx: PolicyContext) -> Tuple[Any, torch.Tensor]:
        """One control round: (state, obs) -> (new state, next allocation)."""
        raise NotImplementedError

    def record(self, state: Any, ctx: PolicyContext) -> torch.Tensor:
        """Reportable per-job [O, J] state (the lend/borrow record for
        adaptbf; zeros for stateless policies)."""
        return torch.zeros_like(ctx.nodes)


# ----------------------------------------------------------------- registry


POLICIES: Dict[str, ControlPolicy] = {}


def register_policy(name: str, *, override: bool = False):
    """Class decorator: register a ControlPolicy subclass under ``name``.
    Duplicate names raise; pass ``override=True`` to replace deliberately."""
    def deco(cls):
        if name in POLICIES and not override:
            raise ValueError(
                f"control policy {name!r} is already registered "
                f"(to {type(POLICIES[name]).__name__}); pass override=True "
                "to replace it")
        cls.name = name
        POLICIES[name] = cls()
        return cls
    return deco


def get_policy(name: str) -> ControlPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown control policy {name!r}; registered: {list_policies()}")


def list_policies():
    return sorted(POLICIES)


def _unruled(ctx: PolicyContext) -> torch.Tensor:
    return torch.full_like(ctx.nodes, torch.inf)


def _static_alloc(ctx: PolicyContext) -> torch.Tensor:
    """[O, J] static TBF rates: every target divides its own budget by the
    *global* priority share."""
    return baselines.static_allocate(ctx.nodes, ctx.cap_w)


def _open_zero(alloc: torch.Tensor) -> torch.Tensor:
    """A zero allocation means the job's rule is *stopped* -> fallback."""
    return torch.where(alloc > 0, alloc, torch.full_like(alloc, torch.inf))


# ----------------------------------------------------------- built-in set


@register_policy("adaptbf")
class AdapTBFPolicy(ControlPolicy):
    """The paper's decentralized adaptive token borrowing allocator."""

    def init_state(self, ctx):
        n_ost, n_jobs = ctx.nodes.shape
        return init_fleet_state(n_ost, n_jobs, device=ctx.nodes.device)

    def init_alloc(self, ctx):
        # window 0: no demand observed yet -> no rules exist -> fallback
        return _unruled(ctx)

    def gate(self, alloc, ctx):
        return _open_zero(alloc)

    def step(self, state, obs, ctx):
        if ctx.alloc_backend == "core":
            state, alloc = adaptbf.fleet_allocate(
                state, obs.demand, ctx.nodes, ctx.cap_w,
                u_max=ctx.u_max, integer_tokens=ctx.integer_tokens)
            return self._reclaim(state, obs), alloc
        if ctx.alloc_backend == "pallas":
            if not ctx.integer_tokens:
                raise ValueError(
                    'alloc_backend="pallas" supports integer tokens only; '
                    'use the "core" backend for float-token budgets')
            alloc, rec, rem = alloc_ops.fleet_alloc(
                obs.demand, ctx.nodes, state.record, state.remainder,
                state.alloc_prev, ctx.cap_w, u_max=ctx.u_max)
            state = AllocatorState(record=rec, remainder=rem,
                                   alloc_prev=alloc)
            return self._reclaim(state, obs), alloc
        raise ValueError(f"unknown alloc_backend: {ctx.alloc_backend!r}")

    @staticmethod
    def _reclaim(state, obs):
        """Lender-side ledger reclaim for dead OSTs: while an OST is down its
        lend/borrow record is pinned to zero (row-locally), so borrowing
        resumes from a clean ledger when it comes back.  ``where`` (not
        ``record * up``) so negative entries cannot leave ``-0.0`` behind."""
        if obs.up is None:
            return state
        return state._replace(record=torch.where(
            obs.up > 0, state.record, torch.zeros_like(state.record)))

    def record(self, state, ctx):
        return state.record


@register_policy("static")
class StaticPolicy(ControlPolicy):
    """Static TBF: fixed rules sized by each job's share of the total
    system, never stopped, never adapted (paper Section IV-C)."""

    def init_alloc(self, ctx):
        return _static_alloc(ctx)   # rules apply from t=0

    def step(self, state, obs, ctx):
        return state, _static_alloc(ctx)


@register_policy("nobw")
class NoBWPolicy(ControlPolicy):
    """No bandwidth control: every job is unruled and the simulator
    arbitrates by backlog share (Lustre default)."""

    def init_alloc(self, ctx):
        return _unruled(ctx)

    def step(self, state, obs, ctx):
        return state, _unruled(ctx)


@register_policy("static_wc")
class StaticWorkConservingPolicy(ControlPolicy):
    """Work-conserving static TBF: rates stay anchored to the static
    priority shares, but each window's *unused* share is re-granted to
    backlogged jobs, weighted by the same shares.  No lend/borrow records:
    the ablation between ``static`` and ``adaptbf``."""

    def init_alloc(self, ctx):
        return _static_alloc(ctx)   # rules from t=0, like static

    def gate(self, alloc, ctx):
        return _open_zero(alloc)

    def step(self, state, obs, ctx):
        share = _static_alloc(ctx)
        zero = torch.zeros_like(share)
        active = obs.demand > 0
        base = torch.where(active, torch.minimum(share, obs.demand), zero)
        spare = torch.clamp_min(
            ctx.cap_w[:, None] - base.sum(dim=-1, keepdim=True), 0.0)
        needy = active & (obs.demand > share)
        weight = torch.where(needy, share, zero)
        extra = spare * weight / torch.clamp_min(
            weight.sum(dim=-1, keepdim=True), _EPS)
        alloc = torch.where(active, base + extra, zero)
        if ctx.integer_tokens:
            alloc = torch.floor(alloc)
        return state, alloc


@register_policy("aimd")
class AIMDPolicy(ControlPolicy):
    """Feedback throttler: priority-weighted rate rules exist only while the
    server is saturated (served ~ capacity), and the carried per-job rates
    evolve by additive increase / multiplicative decrease."""

    ai_frac: float = 0.08     # additive increase per window, x cap_w x share
    md: float = 0.7           # multiplicative decrease on saturation
    sat: float = 0.95         # served/capacity ratio that signals congestion
    floor: float = 1.0        # tokens/window a job can always keep

    def init_state(self, ctx):
        return _static_alloc(ctx)   # carried per-job rates, [O, J]

    def init_alloc(self, ctx):
        return _unruled(ctx)

    def gate(self, alloc, ctx):
        return _open_zero(alloc)

    def step(self, rate, obs, ctx):
        p = ctx.nodes / torch.clamp_min(
            ctx.nodes.sum(dim=-1, keepdim=True), _EPS)
        served_tot = obs.served.sum(dim=-1, keepdim=True)
        cap_col = ctx.cap_w[:, None]
        # a zeroed capacity (down OST) reads as "nothing to throttle"
        congested = (served_tot >= self.sat * cap_col) & (cap_col > 0.0)
        # decrease only jobs whose own rule was binding in a congested window
        gated = torch.isfinite(obs.alloc) & (obs.alloc > 0)
        binding = gated & (obs.served >= self.sat * obs.alloc)
        rate = torch.where(
            congested & binding, rate * self.md,
            torch.where(congested, rate, rate + self.ai_frac * cap_col * p))
        # ceiling floored at the floor: with cap_w = 0 the rates freeze
        rate = torch.minimum(torch.clamp_min(rate, self.floor),
                             torch.clamp_min(cap_col, self.floor))
        throttled = torch.where(obs.demand > 0, rate, torch.zeros_like(rate))
        if ctx.integer_tokens:
            throttled = torch.floor(throttled)
        alloc = torch.where(congested, throttled,
                            torch.full_like(throttled, torch.inf))
        return rate, alloc
