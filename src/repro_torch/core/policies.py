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

``CodedPolicy`` is the coded combinator: it evaluates every member policy
each window and selects element-wise by ``ctx.control_code`` (the member's
index), so one configuration runs any member of a policy subset.

Each built-in declares a ``device_id``: the case of the window megakernel
(``kernels/csrc/window_mega.cu``) that runs its gate and step on the card.
A custom policy, or a subclass of a built-in that defines anything but
its name and the constants the kernel takes (AIMD's), has no case: it
runs the megakernel's plain version on the CPU only
(``kernels/window_mega/ops.py::megakernel_case``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import adaptbf, baselines
from repro_torch.core.state import AllocatorState, init_fleet_state
from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
from repro_torch.kernels.numerics import row_sum

_EPS = 1e-9


class PolicyContext(NamedTuple):
    """Per-run data every policy method receives.

    nodes:          [O, J] compute nodes per job (priorities).
    cap_w:          [O] window token budget per storage target.
    u_max:          utilization-score cap (adaptbf, DESIGN.md deviation 1).
    integer_tokens: integerize allocations with remainder fairness.
    alloc_backend:  "core" (plain PyTorch) | "pallas" (the allocation
                    kernel, ``kernels/adaptbf_alloc``) for adaptbf rounds.
    control_code:   selects the member of a ``CodedPolicy`` (a host int or a
                    0-d integer tensor; a batch of fleets passes an
                    ``[O, 1]`` int32 column, one code a row); None under
                    direct dispatch.
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
    #: the megakernel's case for this policy (``csrc/window_mega.cu``);
    #: a class that declares its own id runs there, and so does a subclass
    #: that defines nothing but its name and the kernel's inputs
    device_id: Optional[int] = None

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

    device_id = 0

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

    device_id = 1

    def init_alloc(self, ctx):
        return _static_alloc(ctx)   # rules apply from t=0

    def step(self, state, obs, ctx):
        return state, _static_alloc(ctx)


@register_policy("nobw")
class NoBWPolicy(ControlPolicy):
    """No bandwidth control: every job is unruled and the simulator
    arbitrates by backlog share (Lustre default)."""

    device_id = 2

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

    device_id = 3

    def init_alloc(self, ctx):
        return _static_alloc(ctx)   # rules from t=0, like static

    def gate(self, alloc, ctx):
        return _open_zero(alloc)

    def step(self, state, obs, ctx):
        share = _static_alloc(ctx)
        zero = torch.zeros_like(share)
        active = obs.demand > 0
        base = torch.where(active, torch.minimum(share, obs.demand), zero)
        spare = torch.clamp_min(ctx.cap_w[:, None] - row_sum(base), 0.0)
        needy = active & (obs.demand > share)
        weight = torch.where(needy, share, zero)
        extra = spare * weight / torch.clamp_min(row_sum(weight), _EPS)
        alloc = torch.where(active, base + extra, zero)
        if ctx.integer_tokens:
            alloc = torch.floor(alloc)
        return state, alloc


@register_policy("aimd")
class AIMDPolicy(ControlPolicy):
    """Feedback throttler: priority-weighted rate rules exist only while the
    server is saturated (served ~ capacity), and the carried per-job rates
    evolve by additive increase / multiplicative decrease."""

    device_id = 4

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
        p = ctx.nodes / torch.clamp_min(row_sum(ctx.nodes), _EPS)
        served_tot = row_sum(obs.served)
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


# ------------------------------------------------------- coded combinator


def _where(cond, a, b):
    """``torch.where`` for a tensor condition; a plain pick for a host bool
    (a host control code), which selects the same values.  A per-row
    ``[O, 1]`` condition is shaped to ``a``'s rank first, so it selects
    whole rows of an ``[O]`` or ``[O, ...]`` leaf too (an ``[O]`` leaf
    against ``[O, 1]`` would otherwise broadcast to ``[O, O]``)."""
    if isinstance(cond, torch.Tensor):
        if cond.ndim == 2 and a.ndim != 2:
            cond = cond.reshape(cond.shape[0], *(1,) * (a.ndim - 1))
        return torch.where(cond, a, b)
    return a if cond else b


def _tree_map2(fn, a, b):
    """``fn`` over the paired leaves of two policy states of one structure
    (tensors inside tuples and named tuples)."""
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    mapped = [_tree_map2(fn, x, y) for x, y in zip(a, b)]
    return type(a)(*mapped) if hasattr(a, "_fields") else type(a)(mapped)


def select_by_code(code, values: Sequence[torch.Tensor]):
    """Element-wise select ``values[code]`` by a where-chain: a code outside
    ``[0, len(values))`` selects the last value."""
    out = values[-1]
    for i in range(len(values) - 2, -1, -1):
        out = _where(code == i, values[i], out)
    return out


def control_codes(policies: Sequence[str]) -> Dict[str, int]:
    """Name -> code mapping for a coded-policy subset (code = index)."""
    return {name: i for i, name in enumerate(policies)}


class CodedPolicy(ControlPolicy):
    """Coded combinator over any registered policy subset.

    Every member's round is computed each window and the result selected
    element-wise by ``ctx.control_code`` (the member's index).  The combined
    state is the tuple of member states; only the selected member's state
    advances."""

    name = "coded"

    def __init__(self, policies: Sequence[str]):
        self.names = tuple(policies)
        if not self.names:
            raise ValueError("coded dispatch needs >= 1 member policy")
        self.members = tuple(get_policy(n) for n in self.names)

    def init_state(self, ctx):
        return tuple(m.init_state(ctx) for m in self.members)

    def init_alloc(self, ctx):
        return select_by_code(
            ctx.control_code, [m.init_alloc(ctx) for m in self.members])

    def gate(self, alloc, ctx):
        return select_by_code(
            ctx.control_code, [m.gate(alloc, ctx) for m in self.members])

    def step(self, state, obs, ctx):
        outs = [m.step(s, obs, ctx) for m, s in zip(self.members, state)]
        new_state = []
        for i, (nxt, old) in enumerate(zip((o[0] for o in outs), state)):
            is_i = ctx.control_code == i
            new_state.append(_tree_map2(
                lambda a, b, sel=is_i: _where(sel, a, b), nxt, old))
        alloc = select_by_code(ctx.control_code, [o[1] for o in outs])
        return tuple(new_state), alloc

    def record(self, state, ctx):
        return select_by_code(
            ctx.control_code,
            [m.record(s, ctx) for m, s in zip(self.members, state)])
