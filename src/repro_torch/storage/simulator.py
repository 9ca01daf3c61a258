"""Discrete-time storage simulator on PyTorch: the fleet window engine.

Model (the reference package's, unchanged):

* time advances in ticks (default 10 ms); an observation window is
  ``window_ticks`` ticks (default 10 -> 100 ms).
* 1 token = 1 RPC = 1 MB bulk I/O.
* each job issues RPCs into its server-side queue according to a rate trace,
  bounded by its remaining volume and a client-side backlog cap.
* each OST serves at most ``capacity_per_tick`` RPCs per tick in two phases
  (Lustre NRS TBF): *ruled* jobs (finite token budget) dequeue up to their
  remaining budget, scaled to capacity when gated wants exceed it; *unruled*
  jobs (infinite budget) are served from whatever capacity phase 1 left.
* a pluggable ``ControlPolicy`` (``core/policies.py``) gates each window and
  computes the next allocation from the window's observation: RPCs served
  plus the standing queue at window end.

ONE window engine (``_run_windows``) drives both entry points:
``simulate_fleet`` on ``[O, J]`` rows and ``simulate``, its O=1 view.  Every
per-window op is row-local, so each OST runs its policy independently (the
paper's decentralization).  The ``vmap`` of the reference is the leading
``[O]`` axis here, and its ``lax.scan`` over windows a Python loop writing
into preallocated ``[n_windows, O, J]`` trajectories.

``serve_backend="fused"`` serves each window with one launch of the CUDA
kernel ``kernels/csrc/fleet_window.cu``; ``alloc_backend="pallas"`` runs each
allocation round with one launch of ``kernels/csrc/adaptbf_alloc.cu``.  The
default "scan"/"core" pair runs the plain PyTorch versions on any device.

Entry points run on the card: ``device=None`` means CUDA and raises when no
GPU is present; pass ``device="cpu"`` to run the plain versions on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.policies import (
    ControlPolicy,
    PolicyContext,
    WindowObs,
    get_policy,
)
from repro_torch.core.state import AllocatorState
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.numerics import row_sum
from repro_torch.storage.faults import FaultPlan

_EPS = 1e-9

#: default member subset of a coded policy (field kept so one FleetConfig
#: reads the same in both packages; coded dispatch is not ported yet)
DEFAULT_CODED_POLICIES = ("adaptbf", "static", "nobw")


_MEGA_ITEM = 'queue A, "B3 window_mega and coded dispatch"'


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md, {item})")


class SimConfig(NamedTuple):
    capacity_per_tick: float = 20.0    # RPCs/tick the OST can serve
    window_ticks: int = 10             # observation window length in ticks
    tick_seconds: float = 0.01
    control: str = "adaptbf"           # any registered policy name
    u_max: float = 64.0
    integer_tokens: bool = True
    max_backlog: float = 256.0         # default client in-flight cap per job
    telemetry: str = "trajectory"      # trajectory (streaming: not ported)


class FleetConfig(NamedTuple):
    """Configuration for ``simulate_fleet``; the reference's fields and
    strings, so one config reads the same in both packages."""

    capacity_per_tick: float = 20.0    # default per-OST capacity (RPCs/tick)
    window_ticks: int = 10
    tick_seconds: float = 0.01
    control: str = "adaptbf"           # any registered policy name
    u_max: float = 64.0
    integer_tokens: bool = True
    max_backlog: float = 256.0
    alloc_backend: str = "core"        # core (plain PyTorch) | pallas (the
                                       #   CUDA allocation kernel)
    serve_backend: str = "scan"        # scan (plain per-tick loop) | fused
                                       #   (the CUDA window kernel, one
                                       #   launch per window) | mega (not
                                       #   ported)
    telemetry: str = "trajectory"      # trajectory (streaming: not ported)
    coded_policies: tuple = DEFAULT_CODED_POLICIES
    partition: str = "none"            # none (ost_shard: not ported)


class SimResult(NamedTuple):
    served: torch.Tensor       # [n_windows, J] RPCs served per window per job
    demand: torch.Tensor       # [n_windows, J] observed demand per window
    alloc: torch.Tensor        # [n_windows, J] token budget applied
    record: torch.Tensor       # [n_windows, J] policy record after window
    queue_final: torch.Tensor  # [J]
    window_seconds: float

    @property
    def throughput_mb_s(self):
        """[n_windows, J] MB/s assuming 1 RPC = 1 MB."""
        return self.served / self.window_seconds


class FleetResult(NamedTuple):
    served: torch.Tensor       # [n_windows, O, J]
    demand: torch.Tensor       # [n_windows, O, J]
    alloc: torch.Tensor        # [n_windows, O, J]
    record: torch.Tensor       # [n_windows, O, J]
    queue_final: torch.Tensor  # [O, J]
    window_seconds: float

    @property
    def throughput_mb_s(self):
        """[n_windows, O, J] MB/s assuming 1 RPC = 1 MB."""
        return self.served / self.window_seconds

    def per_ost(self, i: int) -> SimResult:
        """View of one OST's trajectory as a single-target result."""
        return SimResult(
            served=self.served[:, i], demand=self.demand[:, i],
            alloc=self.alloc[:, i], record=self.record[:, i],
            queue_final=self.queue_final[i],
            window_seconds=self.window_seconds,
        )


# --------------------------------------------------------- shared machinery


def _serve_tick(queue, vol_left, budget, rate_t, backlog_cap, capacity):
    """One tick of two-phase NRS-TBF service: client issuance into the
    server-side queue, then token-gated service and opportunistic fallback.

    Jobs live on the LAST axis and ``capacity`` broadcasts against
    ``[..., 1]``; no op mixes rows."""
    headroom = torch.clamp_min(backlog_cap - queue, 0.0)
    issued = torch.minimum(torch.minimum(rate_t, vol_left), headroom)
    queue = queue + issued
    vol_left = vol_left - issued
    queue = torch.clamp_min(queue, 0.0)  # fp guard
    ruled = torch.isfinite(budget)
    # phase 1: token-gated service for ruled jobs
    want1 = torch.where(ruled, torch.minimum(queue, torch.clamp_min(budget, 0.0)),
                        0.0)
    s1 = want1 * torch.clamp_max(capacity / torch.clamp_min(
        row_sum(want1), _EPS), 1.0)
    # phase 2: fallback queue served from idle capacity only
    spare = torch.clamp_min(capacity - row_sum(s1), 0.0)
    want2 = torch.where(ruled, 0.0, queue)
    s2 = want2 * torch.clamp_max(spare / torch.clamp_min(
        row_sum(want2), _EPS), 1.0)
    # proportional scaling can overshoot the queue by an ulp; clamping keeps
    # cumulative served <= cumulative issued over long horizons
    served = torch.minimum(s1 + s2, queue)
    queue = queue - served
    budget = budget - served  # inf stays inf for unruled jobs
    return queue, vol_left, budget, served, issued


# ------------------------------------------------------- the window engine


class HeldObs(NamedTuple):
    """The last observation the controller actually received ([O, J]): fed
    to the policy's ``step`` while a fault plan marks telemetry lost."""

    served: torch.Tensor
    demand: torch.Tensor
    alloc: torch.Tensor


class WindowCarry(NamedTuple):
    """The complete cross-window state of the window engine.  Field names
    follow the reference's checkpoint paths (``.queue``,
    ``.policy_state.record``, ...; see ``carry_from_numpy``)."""

    window: int                # windows completed so far
    queue: torch.Tensor        # [O, J] standing server-side queues
    vol_left: torch.Tensor     # [O, J] remaining volume per job per target
    policy_state: Any          # policy state (shape fixed by cfg.control)
    alloc: torch.Tensor        # [O, J] allocation applied next window
    stats: Any                 # () (trajectory telemetry)
    held: HeldObs              # last *delivered* observation


class WindowOut(NamedTuple):
    """One window's trajectory-mode observation ([O, J] each)."""

    served: torch.Tensor
    demand: torch.Tensor
    alloc: torch.Tensor
    record: torch.Tensor


def _check_config(cfg: FleetConfig) -> None:
    """Reject options this package does not run, before any work."""
    if cfg.telemetry == "streaming":
        raise _not_ported('telemetry="streaming"',
                          'queue A, "Streaming telemetry"')
    if cfg.telemetry != "trajectory":
        raise ValueError(f"unknown telemetry mode: {cfg.telemetry!r}")
    if cfg.serve_backend == "mega":
        raise _not_ported('serve_backend="mega"', _MEGA_ITEM)
    if cfg.serve_backend not in ("scan", "fused"):
        raise ValueError(f"unknown serve_backend: {cfg.serve_backend!r}")
    if cfg.partition == "ost_shard":
        raise _not_ported('partition="ost_shard"', 'queue A, "Sharding"')
    if cfg.partition != "none":
        raise ValueError(f"unknown partition: {cfg.partition!r}")
    if cfg.control == "coded":
        raise _not_ported('control="coded"', _MEGA_ITEM)


def init_carry(cfg: FleetConfig, policy: ControlPolicy, ctx: PolicyContext,
               volume: torch.Tensor) -> WindowCarry:
    """Window-0 carry: empty queues, full volumes, the policy's cold-start
    state and allocation."""
    _check_config(cfg)

    def zoj():
        return torch.zeros_like(ctx.nodes)

    return WindowCarry(
        window=0, queue=zoj(), vol_left=volume,
        policy_state=policy.init_state(ctx), alloc=policy.init_alloc(ctx),
        stats=(),
        held=HeldObs(served=zoj(), demand=zoj(),
                     alloc=policy.init_alloc(ctx)))


def _serve_window(cfg: FleetConfig, queue, vol_left, budget0, rates_w,
                  backlog_cap, cap_tick):
    """All ticks of one window -> (queue, vol_left, served_window)."""
    from repro_torch.kernels.fleet_window import ops as window_ops
    if cfg.serve_backend == "fused":
        return window_ops.fleet_window_serve(
            queue, vol_left, budget0, rates_w, backlog_cap, cap_tick)
    if cfg.serve_backend == "scan":
        return window_ops.fleet_window_ref(
            queue, vol_left, budget0, rates_w, backlog_cap, cap_tick)
    raise ValueError(f"unknown serve_backend: {cfg.serve_backend!r}")


def window_step(cfg: FleetConfig, policy: ControlPolicy, ctx: PolicyContext,
                cap_tick, backlog_cap, carry: WindowCarry, rates_w,
                faults_w: Optional[FaultPlan] = None):
    """One observation window: gate, serve every tick, observe, re-allocate.

    Args:
      cfg/policy/ctx: configuration, control discipline, per-run context
        (``ctx.cap_w`` must equal ``cap_tick * cfg.window_ticks``).
      cap_tick: [O] per-target service rate; backlog_cap: [O, J].
      carry: the ``WindowCarry`` from the previous window (or
        ``init_carry``).
      rates_w: [window_ticks, O, J] this window's client issue attempts.
      faults_w: optional ``FaultPlan`` row ([O] tensors): a down OST
        (``up == 0``) serves and issues nothing; ``cap_scale`` scales its
        service rate; on a lost-telemetry window (``telem_ok == 0``) the
        policy's ``step`` sees the last delivered observation
        (``carry.held``) while the engine serves normally.

    Returns ``(carry', out)`` with ``out`` a ``WindowOut``.
    """
    if faults_w is None:
        ctx_w, cap_tick_w, up_col = ctx, cap_tick, None
    else:
        # with an all-ones row every op below is an IEEE identity
        cap_tick_w = cap_tick * faults_w.up * faults_w.cap_scale
        rates_w = rates_w * faults_w.up[None, :, None]
        ctx_w = ctx._replace(cap_w=cap_tick_w * cfg.window_ticks)
        up_col = faults_w.up[:, None]
    budget0 = policy.gate(carry.alloc, ctx_w)
    queue, vol_left, served_w = _serve_window(
        cfg, carry.queue, carry.vol_left, budget0, rates_w, backlog_cap,
        cap_tick_w)
    demand = served_w + queue
    if faults_w is None:
        obs_served, obs_demand, obs_alloc = served_w, demand, carry.alloc
    else:
        delivered = faults_w.telem_ok[:, None] > 0
        obs_served = torch.where(delivered, served_w, carry.held.served)
        obs_demand = torch.where(delivered, demand, carry.held.demand)
        obs_alloc = torch.where(delivered, carry.alloc, carry.held.alloc)
    pstate, alloc_next = policy.step(
        carry.policy_state,
        WindowObs(served=obs_served, demand=obs_demand, alloc=obs_alloc,
                  up=up_col), ctx_w)
    out = WindowOut(served=served_w, demand=demand, alloc=carry.alloc,
                    record=policy.record(pstate, ctx_w))
    return WindowCarry(window=carry.window + 1, queue=queue,
                       vol_left=vol_left, policy_state=pstate,
                       alloc=alloc_next, stats=carry.stats,
                       held=HeldObs(served=obs_served, demand=obs_demand,
                                    alloc=obs_alloc)), out


def _run_windows(cfg: FleetConfig, policy: ControlPolicy, nodes, rates,
                 volume, cap_tick, backlog_cap, n_windows: Optional[int],
                 fault_plan: Optional[FaultPlan] = None):
    """The single window loop behind both entry points.

    nodes/volume/backlog_cap: [O, J]; rates: [T, O, J]; cap_tick: [O], all
    float32 on one device.  ``n_windows`` extends (or trims) the horizon by
    indexing the trace periodically; None runs exactly the windows the trace
    covers.  ``fault_plan`` ([n_windows, O] leaves) covers the *run* horizon,
    one row per executed window, and is never tiled.

    Returns ``(queue_final, outs)`` with ``outs`` a ``WindowOut`` of
    preallocated ``[n_windows, O, J]`` trajectories.
    """
    t_total, n_ost, n_jobs = rates.shape
    trace_windows = t_total // cfg.window_ticks
    if trace_windows == 0:
        raise ValueError(
            f"trace covers {t_total} ticks < one {cfg.window_ticks}-tick window")
    if n_windows is None:
        n_windows = trace_windows
    if fault_plan is not None:
        fault_plan = FaultPlan(*(_f32(x, rates.device) for x in fault_plan))
        for name, leaf in zip(FaultPlan._fields, fault_plan):
            if tuple(leaf.shape) != (n_windows, n_ost):
                raise ValueError(
                    f"fault_plan.{name} must be [n_windows={n_windows}, "
                    f"n_ost={n_ost}]; got {tuple(leaf.shape)} (the plan "
                    "covers the run horizon, one row per executed window)")
    trace = rates[: trace_windows * cfg.window_ticks].reshape(
        trace_windows, cfg.window_ticks, n_ost, n_jobs)
    ctx = PolicyContext(
        nodes=nodes, cap_w=cap_tick * cfg.window_ticks, u_max=cfg.u_max,
        integer_tokens=cfg.integer_tokens, alloc_backend=cfg.alloc_backend)

    carry = init_carry(cfg, policy, ctx, volume)
    outs = WindowOut(*(rates.new_empty((n_windows, n_ost, n_jobs))
                       for _ in WindowOut._fields))
    for w in range(n_windows):
        faults_w = (None if fault_plan is None
                    else FaultPlan(*(leaf[w] for leaf in fault_plan)))
        carry, out = window_step(cfg, policy, ctx, cap_tick, backlog_cap,
                                 carry, trace[w % trace_windows],
                                 faults_w=faults_w)
        for dst, src in zip(outs, out):
            dst[w] = src
    return carry.queue, outs


def _f32(x, device: torch.device) -> torch.Tensor:
    """Numpy or torch input -> contiguous float32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def _resolve_policy(cfg, control_code) -> ControlPolicy:
    if control_code is not None:
        raise _not_ported("control_code (coded dispatch)", _MEGA_ITEM)
    _check_config(cfg)
    return get_policy(cfg.control)


# ------------------------------------------------------------ single target


def simulate(cfg: SimConfig, nodes, issue_rate, volume, max_backlog=None,
             n_windows: Optional[int] = None, *, device=None) -> SimResult:
    """Simulate one storage target: the O=1 view of the fleet engine.

    Args:
      cfg: SimConfig.
      nodes: [J] compute nodes per job (priorities derive from these).
      issue_rate: [T, J] client issue attempts (RPCs per tick).
      volume: [J] total RPCs each job will ever issue (inf = unbounded).
      max_backlog: optional [J] per-job client in-flight cap (defaults to
        cfg.max_backlog for every job).
      n_windows: optional horizon override; the rate trace is indexed
        periodically beyond its own length.
      device: None (CUDA; raises without a GPU) or "cpu".
    """
    dev = resolve_device(device)
    # SimConfig's field names are a strict subset of FleetConfig's
    fcfg = FleetConfig(**cfg._asdict())
    policy = _resolve_policy(fcfg, None)
    rates = _f32(issue_rate, dev)
    n_jobs = rates.shape[1]
    if max_backlog is None:
        backlog_cap = torch.full((1, n_jobs), cfg.max_backlog,
                                 dtype=torch.float32, device=dev)
    else:
        backlog_cap = _f32(max_backlog, dev).reshape(1, n_jobs)
    queue, outs = _run_windows(
        fcfg, policy, _f32(nodes, dev).reshape(1, n_jobs),
        rates[:, None, :].contiguous(), _f32(volume, dev).reshape(1, n_jobs),
        torch.full((1,), cfg.capacity_per_tick, dtype=torch.float32,
                   device=dev),
        backlog_cap, n_windows)
    served, demand, alloc, record = (x[:, 0] for x in outs)
    return SimResult(served=served, demand=demand, alloc=alloc,
                     record=record, queue_final=queue[0],
                     window_seconds=cfg.window_ticks * cfg.tick_seconds)


# -------------------------------------------------------------------- fleet


def simulate_fleet(cfg: FleetConfig, nodes, issue_rate, volume,
                   capacity_per_tick=None, max_backlog=None,
                   control_code=None, n_windows: Optional[int] = None,
                   fault_plan: Optional[FaultPlan] = None, *,
                   device=None) -> FleetResult:
    """Simulate ``n_ost`` storage targets with striped client demand.

    Args:
      cfg: FleetConfig.  ``cfg.control`` names a registered policy.
      nodes: [J] or [O, J] compute nodes per job.
      issue_rate: [T, O, J] per-target client issue attempts (RPCs/tick).
      volume: [O, J] total RPCs per job per target (inf = unbounded).
      capacity_per_tick: optional [O] per-OST service rates (default
        cfg.capacity_per_tick everywhere).
      max_backlog: optional [O, J] per-target client in-flight caps.
      control_code: coded dispatch; not ported (must be None).
      n_windows: optional horizon override; the rate trace is indexed
        periodically beyond its own length.
      fault_plan: optional ``FaultPlan`` ([n_windows, O] leaves, one row per
        executed window): outages freeze queues and volumes, droop scales
        service, lost-telemetry windows hold the controller's previous
        observation.
      device: None (CUDA; raises without a GPU) or "cpu".  Inputs move to
        it as float32 before any arithmetic.

    Returns:
      FleetResult with [n_windows, O, J] trajectories on ``device``.
    """
    dev = resolve_device(device)
    policy = _resolve_policy(cfg, control_code)
    rates = _f32(issue_rate, dev)
    _t, n_ost, n_jobs = rates.shape
    nodes = _f32(nodes, dev)
    if nodes.ndim == 1:
        nodes = nodes.expand(n_ost, n_jobs).contiguous()
    if capacity_per_tick is None:
        cap_tick = torch.full((n_ost,), cfg.capacity_per_tick,
                              dtype=torch.float32, device=dev)
    else:
        cap_tick = _f32(capacity_per_tick, dev)
    if max_backlog is None:
        backlog_cap = torch.full((n_ost, n_jobs), cfg.max_backlog,
                                 dtype=torch.float32, device=dev)
    else:
        backlog_cap = _f32(max_backlog, dev)
    queue, outs = _run_windows(cfg, policy, nodes, rates, _f32(volume, dev),
                               cap_tick, backlog_cap, n_windows,
                               fault_plan=fault_plan)
    return FleetResult(*outs, queue_final=queue,
                       window_seconds=cfg.window_ticks * cfg.tick_seconds)


# ------------------------------------------------------- carrying state over

#: carry leaves by the reference's pytree path strings (the checkpoint
#: format's keys), in the reference's flattening order
_CARRY_ARRAYS = (".queue", ".vol_left")
_HELD = tuple(f".held.{f}" for f in HeldObs._fields)
_STATE = tuple(f".policy_state.{f}" for f in AllocatorState._fields)


def carry_to_numpy(carry: WindowCarry) -> Dict[str, np.ndarray]:
    """A ``WindowCarry`` as numpy leaves keyed by the reference's pytree path
    strings (``.window``, ``.queue``, ``.policy_state.record``, ...)."""
    def arr(x):
        return x.detach().cpu().numpy()

    leaves = {".window": np.asarray(carry.window, np.int32),
              ".queue": arr(carry.queue), ".vol_left": arr(carry.vol_left)}
    ps = carry.policy_state
    if isinstance(ps, AllocatorState):
        leaves.update(zip(_STATE, map(arr, ps)))
    elif isinstance(ps, torch.Tensor):
        leaves[".policy_state"] = arr(ps)
    leaves[".alloc"] = arr(carry.alloc)
    leaves.update(zip(_HELD, map(arr, carry.held)))
    return leaves


def carry_from_numpy(leaves: Mapping[str, np.ndarray],
                     device=None) -> WindowCarry:
    """Rebuild a ``WindowCarry`` from numpy leaves keyed by the reference's
    pytree path strings -- the same keys its checkpoints use -- so a mid-run
    carry of the reference engine continues here.  Policy state is an
    ``AllocatorState`` (``.policy_state.record`` ...), one tensor
    (``.policy_state``) or none, as the leaves say."""
    dev = resolve_device(device)
    if any(k.startswith(".stats") for k in leaves):
        raise _not_ported("a streaming-telemetry carry",
                          'queue A, "Streaming telemetry"')
    missing = [k for k in (".window", *_CARRY_ARRAYS, ".alloc", *_HELD)
               if k not in leaves]
    if missing:
        raise ValueError(f"carry leaves missing: {missing}")

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=torch.float32,
                            device=dev)

    if _STATE[0] in leaves:
        policy_state = AllocatorState(*map(t, _STATE))
    elif ".policy_state" in leaves:
        policy_state = t(".policy_state")
    else:
        policy_state = ()
    return WindowCarry(
        window=int(leaves[".window"]), queue=t(".queue"),
        vol_left=t(".vol_left"), policy_state=policy_state,
        alloc=t(".alloc"), stats=(), held=HeldObs(*map(t, _HELD)))
