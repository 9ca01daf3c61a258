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
allocation round with one launch of ``kernels/csrc/adaptbf_alloc.cu``;
``serve_backend="mega"`` runs the whole control round (gate, every tick,
observation select, policy step) with one launch of
``kernels/csrc/window_mega.cu``.  The default "scan"/"core" pair runs the
plain PyTorch versions on any device, and on CPU tensors every kernel
backend takes its kernel's plain version.

Telemetry is selectable: ``telemetry="trajectory"`` writes the
``[n_windows, O, J]`` outputs; ``telemetry="streaming"`` folds each window
into the carry's ``StreamStats`` (``storage/telemetry.py``), so device
memory does not grow with the horizon and ``n_windows`` can tile a
periodic trace far past its own length.

``control="coded"`` runs the ``CodedPolicy`` combinator over
``cfg.coded_policies``, the member picked by ``control_code``
(``FLEET_CONTROL_CODES`` for the default subset).

The same loop runs a batch of F independent fleets (``storage/tenants.py``)
when given a ``FleetAxis``: every ``[O, J]`` array is then held as
``[F*O, J]`` rows and every ``[O]`` array as ``[F*O]``, which is exact
because no engine or policy op mixes rows.  The rate trace keeps its own
layout (one ``[T, O, J]`` trace shared by every fleet, or ``[F, T, O, J]``)
and reaches the kernels as ``[F, W, O, J]`` windows whose fleet axis is a
stride (0 when shared), so a shared trace is never copied F times.

``partition="ost_shard"`` runs the loop on ``torch.distributed`` ranks, one
shard of OST rows each (``launch/mesh.py``): every rank calls
``simulate_fleet`` with the same global inputs, moves only its own rows to
its device, runs ``_run_windows`` on them, and receives the whole result in
host memory, in one gather at the end.  The one collective inside the loop
is the streaming busy-OST count (``telemetry.update_stats``).  Every
per-window op is row-local, so the result is bitwise the unsharded run's.
``_run_on_mesh`` runs every layout, the tenants' too: an unsharded run is
the one-rank mesh ``_WHOLE``.

Entry points run on the card: ``device=None`` means CUDA and raises when no
GPU is present (a rank's is ``cuda:(rank % device_count)``); pass
``device="cpu"`` to run the plain versions on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.policies import (
    CodedPolicy,
    ControlPolicy,
    PolicyContext,
    WindowObs,
    control_codes,
    get_policy,
)
from repro_torch.core.state import AllocatorState
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.numerics import row_sum
from repro_torch.launch.mesh import Mesh, ost_mesh, rank_device, require_world
from repro_torch.pytree import leaves_with_paths, to_numpy, unflatten
from repro_torch.storage import telemetry
from repro_torch.storage.faults import FaultPlan, plan_pspecs
from repro_torch.storage.telemetry import StreamStats

_EPS = 1e-9

#: Default coded-policy subset (order defines the codes): the paper's three
#: evaluation modes.
DEFAULT_CODED_POLICIES = ("adaptbf", "static", "nobw")
FLEET_CONTROL_CODES = control_codes(DEFAULT_CODED_POLICIES)


class FleetAxis(NamedTuple):
    """F independent fleets of O rows each, held as ``[F*O, ...]`` rows.

    ``code_rows``: under per-fleet control codes, one entry per distinct
    code, ``(code, rows)`` with ``rows`` the int32 ``[n]`` row indices of
    the fleets running that code, built once a run on the run's device
    (the megakernel launches once a window for each); empty otherwise."""

    n_fleets: int
    rows_per_fleet: int
    code_rows: tuple = ()


class SimConfig(NamedTuple):
    capacity_per_tick: float = 20.0    # RPCs/tick the OST can serve
    window_ticks: int = 10             # observation window length in ticks
    tick_seconds: float = 0.01
    control: str = "adaptbf"           # any registered policy name
    u_max: float = 64.0
    integer_tokens: bool = True
    max_backlog: float = 256.0         # default client in-flight cap per job
    telemetry: str = "trajectory"      # trajectory | streaming


class FleetConfig(NamedTuple):
    """Configuration for ``simulate_fleet``; the reference's fields and
    strings, so one config reads the same in both packages."""

    capacity_per_tick: float = 20.0    # default per-OST capacity (RPCs/tick)
    window_ticks: int = 10
    tick_seconds: float = 0.01
    control: str = "adaptbf"           # any registered policy name | coded
    u_max: float = 64.0
    integer_tokens: bool = True
    max_backlog: float = 256.0
    alloc_backend: str = "core"        # core (plain PyTorch) | pallas (the
                                       #   CUDA allocation kernel)
    serve_backend: str = "scan"        # scan (plain per-tick loop) | fused
                                       #   (the CUDA window kernel, one
                                       #   launch per window) | mega (the
                                       #   whole control round, one launch
                                       #   of the CUDA megakernel)
    telemetry: str = "trajectory"      # trajectory | streaming (StreamStats
                                       #   folded into the carry)
    coded_policies: tuple = DEFAULT_CODED_POLICIES
                                       # member subset for control="coded"
    partition: str = "none"            # none | ost_shard (one shard of OST
                                       #   rows a torch.distributed rank)


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


class StreamResult(NamedTuple):
    """Result of a ``telemetry="streaming"`` run: carry-resident sufficient
    statistics instead of ``[n_windows, ...]`` trajectories.  Stats are
    [O, J] from ``simulate_fleet`` and [J] from ``simulate``; feed them to
    the ``streaming_*`` finalizers in ``storage/metrics.py``."""

    stats: StreamStats
    queue_final: torch.Tensor  # [O, J] (fleet) or [J] (single target)
    window_seconds: float


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
    stats: Any                 # StreamStats (streaming) | () (trajectory)
    held: HeldObs              # last *delivered* observation


class WindowOut(NamedTuple):
    """One window's trajectory-mode observation ([O, J] each)."""

    served: torch.Tensor
    demand: torch.Tensor
    alloc: torch.Tensor
    record: torch.Tensor


def _check_config(cfg: FleetConfig) -> None:
    """Reject options this package does not run, before any work."""
    if cfg.telemetry not in ("trajectory", "streaming"):
        raise ValueError(f"unknown telemetry mode: {cfg.telemetry!r}")
    if cfg.serve_backend not in ("scan", "fused", "mega"):
        raise ValueError(f"unknown serve_backend: {cfg.serve_backend!r}")
    if cfg.partition not in ("none", "ost_shard"):
        raise ValueError(f"unknown partition: {cfg.partition!r}")


def init_carry(cfg: FleetConfig, policy: ControlPolicy, ctx: PolicyContext,
               volume: torch.Tensor, n_fleets: Optional[int] = None
               ) -> WindowCarry:
    """Window-0 carry: empty queues, full volumes, the policy's cold-start
    state and allocation, and zeroed streaming stats when enabled (with
    ``n_fleets``, ``[n_fleets]`` window counters over ``[F*O]`` rows)."""
    _check_config(cfg)

    def zoj():
        return torch.zeros_like(ctx.nodes)

    n_ost, n_jobs = ctx.nodes.shape
    return WindowCarry(
        window=0, queue=zoj(), vol_left=volume,
        policy_state=policy.init_state(ctx), alloc=policy.init_alloc(ctx),
        stats=(telemetry.init_stats(n_ost, n_jobs, ctx.nodes.device,
                                    n_fleets=n_fleets)
               if cfg.telemetry == "streaming" else ()),
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
                axis_name=None, faults_w: Optional[FaultPlan] = None,
                fleets: Optional[FleetAxis] = None):
    """One observation window: gate, serve every tick, observe, re-allocate.

    Args:
      cfg/policy/ctx: configuration, control discipline, per-run context
        (``ctx.cap_w`` must equal ``cap_tick * cfg.window_ticks``).
      cap_tick: [O] per-target service rate; backlog_cap: [O, J].
      carry: the ``WindowCarry`` from the previous window (or
        ``init_carry``).
      rates_w: [window_ticks, O, J] this window's client issue attempts.
      axis_name: the ``ost`` axis's process group when the rows are one
        rank's shard (``Mesh.ost_group``): the streaming busy-OST count is
        summed over it.
      faults_w: optional ``FaultPlan`` row ([O] tensors): a down OST
        (``up == 0``) serves and issues nothing; ``cap_scale`` scales its
        service rate; on a lost-telemetry window (``telem_ok == 0``) the
        policy's ``step`` sees the last delivered observation
        (``carry.held``) while the engine serves normally.
      fleets: optional ``FleetAxis``: every ``[O]``/``[O, J]`` array above
        (fault row included) is then ``[F*O]``/``[F*O, J]`` rows and
        ``rates_w`` is ``[F, window_ticks, O, J]``, its fleet axis of any
        stride.

    Streaming telemetry folds the window into ``carry.stats`` against the
    window's effective capacity and fault row.

    Returns ``(carry', out)`` with ``out`` a ``WindowOut`` in trajectory
    mode and ``None`` in streaming mode (the stats live in the carry).
    """
    if faults_w is None:
        ctx_w, cap_tick_w, up_col = ctx, cap_tick, None
    else:
        # with an all-ones row every op below is an IEEE identity
        cap_tick_w = cap_tick * faults_w.up * faults_w.cap_scale
        # up as [W=1, O, J=1] rows, [F, 1, O, 1] with fleets
        rates_w = rates_w * faults_w.up.view(
            *rates_w.shape[:-3], 1, rates_w.shape[-2], 1)
        ctx_w = ctx._replace(cap_w=cap_tick_w * cfg.window_ticks)
        up_col = faults_w.up[:, None]
    if cfg.serve_backend == "mega":
        # the whole control round in one call: one megakernel launch on
        # the card, its plain version on the CPU
        from repro_torch.kernels.window_mega import ops as mega_ops
        (queue, vol_left, served_w, demand, obs_served, obs_demand,
         obs_alloc, pstate, alloc_next) = mega_ops.mega_window_round(
            policy, ctx_w, cap_tick_w, backlog_cap, carry.queue,
            carry.vol_left, carry.alloc, carry.held, carry.policy_state,
            rates_w,
            telem_ok=None if faults_w is None else faults_w.telem_ok,
            up=None if faults_w is None else faults_w.up,
            code_rows=None if fleets is None else fleets.code_rows)
    else:
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
            obs_alloc = torch.where(delivered, carry.alloc,
                                    carry.held.alloc)
        pstate, alloc_next = policy.step(
            carry.policy_state,
            WindowObs(served=obs_served, demand=obs_demand, alloc=obs_alloc,
                      up=up_col), ctx_w)
    if cfg.telemetry == "streaming":
        stats = telemetry.update_stats(
            carry.stats, served_w, demand, carry.alloc, ctx_w.cap_w,
            axis_name=axis_name, faults_w=faults_w,
            n_fleets=None if fleets is None else fleets.n_fleets)
        out = None
    else:
        stats = carry.stats
        out = WindowOut(served=served_w, demand=demand, alloc=carry.alloc,
                        record=policy.record(pstate, ctx_w))
    return WindowCarry(window=carry.window + 1, queue=queue,
                       vol_left=vol_left, policy_state=pstate,
                       alloc=alloc_next, stats=stats,
                       held=HeldObs(served=obs_served, demand=obs_demand,
                                    alloc=obs_alloc)), out


def _run_windows(cfg: FleetConfig, policy: ControlPolicy, nodes, rates,
                 volume, cap_tick, backlog_cap, control_code,
                 n_windows: Optional[int], axis_name=None,
                 fault_plan: Optional[FaultPlan] = None,
                 fleets: Optional[FleetAxis] = None):
    """The single window loop behind every entry point.

    nodes/volume/backlog_cap: [O, J]; rates: [T, O, J]; cap_tick: [O], all
    float32 on one device; ``control_code`` a host int or None.
    ``n_windows`` extends (or trims) the horizon by
    indexing the trace periodically; None runs exactly the windows the trace
    covers.  ``axis_name``: the ``ost`` axis's process group when the rows
    are one rank's shard (see ``window_step``).  ``fault_plan`` ([n_windows,
    O] leaves) covers the *run* horizon, one row per executed window, and
    is never tiled.

    With ``fleets`` (F fleets of O rows): nodes/volume/backlog_cap are
    [F*O, J], cap_tick and the fault plan's rows [F*O], rates [T, O, J]
    shared by every fleet or [F, T, O, J], and ``control_code`` may be a
    [F*O, 1] int32 tensor of per-row codes.

    Returns ``(queue_final, outs)`` with ``outs`` a ``WindowOut`` of
    preallocated ``[n_windows, O, J]`` trajectories (``[F, n_windows, O,
    J]`` with fleets) in trajectory mode and the final ``StreamStats`` in
    streaming mode (nothing is allocated per window then).
    """
    t_total, n_ost, n_jobs = rates.shape[-3:]
    n_rows = nodes.shape[0]
    trace_windows = t_total // cfg.window_ticks
    if trace_windows == 0:
        raise ValueError(
            f"trace covers {t_total} ticks < one {cfg.window_ticks}-tick window")
    if n_windows is None:
        n_windows = trace_windows
    if fault_plan is not None:
        fault_plan = FaultPlan(*(_f32(x, rates.device) for x in fault_plan))
        _check_plan(fault_plan, n_windows, n_rows)
    # [..., trace_windows, W, O, J]: a view, whatever the leading axes
    trace = rates[..., : trace_windows * cfg.window_ticks, :, :].reshape(
        *rates.shape[:-3], trace_windows, cfg.window_ticks, n_ost, n_jobs)

    def rates_at(w: int) -> torch.Tensor:
        """Window w's rates: [W, O, J], or [F, W, O, J] with fleets (the
        fleet axis of a shared trace a stride-0 expand, not a copy)."""
        k = w % trace_windows
        if fleets is None:
            return trace[k]
        if rates.ndim == 3:
            return trace[k].expand(fleets.n_fleets, *trace.shape[1:])
        return trace[:, k]

    ctx = PolicyContext(
        nodes=nodes, cap_w=cap_tick * cfg.window_ticks, u_max=cfg.u_max,
        integer_tokens=cfg.integer_tokens, alloc_backend=cfg.alloc_backend,
        control_code=control_code)

    carry = init_carry(cfg, policy, ctx, volume,
                       n_fleets=None if fleets is None else fleets.n_fleets)
    streaming = cfg.telemetry == "streaming"
    if not streaming:
        shape = ((n_windows, n_ost, n_jobs) if fleets is None
                 else (fleets.n_fleets, n_windows, n_ost, n_jobs))
        outs = WindowOut(*(rates.new_empty(shape) for _ in WindowOut._fields))
    for w in range(n_windows):
        faults_w = (None if fault_plan is None
                    else FaultPlan(*(leaf[w] for leaf in fault_plan)))
        carry, out = window_step(cfg, policy, ctx, cap_tick, backlog_cap,
                                 carry, rates_at(w), axis_name=axis_name,
                                 faults_w=faults_w, fleets=fleets)
        if not streaming:
            for dst, src in zip(outs, out):
                dst[..., w, :, :] = src.reshape(*dst.shape[:-3], n_ost, n_jobs)
    return carry.queue, (carry.stats if streaming else outs)


def _check_plan(fault_plan: FaultPlan, n_windows: int, n_rows: int) -> None:
    for name, leaf in zip(FaultPlan._fields, fault_plan):
        if tuple(leaf.shape) != (n_windows, n_rows):
            raise ValueError(
                f"fault_plan.{name} must be [n_windows={n_windows}, "
                f"n_ost={n_rows}]; got {tuple(leaf.shape)} (the plan "
                "covers the run horizon, one row per executed window)")


#: StreamStats fields counted once a fleet ([F] under a tenant batch),
#: not once a row
_PER_FLEET = ("windows", "busy_windows")

#: each input's layout over a mesh, a fleet's own (``launch/mesh.py``):
#: OST rows split over the ``ost`` axis, the trace's ticks whole
_LAYOUTS = {"nodes": ("ost", None), "issue_rate": (None, "ost", None),
            "volume": ("ost", None), "capacity_per_tick": ("ost",),
            "max_backlog": ("ost", None)}

#: the mesh of an unsharded run: one rank holding every block
_WHOLE = Mesh({"fleet": 1, "ost": 1}, {"fleet": 0, "ost": 0}, None)


def _split_stats(stats: StreamStats, n_fleets: int) -> StreamStats:
    """[F*O, ...] row leaves -> [F, O, ...]; the per-fleet counters stay."""
    def split(x):
        return x.view(n_fleets, x.shape[0] // n_fleets, *x.shape[1:])

    return stats._replace(
        **{f: split(getattr(stats, f)) for f in stats._fields
           if f not in _PER_FLEET + ("comp",)},
        comp=type(stats.comp)(*map(split, stats.comp)))


def _gather_windows(mesh: Mesh, cfg: FleetConfig, queue, outs,
                    lead: Optional[str] = None):
    """The whole run's ``(queue, outs)`` on every rank, from each rank's
    rows: one gather, at the end of the run.  ``lead="fleet"``: a tenant
    batch's ``[F, O, ...]`` blocks, split over the fleet axis too."""
    front = () if lead is None else (lead,)
    if cfg.telemetry == "streaming":
        pairs = telemetry.stats_layout(
            outs, telemetry.stats_pspecs("ost", lead=lead))
    else:
        pairs = [(x, (*front, None, "ost", None)) for x in outs]
    got = mesh.gather([queue, *(x for x, _ in pairs)],
                      [(*front, "ost", None), *(spec for _, spec in pairs)])
    return got[0], unflatten(outs, got[1:])


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device for a rank's run, so its
    kernels launch where its tensors are."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _run_on_mesh(mesh: Mesh, cfg: FleetConfig, policy: ControlPolicy, dev,
                 inputs: Mapping[str, torch.Tensor], control_code,
                 n_windows: Optional[int],
                 fault_plan: Optional[FaultPlan] = None, *,
                 batched: frozenset = frozenset(),
                 fleets: Optional[FleetAxis] = None):
    """``_run_windows`` on this rank's block of ``mesh``, and the whole
    result.

    ``inputs`` (``simulate_fleet``'s arrays by name: nodes, issue_rate,
    volume, capacity_per_tick, max_backlog, in full) and
    ``fault_plan`` are global and still where the caller had them: only
    this rank's block of each (``_LAYOUTS``, ``faults.plan_pspecs``) moves
    to ``dev``, so the whole trace never lands there.  The loop is the
    single-device loop on those rows; its one collective is the streaming
    busy-OST count over ``mesh.ost_group``.  Under a sharded
    ``cfg.partition`` every rank receives the whole result in one gather
    at the end (``Mesh.gather``, into host memory); unsharded (``_WHOLE``)
    it stays on ``dev``.

    With ``fleets`` (this rank's fleets and rows of a tenant batch),
    ``batched`` names the inputs (and ``"fault_plan"``) that carry a
    leading ``[F]`` axis, split over ``fleet``; the others are shared by
    every fleet.  The blocks reach the loop as ``[F*O, ...]`` rows (the
    plan as ``[W, F*O]``, the rates as they are) and the result leaves it
    as ``[F, O, ...]``."""
    def rows(x, is_batched: bool) -> torch.Tensor:
        """A block [F, O, ...] (or a shared [O, ...]) -> [F*O, ...]."""
        if not is_batched:
            x = x.expand(fleets.n_fleets, *x.shape)
        return x.reshape(-1, *x.shape[2:]).contiguous()

    local = {}
    for name, x in inputs.items():
        lead = ("fleet",) if name in batched else ()
        x = _f32(mesh.block(x, (*lead, *_LAYOUTS[name])), dev)
        local[name] = (x if fleets is None or name == "issue_rate"
                       else rows(x, name in batched))
    if fault_plan is not None:
        plan_batched = "fault_plan" in batched
        fault_plan = FaultPlan(*(
            _f32(mesh.block(leaf, spec), dev) for leaf, spec in
            zip(fault_plan, plan_pspecs("fleet" if plan_batched else None))))
        if fleets is not None:    # [W, F*O]: a window's row, every fleet
            fault_plan = FaultPlan(*(
                rows(leaf.transpose(-1, -2), plan_batched).T.contiguous()
                for leaf in fault_plan))
    with _on(dev):
        queue, outs = _run_windows(
            cfg._replace(partition="none"), policy, local["nodes"],
            local["issue_rate"], local["volume"],
            local["capacity_per_tick"], local["max_backlog"], control_code,
            n_windows, axis_name=mesh.ost_group, fault_plan=fault_plan,
            fleets=fleets)
        if fleets is not None:
            queue = queue.view(fleets.n_fleets, -1, queue.shape[-1])
            if cfg.telemetry == "streaming":
                outs = _split_stats(outs, fleets.n_fleets)
        if cfg.partition == "none":
            return queue, outs
        return _gather_windows(mesh, cfg, queue, outs,
                               lead=None if fleets is None else "fleet")


def _tensor(x) -> torch.Tensor:
    """Numpy or torch input as a tensor where it lies (no copy for numpy)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _filled(shape, value: float) -> torch.Tensor:
    """A float32 ``shape`` of ``value`` (an expanded scalar: no memory)."""
    return torch.full((), value, dtype=torch.float32).expand(shape)


def _f32(x, device: torch.device) -> torch.Tensor:
    """Numpy or torch input -> contiguous float32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def _resolve_policy(cfg, control_code) -> ControlPolicy:
    _check_config(cfg)
    coded = cfg.control == "coded"
    if coded and control_code is None:
        raise ValueError('cfg.control == "coded" requires control_code')
    if not coded and control_code is not None:
        raise ValueError('control_code requires cfg.control == "coded"')
    if coded:
        return CodedPolicy(cfg.coded_policies)
    return get_policy(cfg.control)


def _host_code(control_code) -> Optional[int]:
    """A Python int or 0-d integer tensor (or array) -> a host int, read once
    per run rather than once per window."""
    if control_code is None:
        return None
    code = torch.as_tensor(control_code)
    if code.ndim != 0 or code.is_floating_point() or code.is_complex():
        raise ValueError("control_code must be an integer scalar; got "
                         f"{code.dtype} of shape {tuple(code.shape)}")
    return int(code)


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

    Returns a ``SimResult``, or a ``StreamResult`` ([J] stats) when
    ``cfg.telemetry == "streaming"``.
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
        backlog_cap, None, n_windows)
    window_seconds = cfg.window_ticks * cfg.tick_seconds
    if cfg.telemetry == "streaming":
        return StreamResult(stats=telemetry.squeeze_stats(outs),
                            queue_final=queue[0],
                            window_seconds=window_seconds)
    served, demand, alloc, record = (x[:, 0] for x in outs)
    return SimResult(served=served, demand=demand, alloc=alloc,
                     record=record, queue_final=queue[0],
                     window_seconds=window_seconds)


# -------------------------------------------------------------------- fleet


def simulate_fleet(cfg: FleetConfig, nodes, issue_rate, volume,
                   capacity_per_tick=None, max_backlog=None,
                   control_code=None, n_windows: Optional[int] = None,
                   fault_plan: Optional[FaultPlan] = None, *,
                   device=None) -> FleetResult:
    """Simulate ``n_ost`` storage targets with striped client demand.

    Args:
      cfg: FleetConfig.  ``cfg.control`` names a registered policy, or
        ``"coded"`` (see ``control_code``).
      nodes: [J] or [O, J] compute nodes per job.
      issue_rate: [T, O, J] per-target client issue attempts (RPCs/tick).
      volume: [O, J] total RPCs per job per target (inf = unbounded).
      capacity_per_tick: optional [O] per-OST service rates (default
        cfg.capacity_per_tick everywhere).
      max_backlog: optional [O, J] per-target client in-flight caps.
      control_code: a Python int or 0-d integer tensor selecting the member
        of ``cfg.coded_policies`` (default codes: ``FLEET_CONTROL_CODES``);
        requires ``cfg.control == "coded"``.
      n_windows: optional horizon override; the rate trace is indexed
        periodically beyond its own length.
      fault_plan: optional ``FaultPlan`` ([n_windows, O] leaves, one row per
        executed window): outages freeze queues and volumes, droop scales
        service, lost-telemetry windows hold the controller's previous
        observation.
      device: None (CUDA; raises without a GPU) or "cpu".  Inputs move to
        it as float32 before any arithmetic.  Under ``cfg.partition ==
        "ost_shard"`` each rank's ``None`` is ``cuda:(rank %
        device_count)``, and only the rank's rows move.

    ``cfg.partition == "ost_shard"`` needs ``torch.distributed``'s default
    process group (``ValueError`` otherwise) and ``n_ost`` divisible by its
    size; every rank passes the same global inputs and receives the whole
    result in host memory, bitwise the unsharded run's.

    Returns:
      FleetResult with [n_windows, O, J] trajectories on ``device`` (in
      host memory when sharded), or a StreamResult when ``cfg.telemetry ==
      "streaming"``.
    """
    policy = _resolve_policy(cfg, control_code)
    rates = _tensor(issue_rate)
    _t, n_ost, n_jobs = rates.shape
    nodes = _tensor(nodes)
    if nodes.ndim == 1:
        nodes = nodes.expand(n_ost, n_jobs)
    cap_tick = (_filled((n_ost,), cfg.capacity_per_tick)
                if capacity_per_tick is None else _tensor(capacity_per_tick))
    backlog_cap = (_filled((n_ost, n_jobs), cfg.max_backlog)
                   if max_backlog is None else _tensor(max_backlog))
    if cfg.partition == "ost_shard":
        require_world('partition="ost_shard"')
        mesh = ost_mesh()
        if n_ost % mesh.size:
            raise ValueError(
                f'partition="ost_shard" needs n_ost ({n_ost}) divisible by '
                f"the mesh size ({mesh.size} devices); pad the fleet or "
                "start a compatible number of ranks")
        dev = rank_device(device)
    else:
        mesh, dev = _WHOLE, resolve_device(device)
    if fault_plan is not None:    # the global plan, before it is cut
        fault_plan = FaultPlan(*map(_tensor, fault_plan))
        _check_plan(fault_plan, _t // cfg.window_ticks
                    if n_windows is None else n_windows, n_ost)
    queue, outs = _run_on_mesh(
        mesh, cfg, policy, dev,
        dict(nodes=nodes, issue_rate=rates, volume=_tensor(volume),
             capacity_per_tick=cap_tick, max_backlog=backlog_cap),
        _host_code(control_code), n_windows, fault_plan=fault_plan)
    window_seconds = cfg.window_ticks * cfg.tick_seconds
    if cfg.telemetry == "streaming":
        return StreamResult(stats=outs, queue_final=queue,
                            window_seconds=window_seconds)
    return FleetResult(*outs, queue_final=queue,
                       window_seconds=window_seconds)


def utilization(result, cfg, capacity_per_tick=None):
    """Per-window fraction of disk capacity actually used; the definition
    lives in ``storage/metrics.py``."""
    from repro_torch.storage import metrics
    return metrics.utilization(result, cfg,
                               capacity_per_tick=capacity_per_tick)


# ------------------------------------------------------- carrying state over

#: carry leaves by the reference's pytree path strings (the checkpoint
#: format's keys), in the reference's flattening order
_CARRY_ARRAYS = (".queue", ".vol_left")
_HELD = tuple(f".held.{f}" for f in HeldObs._fields)
_STATE = ".policy_state"


def _state_from_numpy(leaves, prefix: str, tensor):
    if f"{prefix}.{AllocatorState._fields[0]}" in leaves:
        return AllocatorState(*(tensor(f"{prefix}.{f}")
                                for f in AllocatorState._fields))
    if prefix in leaves:
        return tensor(prefix)
    return ()


def carry_to_numpy(carry: WindowCarry) -> Dict[str, np.ndarray]:
    """A ``WindowCarry`` as numpy leaves keyed by the reference's pytree path
    strings (``.window``, ``.queue``, ``.policy_state.record``,
    ``.policy_state[0].record`` for a coded carry, ``.stats.served_sum``,
    ``.stats.comp.lag_hist`` ...), in the reference's order and dtypes."""
    return {path: to_numpy(x) for path, x in leaves_with_paths(carry)}


def carry_from_numpy(leaves: Mapping[str, np.ndarray], device=None, *,
                     policy: Optional[ControlPolicy] = None) -> WindowCarry:
    """Rebuild a ``WindowCarry`` from numpy leaves keyed by the reference's
    pytree path strings -- the same keys its checkpoints use -- so a mid-run
    carry of the reference engine continues here.  Policy state is an
    ``AllocatorState`` (``.policy_state.record`` ...), one tensor
    (``.policy_state``, aimd's rates) or none, as the leaves say.  A coded
    carry (``.policy_state[i]...``) needs ``policy``, the run's
    ``CodedPolicy``: its member count sizes the state tuple, since a
    stateless member leaves no key.  A streaming carry's ``.stats...``
    leaves come back in their own dtypes (int32 counters, float32 sums);
    every other leaf is float32."""
    dev = resolve_device(device)
    stats_like = None
    if any(k.startswith(".stats") for k in leaves):
        stats_like = leaves_with_paths(telemetry.init_stats(1, 1), ".stats")
    missing = [k for k in (".window", *_CARRY_ARRAYS, ".alloc", *_HELD,
                           *(p for p, _ in stats_like or ()))
               if k not in leaves]
    if missing:
        raise ValueError(f"carry leaves missing: {missing}")

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=torch.float32,
                            device=dev)

    if isinstance(policy, CodedPolicy):
        policy_state = tuple(_state_from_numpy(leaves, f"{_STATE}[{i}]", t)
                             for i in range(len(policy.members)))
    elif any(k.startswith(f"{_STATE}[") for k in leaves):
        raise ValueError("a coded carry (.policy_state[i] leaves) needs "
                         "policy=, the run's CodedPolicy")
    else:
        policy_state = _state_from_numpy(leaves, _STATE, t)
    stats = ()
    if stats_like is not None:
        stats = unflatten(telemetry.init_stats(1, 1), (
            torch.tensor(np.asarray(leaves[p]), dtype=x.dtype, device=dev)
            for p, x in stats_like))
    return WindowCarry(
        window=int(leaves[".window"]), queue=t(".queue"),
        vol_left=t(".vol_left"), policy_state=policy_state,
        alloc=t(".alloc"), stats=stats, held=HeldObs(*map(t, _HELD)))
