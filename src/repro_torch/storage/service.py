"""Online serving mode: a long-lived windowed controller over the fleet
engine, with checkpoint/restore of the full carry.

Everything else in ``storage/`` is offline: build a ``[T, O, J]`` trace,
run the window loop, read the metrics.  Production control is online:
rate observations arrive every 100 ms window and the controller must step
incrementally, for days, and survive restarts.

``FleetService`` is that loop.  It ingests one window of rate observations
at a time and advances the *same* ``window_step`` the offline loop runs
(``storage/simulator.py``), so:

* streaming N windows through ``FleetService.step`` equals one offline
  ``simulate_fleet`` run of the concatenated trace bitwise, for every
  registered policy and both telemetry modes, on the CPU and on the card
  (on CUDA tensors each step launches the same kernels once a window);
* the horizon is unbounded: there is no trace array to outgrow, and with
  ``telemetry="streaming"`` the resident state is the ~[O, J] carry (each
  step's new carry replaces the old one, whose buffers go back to the
  caching allocator, so device memory stays flat over any horizon);
* crash recovery is exact: ``save()`` checkpoints the complete
  ``WindowCarry`` through ``repro_torch.checkpoint`` in the reference
  package's format, keyed by its pytree path strings (``.queue``,
  ``.stats.served_sum``, ...); ``restore()`` resumes bitwise from any saved
  window, and a checkpoint of either package's service restores in the
  other's.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.policies import PolicyContext
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.pytree import leaves_with_paths
from repro_torch.storage import telemetry
from repro_torch.storage.faults import FaultPlan, lost_telemetry_row
from repro_torch.storage.simulator import (
    FleetConfig,
    FleetResult,
    StreamResult,
    WindowCarry,
    WindowOut,
    _f32,
    _host_code,
    _resolve_policy,
    init_carry,
    window_step,
)


class IngestResult(NamedTuple):
    """What one ``FleetService.ingest`` round did.

    out:       the window's ``WindowOut`` (trajectory mode) or None.
    delivered: True when the observation arrived (possibly after
               retries); False when the watchdog substituted the
               loss-mask path.
    attempts:  fetch attempts made (1 = first try succeeded).
    """

    out: Optional[WindowOut]
    delivered: bool
    attempts: int


class FleetService:
    """A long-lived fleet controller stepped one observation window at a
    time.

    Args:
      cfg: FleetConfig.  ``partition`` must be ``"none"``: the online loop
        is a host-driven single-process service.
      nodes: [J] or [O, J] compute nodes per job (priorities).
      volume: [O, J] total RPCs per job per target (inf = unbounded).
      capacity_per_tick: optional [O] per-OST service rates.
      max_backlog: optional [O, J] client in-flight caps.
      control_code: policy selector, a host int or 0-d integer tensor
        (requires ``control="coded"``).
      checkpoint_dir: where ``save()``/``restore()`` keep carries; may be
        None for a checkpoint-less service.
      keep_checkpoints: how many committed checkpoints ``save()`` keeps.
      fault_plan: optional ``faults.FaultPlan`` ([W, O] leaves).  Each
        ``step`` consumes row ``window % W`` (the plan tiles an unbounded
        online horizon the way rate traces tile), unless the caller
        passes an explicit per-step fault row.
      checkpoint_on_fault: with a ``checkpoint_dir``, ``save()``
        automatically *before* stepping into any window where an OST goes
        from up to down, so a post-mortem ``restore()`` replays the run
        from the disturbance onward.  The trigger reads a host copy of
        the plan: no device-to-host copy a window.
      device: None (CUDA; raises without a GPU) or "cpu".

    Usage::

        svc = FleetService(cfg, nodes, volume, checkpoint_dir="ckpt/")
        for rates_w in observation_source():      # [window_ticks, O, J]
            out = svc.step(rates_w)
            if svc.window % 600 == 0:
                svc.save()                        # survive a crash
        # after a crash: a fresh FleetService + svc.restore() resumes
        # bitwise where the last save() left off
    """

    def __init__(
        self,
        cfg: FleetConfig,
        nodes,
        volume,
        capacity_per_tick=None,
        max_backlog=None,
        control_code=None,
        checkpoint_dir: Optional[str] = None,
        keep_checkpoints: int = 3,
        fault_plan: Optional[FaultPlan] = None,
        checkpoint_on_fault: bool = True,
        *,
        device=None,
    ):
        if cfg.partition != "none":
            raise ValueError(
                'FleetService runs the single-process online loop; '
                f'partition={cfg.partition!r} is an offline-scan feature '
                '(use simulate_fleet for sharded batch runs)')
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        self.checkpoint_dir = checkpoint_dir
        self.keep_checkpoints = keep_checkpoints
        self.checkpoint_on_fault = checkpoint_on_fault
        self._policy = _resolve_policy(cfg, control_code)
        self._control_code = _host_code(control_code)

        volume = _f32(volume, dev)
        n_ost, n_jobs = volume.shape
        self.n_ost, self.n_jobs = n_ost, n_jobs
        nodes = _f32(nodes, dev)
        if nodes.ndim == 1:
            nodes = nodes.expand(n_ost, n_jobs).contiguous()
        self._nodes = nodes
        if capacity_per_tick is None:
            self._cap_tick = torch.full((n_ost,), cfg.capacity_per_tick,
                                        dtype=torch.float32, device=dev)
        else:
            self._cap_tick = _f32(capacity_per_tick, dev)
        if max_backlog is None:
            self._backlog_cap = torch.full(
                (n_ost, n_jobs), cfg.max_backlog, dtype=torch.float32,
                device=dev)
        else:
            self._backlog_cap = _f32(max_backlog, dev)

        self._fault_plan = self._fault_plan_dev = None
        if fault_plan is not None:
            host = FaultPlan(*(np.asarray(x, np.float32) for x in fault_plan))
            for name, leaf in zip(FaultPlan._fields, host):
                if leaf.ndim != 2 or leaf.shape[1] != n_ost:
                    raise ValueError(
                        f"fault_plan.{name} must be [W, n_ost={n_ost}]; "
                        f"got {leaf.shape}")
            # the host copy drives the checkpoint trigger, the device copy
            # the engine
            self._fault_plan = host
            self._fault_plan_dev = FaultPlan(*(_f32(x, dev) for x in host))
        # which OSTs were up at the end of the last step (host side)
        self._up_prev = np.ones(n_ost, bool)
        #: windows advanced through the watchdog loss-mask path
        self.lost_windows = 0
        #: total ingest retries used across the service lifetime
        self.retry_count = 0
        self._carry = init_carry(cfg, self._policy, self._ctx(), volume)

    def _ctx(self) -> PolicyContext:
        return PolicyContext(
            nodes=self._nodes, cap_w=self._cap_tick * self.cfg.window_ticks,
            u_max=self.cfg.u_max, integer_tokens=self.cfg.integer_tokens,
            alloc_backend=self.cfg.alloc_backend,
            control_code=self._control_code)

    # ------------------------------------------------------------ stepping

    def step(self, rates_w, faults_w: Optional[FaultPlan] = None
             ) -> Optional[WindowOut]:
        """Advance one observation window.

        Args:
          rates_w: [window_ticks, O, J] client issue attempts observed
            this window (numpy, or a tensor; moved to the service's
            device as float32).
          faults_w: optional fault row ([O] leaves) for this window;
            defaults to the constructor ``fault_plan``'s row for the
            current window index (None when the service has no plan).

        Returns the window's ``WindowOut`` (served/demand/alloc/record,
        each [O, J]) in trajectory mode, None in streaming mode (the
        accumulated ``StreamStats`` are at ``self.stats``).

        With ``checkpoint_on_fault`` and a ``checkpoint_dir``, a fault
        row that takes a previously-up OST down triggers ``save()``
        *before* the step, so restore replays from the disturbance.
        """
        rates_w = _f32(rates_w, self.device)
        if tuple(rates_w.shape) != (self.cfg.window_ticks, self.n_ost,
                                    self.n_jobs):
            raise ValueError(
                f"rates_w must be [window_ticks={self.cfg.window_ticks}, "
                f"O={self.n_ost}, J={self.n_jobs}]; got "
                f"{tuple(rates_w.shape)}")
        if faults_w is None and self._fault_plan is not None:
            w = self.window % self._fault_plan.n_windows
            up_now = self._fault_plan.up[w] > 0
            faults_w = self._fault_plan_dev.row(w)
        elif faults_w is not None:
            for name, leaf in zip(FaultPlan._fields, faults_w):
                if tuple(np.shape(leaf)) != (self.n_ost,):
                    raise ValueError(
                        f"faults_w.{name} must be a fault *row* "
                        f"[n_ost={self.n_ost}]; got {tuple(np.shape(leaf))}")
            up_now = _host_bool(faults_w.up)
            faults_w = FaultPlan(*(_f32(x, self.device) for x in faults_w))
        else:
            up_now = np.ones(self.n_ost, bool)
        if (self._up_prev & ~up_now).any() and self.checkpoint_on_fault \
                and self.checkpoint_dir is not None:
            self.save()
        self._up_prev = up_now
        self._carry, out = window_step(
            self.cfg, self._policy, self._ctx(), self._cap_tick,
            self._backlog_cap, self._carry, rates_w, faults_w=faults_w)
        return out

    def run(self, rates, n_windows: Optional[int] = None,
            fault_plan: Optional[FaultPlan] = None):
        """Drive the service from a materialized [T, O, J] trace (tiled
        periodically past its own length when ``n_windows`` asks for
        more), collecting outputs into the result types ``simulate_fleet``
        returns.  Mainly a convenience for demos and the online==offline
        oracle tests.

        ``fault_plan`` must cover the run horizon exactly ([n_windows, O]
        leaves, row ``w`` consumed at window ``w``): the absolute
        fault-timeline semantics ``simulate_fleet`` uses."""
        rates = _f32(rates, self.device)
        wt = self.cfg.window_ticks
        trace_windows = rates.shape[0] // wt
        if trace_windows == 0:
            raise ValueError(
                f"trace covers {rates.shape[0]} ticks < one {wt}-tick window")
        if n_windows is None:
            n_windows = trace_windows
        if fault_plan is not None and fault_plan.n_windows != n_windows:
            raise ValueError(
                f"fault_plan covers {fault_plan.n_windows} windows but the "
                f"run is {n_windows} windows (the plan is never tiled here)")
        outs = []
        for w in range(n_windows):
            s = (w % trace_windows) * wt
            out = self.step(rates[s:s + wt],
                            faults_w=(None if fault_plan is None
                                      else fault_plan.row(w)))
            if out is not None:
                outs.append(out)
        window_seconds = wt * self.cfg.tick_seconds
        if self.cfg.telemetry == "streaming":
            return StreamResult(stats=self.stats, queue_final=self.queue,
                                window_seconds=window_seconds)
        stack = WindowOut(*(torch.stack(x) for x in zip(*outs)))
        return FleetResult(served=stack.served, demand=stack.demand,
                           alloc=stack.alloc, record=stack.record,
                           queue_final=self.queue,
                           window_seconds=window_seconds)

    def ingest(self, fetch: Callable, faults_w: Optional[FaultPlan] = None,
               retries: int = 3, backoff_s: float = 0.05,
               deadline_s: Optional[float] = None,
               sleep: Callable = time.sleep,
               clock: Callable = time.monotonic) -> IngestResult:
        """One production control round: fetch this window's observation
        with bounded retry and exponential backoff, then step; if delivery
        ultimately fails, advance through the loss-mask path instead of
        stalling the loop.

        Args:
          fetch: zero-arg callable returning this window's
            ``[window_ticks, O, J]`` rates, or None / raising on a failed
            delivery attempt (a dropped stats RPC, a timed-out collector).
          faults_w: optional fault row forwarded to ``step`` (defaults to
            the constructor plan's row, like ``step``).
          retries: attempts after the first (so ``retries + 1`` fetches
            at most).
          backoff_s: first retry delay; doubles per retry.
          deadline_s: optional missed-deadline watchdog: once this much
            wall time has elapsed, no further retry is attempted even if
            the retry budget remains (a late observation is a lost one).
          sleep/clock: injectable for deterministic tests.

        On delivery failure the service steps anyway with zero observed
        arrivals and the window's ``telem_ok`` forced to zero: the engine
        keeps draining standing queues at full (fault-adjusted) capacity
        while the policy holds its last delivered observation.  Counted in
        ``self.lost_windows`` / ``self.retry_count``.
        """
        if faults_w is None and self._fault_plan is not None:
            faults_w = self._fault_plan.row(self.window)
        t0 = clock()
        rates_w, attempts = None, 0
        while rates_w is None and attempts <= retries:
            try:
                attempts += 1
                rates_w = fetch()
            except Exception:  # noqa: BLE001 -- any failed delivery retries
                rates_w = None
            if rates_w is not None:
                break
            if attempts > retries:
                break
            delay = backoff_s * (2.0 ** (attempts - 1))
            if deadline_s is not None:
                remaining = deadline_s - (clock() - t0)
                if remaining <= 0:
                    break                      # watchdog: deadline missed
                delay = min(delay, remaining)
            sleep(delay)
        self.retry_count += attempts - 1
        if rates_w is not None:
            out = self.step(rates_w, faults_w=faults_w)
            return IngestResult(out=out, delivered=True, attempts=attempts)
        self.lost_windows += 1
        zeros = torch.zeros((self.cfg.window_ticks, self.n_ost, self.n_jobs),
                            dtype=torch.float32, device=self.device)
        lost = lost_telemetry_row(self.n_ost, base=faults_w)
        out = self.step(zeros, faults_w=lost)
        return IngestResult(out=out, delivered=False, attempts=attempts)

    # ------------------------------------------------------------- state

    @property
    def carry(self) -> WindowCarry:
        """The live engine state (treat as read-only)."""
        return self._carry

    @property
    def window(self) -> int:
        """Windows completed since init (or since the restored carry's
        origin)."""
        return int(self._carry.window)

    @property
    def queue(self) -> torch.Tensor:
        """[O, J] standing server-side queues."""
        return self._carry.queue

    @property
    def alloc(self) -> torch.Tensor:
        """[O, J] the allocation that will be applied next window."""
        return self._carry.alloc

    @property
    def budget(self) -> torch.Tensor:
        """[O, J] the token budget next window's gate will grant
        (inf = unruled fallback)."""
        return self._policy.gate(self._carry.alloc, self._ctx())

    @property
    def stats(self) -> Optional[telemetry.StreamStats]:
        """Accumulated ``StreamStats`` (streaming telemetry only)."""
        return (self._carry.stats
                if self.cfg.telemetry == "streaming" else None)

    # -------------------------------------------------- checkpoint/restore

    def save(self, step: Optional[int] = None) -> str:
        """Checkpoint the full carry atomically; returns the final path.
        ``step`` defaults to the current window index."""
        from repro_torch import checkpoint

        if self.checkpoint_dir is None:
            raise ValueError("FleetService built without checkpoint_dir")
        if step is None:
            step = self.window
        path = checkpoint.save_checkpoint(self.checkpoint_dir, self._carry,
                                          step=step)
        checkpoint.gc_checkpoints(self.checkpoint_dir,
                                  keep=self.keep_checkpoints)
        return path

    def restore(self, step: Optional[int] = None) -> int:
        """Replace the live carry with a saved one (latest by default);
        returns the restored checkpoint's step.  The service must have been
        built with the same cfg/shapes/policy that wrote the checkpoint:
        leaves are matched by path and shape, and the common mismatches
        (fleet shape, telemetry mode, control policy) are named up front.
        The checkpoint may come from this package or the reference's."""
        from repro_torch import checkpoint

        if self.checkpoint_dir is None:
            raise ValueError("FleetService built without checkpoint_dir")
        self._validate_checkpoint_meta(
            checkpoint.checkpoint_meta(self.checkpoint_dir, step=step))
        carry, step = checkpoint.restore_checkpoint(
            self.checkpoint_dir, self._carry, step=step)
        self._carry = carry
        # the fault trigger compares with the restored window's predecessor:
        # restoring inside an outage is not a new transition
        w = self.window
        self._up_prev = (self._fault_plan.up[(w - 1) % self._fault_plan
                                             .n_windows] > 0
                         if self._fault_plan is not None and w > 0
                         else np.ones(self.n_ost, bool))
        return step

    def _validate_checkpoint_meta(self, meta: dict):
        """Fail fast, by name, on checkpoints this service cannot host."""
        by_path = {m["path"]: tuple(m["shape"]) for m in meta["leaves"]}
        q = by_path.get(".queue")
        if q is None:
            raise ValueError(
                f"checkpoint step {meta['step']} has no '.queue' leaf -- "
                "not a FleetService carry checkpoint")
        if q != (self.n_ost, self.n_jobs):
            raise ValueError(
                f"checkpoint step {meta['step']} was written for a fleet "
                f"of (n_ost, n_jobs)={q}; this service is "
                f"({self.n_ost}, {self.n_jobs}) -- restore needs the "
                "same fleet shape the checkpoint was saved from")
        saved_streaming = any(p.startswith(".stats") for p in by_path)
        live_streaming = self.cfg.telemetry == "streaming"
        if saved_streaming != live_streaming:
            saved = "streaming" if saved_streaming else "trajectory"
            live = "streaming" if live_streaming else "trajectory"
            raise ValueError(
                f"checkpoint step {meta['step']} was written with "
                f"telemetry={saved!r} but this service runs "
                f"telemetry={live!r} -- the StreamStats carry cannot be "
                "invented or discarded on restore")
        live_pstate = sorted(
            p for p, _ in leaves_with_paths(self._carry)
            if p.startswith(".policy_state"))
        saved_pstate = sorted(
            p for p in by_path if p.startswith(".policy_state"))
        if live_pstate != saved_pstate:
            raise ValueError(
                f"checkpoint step {meta['step']} was written for a "
                "different control policy: its policy_state leaves are "
                f"{saved_pstate} but cfg.control={self.cfg.control!r} "
                f"carries {live_pstate}")


def _host_bool(up) -> np.ndarray:
    """A fault row's ``up`` leaf (numpy or tensor) as a host bool mask."""
    if isinstance(up, torch.Tensor):
        up = up.detach().cpu().numpy()
    return np.asarray(up) > 0
