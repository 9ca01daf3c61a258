"""AdapTBF I/O control plane for the framework's own storage traffic.

The training/serving framework is itself an "HPC application": checkpoint
writers, data-pipeline readers and serving request classes compete for
storage-target bandwidth.  Each target runs the paper's decentralized
allocator (`core.fleet_allocate`, the plain allocation, on the controller's
device: CUDA unless ``device="cpu"``); this controller is the thin
host-side shim that meters byte streams into 1 MB-RPC tokens, accumulates
per-window demand, and paces callers against their allocated budgets
(Lustre-fallback semantics for jobs the allocator has not ruled yet).

Time is injectable so tests run on a virtual clock.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import fleet_allocate
from repro_torch.core.state import init_fleet_state
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.storage.striping import stripe_targets

logger = logging.getLogger(__name__)

RPC_BYTES = 1 << 20  # 1 token = 1 RPC = 1 MB


class AdapTBFController:
    def __init__(
        self,
        n_targets: int = 4,
        capacity_rpc_per_s: float = 2000.0,
        window_s: float = 0.1,
        u_max: float = 64.0,
        max_jobs: int = 16,
        time_fn: Callable[[], float] = time.monotonic,
        sleep_fn: Callable[[float], None] = time.sleep,
        default_stripe_count: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.n_targets = n_targets
        self.window_s = window_s
        self.capacity = capacity_rpc_per_s * window_s  # tokens per window
        self.u_max = u_max
        self._default_stripe = default_stripe_count or n_targets
        self._time, self._sleep = time_fn, sleep_fn
        self._lock = threading.RLock()
        self._jobs: Dict[str, int] = {}
        self._nodes = np.zeros(max_jobs, np.float32)
        self._stripes: Dict[int, np.ndarray] = {}
        self._rpc_seq = np.zeros(max_jobs, np.int64)
        self._state = init_fleet_state(n_targets, max_jobs, self.device)
        self._demand = np.zeros((n_targets, max_jobs), np.float32)
        self._consumed = np.zeros((n_targets, max_jobs), np.float32)
        # denied requests whose demand is already counted this window:
        # a caller that retries a blocked request every engine step must
        # register its demand ONCE per window, not once per retry --
        # otherwise the allocator over-grants on phantom demand
        self._denied: Set[Tuple[int, int, object]] = set()
        # fallback semantics: unruled jobs are unlimited until first window
        self._budget = np.full((n_targets, max_jobs), np.inf, np.float32)
        self._window_end = self._time() + window_s
        self.windows_run = 0

    # ------------------------------------------------------------- jobs

    def register_job(self, name: str, nodes: float,
                     stripe_count: Optional[int] = None) -> int:
        """Register a job with its compute-node priority and optionally a
        stripe width; chunks round-robin over the job's stripe set (the same
        placement the fleet simulator's striping policies use)."""
        with self._lock:
            if name in self._jobs:
                return self._jobs[name]
            idx = len(self._jobs)
            if idx >= self._nodes.shape[0]:
                raise ValueError("max_jobs exceeded")
            self._jobs[name] = idx
            self._nodes[idx] = nodes
            self._stripes[idx] = stripe_targets(
                idx, self.n_targets, stripe_count or self._default_stripe)
            return idx

    def stripe_set(self, job: str) -> np.ndarray:
        """The OST indices this job's chunks round-robin over."""
        return self._stripes[self._jobs[job]].copy()

    # ----------------------------------------------------------- control

    def _roll_window(self):
        """Run the decentralized allocation for every target (paper's
        per-OST token allocation) and reset window accounting."""
        state, alloc = fleet_allocate(
            self._state,
            torch.as_tensor(self._demand, device=self.device),
            torch.as_tensor(self._nodes, device=self.device),
            self.capacity,
            u_max=self.u_max,
        )
        self._state = state
        alloc = alloc.cpu().numpy()
        # jobs with no allocation fall back to opportunistic service
        self._budget = np.where(alloc > 0, alloc, np.inf)
        self._demand[:] = 0.0
        self._consumed[:] = 0.0
        self._denied.clear()
        self._window_end = self._time() + self.window_s
        self.windows_run += 1

    def _maybe_roll(self):
        if self._time() >= self._window_end:
            self._roll_window()

    def request(self, job: str, nbytes: int, target: Optional[int] = None):
        """Meter ``nbytes`` of I/O for ``job``; blocks (sleeps) until budget
        admits it.  Striping: chunks round-robin over the job's stripe set
        (deterministic, like the simulator's round_robin policy) unless an
        explicit ``target`` pins them.

        Blocked demand survives window rolls: ``_roll_window`` zeroes the
        demand matrix, so a waiter that observes a roll re-registers its
        pending tokens -- the queue-aware demand signal (DESIGN.md section
        3) must keep seeing the deficit that is throttling the job, or the
        allocator never grants the starved job its boost.
        """
        idx = self._jobs[job]
        tokens = max(1, int(np.ceil(nbytes / RPC_BYTES)))
        with self._lock:
            if target is None:
                stripes = self._stripes[idx]
                t = int(stripes[self._rpc_seq[idx] % stripes.shape[0]])
                self._rpc_seq[idx] += 1
            else:
                t = target % self.n_targets
            self._maybe_roll()
            self._demand[t, idx] += tokens
            seen_window = self.windows_run
        # wait loop sleeps OUTSIDE the lock: one throttled job must not stall
        # other jobs' metering (their budgets are independent token buckets)
        while True:
            with self._lock:
                self._maybe_roll()
                if self.windows_run != seen_window:
                    # a roll wiped the demand we registered while we slept;
                    # the tokens are still pending, so they are still demand
                    self._demand[t, idx] += tokens
                    seen_window = self.windows_run
                if self._consumed[t, idx] + tokens <= self._budget[t, idx]:
                    self._consumed[t, idx] += tokens
                    return t
                wait = max(self._window_end - self._time(), 1e-4)
            self._sleep(wait)

    def try_consume(self, job: str, tokens: float, target: int = 0,
                    request_id=None) -> bool:
        """Non-blocking budget check-and-consume (serving admission).

        A denied request's demand is counted ONCE per window however many
        times the caller retries it: callers that poll admission every
        engine step (``ServingEngine._admit``) pass a stable
        ``request_id`` so each retry is recognized; anonymous callers
        (``request_id=None``) are deduplicated per (job, target, tokens),
        which collapses the same retried request but also same-sized
        distinct ones -- pass an id when that distinction matters.
        """
        idx = self._jobs[job]
        with self._lock:
            self._maybe_roll()
            if self._consumed[target, idx] + tokens > self._budget[target, idx]:
                key = (target, idx,
                       request_id if request_id is not None
                       else ("anon", float(tokens)))
                if key not in self._denied:
                    self._denied.add(key)
                    self._demand[target, idx] += tokens
                elif request_id is None:
                    # anonymous dedup cannot tell a retry from a distinct
                    # same-sized request; a second anonymous denial of the
                    # same size is silently NOT re-counted as demand --
                    # surface that so callers know to pass a request_id
                    logger.debug(
                        "try_consume: anonymous denied request (job=%s, "
                        "target=%d, tokens=%s) deduplicated this window; "
                        "distinct same-sized requests under-report demand "
                        "-- pass request_id to count them separately",
                        job, target, tokens)
                return False
            self._demand[target, idx] += tokens
            self._consumed[target, idx] += tokens
            return True

    def observed_demand(self, job: str) -> np.ndarray:
        """Per-target demand registered for ``job`` in the current window
        (what the next allocation will see as d_x)."""
        idx = self._jobs[job]
        with self._lock:
            self._maybe_roll()
            return self._demand[:, idx].copy()

    def budget_of(self, job: str) -> np.ndarray:
        """Current per-target window budget for a job (inf = fallback)."""
        idx = self._jobs[job]
        with self._lock:
            self._maybe_roll()
            return self._budget[:, idx].copy()

    def records_of(self, job: str) -> np.ndarray:
        idx = self._jobs[job]
        return self._state.record[:, idx].cpu().numpy()
