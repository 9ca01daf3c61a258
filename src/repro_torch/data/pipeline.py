"""Deterministic synthetic token pipeline, sharded per host, with prefetch
and AdapTBF-metered reads: the reference package's ``data/pipeline.py``
(numpy only), its reads paced by the port's ``storage.AdapTBFController``.

Determinism is the fault-tolerance contract: batch(step) is a pure function
of (seed, step, host), so a restarted/rescaled job replays the exact stream
from its restored step -- no data-state checkpointing needed.  The prefetch
thread absorbs storage-side stragglers (reads are paced by the AdapTBF
controller like any other job).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np


class TokenPipeline:
    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        n_hosts: int = 1,
        host_id: int = 0,
        seed: int = 0,
        controller=None,
        job: str = "data",
        prefetch: int = 2,
    ):
        assert global_batch % n_hosts == 0
        self.vocab, self.seq = vocab, seq_len
        self.host_batch = global_batch // n_hosts
        self.n_hosts, self.host_id, self.seed = n_hosts, host_id, seed
        self.controller = controller
        self.job = job
        if controller is not None:
            controller.register_job(job, nodes=n_hosts)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._cursor = 0
        self._thread: Optional[threading.Thread] = None

    # pure function of (seed, step, host): restart-safe
    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Learnable synthetic stream: each sequence tiles a random 8-token
        motif with 10% uniform-noise corruption.  Next-token prediction is a
        copy task (attend/retain 8 positions back), so cross-entropy has
        ~0.9*ln(V) nats of learnable headroom -- enough signal for smoke-scale
        convergence tests while remaining architecture-agnostic."""
        rng = np.random.default_rng(
            np.random.PCG64(self.seed * 1_000_003 + step * self.n_hosts
                            + self.host_id))
        period = 8
        motif = rng.integers(0, self.vocab, (self.host_batch, period),
                             dtype=np.int64)
        reps = self.seq // period + 2
        tokens = np.tile(motif, (1, reps))[:, : self.seq + 1]
        noise_mask = rng.random((self.host_batch, self.seq + 1)) < 0.10
        noise = rng.integers(0, self.vocab,
                             (self.host_batch, self.seq + 1), dtype=np.int64)
        tokens = np.where(noise_mask, noise, tokens)
        if self.controller is not None:
            self.controller.request(self.job, tokens.nbytes)
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "labels": tokens[:, 1:].astype(np.int32)}

    # ---------------------------------------------------------- prefetch

    def start(self, from_step: int = 0):
        self._cursor = from_step
        self._stop = False

        def worker():
            step = from_step
            while not self._stop:
                try:
                    self._queue.put(self.batch(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            b = self.batch(self._cursor)
            self._cursor += 1
            return b
        return self._queue.get()

    def stop(self):
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
