"""Continuous-batching serving engine with AdapTBF admission control.

Request *classes* (e.g. interactive vs batch) are the paper's "jobs": each
class has a priority (compute-node share) and the per-window decode-token
budgets come from the same decentralized allocator that guards storage
bandwidth -- the paper's Section III-E generalization ("adaptive allocation
of shared, finite resources among competing entities").  Admission is gated
by class budget; in-flight slots always advance (no mid-request throttling).

Prefill is *chunked*: an admitted request feeds one prompt token per engine
step into its slot (then switches to generation), so prefill and decode share
one step with per-slot positions.  Every slot is stepped each step, inactive
ones included, as in the reference; the decode cache is updated in place
(the reference donates it to its jitted step).  Weights are cast to the
compute dtype once, when the engine is built.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import models
from repro_torch.models.common import ModelConfig

_ids = itertools.count()

#: Seed token for empty-prompt requests: generation starts from BOS rather
#: than crashing on ``prompt[0]`` (token 0 is the conventional BOS/pad id
#: across the bundled configs).
BOS_TOKEN = 0


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int
    klass: str = "interactive"
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        slots: int = 4,
        max_len: int = 256,
        classes: Optional[Dict[str, float]] = None,
        controller=None,
        compute_dtype=torch.float32,
    ):
        self.cfg = cfg
        self.params = models.cast_params(params, compute_dtype)
        self.device = self.params["embed"].device
        self.slots, self.max_len = slots, max_len
        self.classes = classes or {"interactive": 3.0, "batch": 1.0}
        self.controller = controller
        if controller is not None:
            for name, prio in self.classes.items():
                controller.register_job(f"serve:{name}", nodes=prio)
        self.queues: Dict[str, deque] = {k: deque() for k in self.classes}
        self.active: List[Optional[Request]] = [None] * slots
        self._consumed: List[int] = [0] * slots      # prompt tokens fed
        self.cache = models.init_cache(cfg, slots, max_len,
                                       dtype=compute_dtype,
                                       device=self.device)
        self.pos = np.zeros(slots, np.int32)
        self._next_token = np.zeros(slots, np.int32)
        self._dtype = compute_dtype

        def step_fn(params, cache, tokens, pos):
            logits, cache = models.decode_step(params, cache, cfg, tokens,
                                               pos, dtype=compute_dtype)
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

        self._step = step_fn

    # ------------------------------------------------------------ queueing

    def submit(self, req: Request):
        if req.max_new_tokens < 1 and not req.prompt:
            raise ValueError(
                "a request with an empty prompt must generate at least one "
                f"token (max_new_tokens={req.max_new_tokens})")
        self.queues[req.klass].append(req)

    def _admit(self):
        for klass, q in self.queues.items():
            while q and None in self.active:
                if self.controller is not None:
                    # the stable request id makes a retried head-of-queue
                    # request count its demand once per window, not once
                    # per engine step (AdapTBFController.try_consume)
                    ok = self.controller.try_consume(
                        f"serve:{klass}",
                        q[0].max_new_tokens + len(q[0].prompt),
                        request_id=q[0].id)
                    if not ok:
                        break  # class out of budget this window
                slot = self.active.index(None)
                req = q.popleft()
                self.active[slot] = req
                self._consumed[slot] = 0
                self.pos[slot] = 0
                # empty prompt -> generate from BOS (no prefill phase)
                self._next_token[slot] = (req.prompt[0] if req.prompt
                                          else BOS_TOKEN)

    # ------------------------------------------------------------ stepping

    def step(self) -> List[Request]:
        """One engine step: admit, advance every active slot by one token.
        Returns requests finished this step."""
        self._admit()
        if all(r is None for r in self.active):
            return []
        tokens = torch.as_tensor(self._next_token[:, None], device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        next_tok, self.cache = self._step(self.params, self.cache, tokens, pos)
        next_tok = next_tok.cpu().numpy()

        finished = []
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[i] += 1
            self._consumed[i] += 1
            if self._consumed[i] < len(req.prompt):
                # still prefilling: feed the next prompt token (chunked prefill)
                self._next_token[i] = req.prompt[self._consumed[i]]
                continue
            # generating: the model's prediction becomes the next input
            req.output.append(int(next_tok[i]))
            self._next_token[i] = next_tok[i]
            if (len(req.output) >= req.max_new_tokens
                    or self.pos[i] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                self.active[i] = None
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        import time as _time

        done = []
        for _ in range(max_steps):
            done += self.step()
            idle = all(r is None for r in self.active)
            if idle and not any(self.queues.values()):
                break
            if idle and self.controller is not None:
                # admission-blocked: yield wall time so the next AdapTBF
                # budget window can open instead of burning the step budget
                _time.sleep(self.controller.window_s / 5)
        return done
