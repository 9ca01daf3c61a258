"""Fault-tolerant checkpointing: atomic commits, async background writes
and AdapTBF-paced I/O.

Layout per checkpoint (the reference package's, byte for byte, so a
checkpoint written by either package restores in the other):
  <dir>/step_<8 digits>.tmp/ ... -> rename to <dir>/step_<8 digits>/  (atomic)
    meta.json          {"step": n, "leaves": [{path, file, shape, dtype}]}
    leaf_<5 digits>.npy  one array per leaf

Leaves are keyed by the reference's pytree path strings, in its flatten
order (``repro_torch.pytree``: ``.queue``, ``.policy_state.record``,
``.stats.comp.served_sum``, ``['a']['b']``).  A restore loads each leaf on
the host and puts it where the matching leaf of ``like`` lives, in its
dtype, or on the device ``shardings`` names for it (the reference's
elastic restore onto another mesh; here a tree of ``torch.device``s).
"""
from __future__ import annotations

import json
import logging
import os
import queue
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.pytree import (_is_namedtuple, leaves_with_paths, to_numpy,
                                unflatten)

logger = logging.getLogger(__name__)

#: Committed checkpoints are exactly ``step_<8 digits>``; anything else in
#: the directory (``.tmp`` staging dirs, editor droppings, user files) is
#: not a checkpoint and must never crash enumeration.
_STEP_RE = re.compile(r"step_(\d+)$")


def _list_steps(directory: str) -> list:
    """Sorted ``(step, dirname)`` of committed checkpoints under
    ``directory``.  Non-matching entries -- ``.tmp`` staging dirs, stray
    files, unparsable names -- are ignored, not errors, and removal /
    restore always act on the *listed* dirname (never a re-derived one, so
    an unpadded ``step_123`` still round-trips)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.fullmatch(d)
        if m and os.path.isdir(os.path.join(directory, d)):
            steps.append((int(m.group(1)), d))
    return sorted(steps)


def _step_dir(directory: str, step: int) -> Optional[str]:
    """Absolute path of the committed checkpoint for ``step``, or None."""
    for s, d in _list_steps(directory):
        if s == step:
            return os.path.join(directory, d)
    return None


def save_checkpoint(directory: str, state: Any, step: int,
                    controller=None, job: str = "checkpoint") -> str:
    """Write atomically; if an AdapTBF controller is given, writes are paced
    in 1 MB-RPC units so checkpoint bursts cannot starve concurrent jobs.
    A step saved again replaces the earlier save of that step."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(leaves_with_paths(state)):
        arr = to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        if controller is not None:
            controller.request(job, arr.nbytes)
        np.save(os.path.join(tmp, fname), arr)
        meta["leaves"].append({"path": path, "file": fname,
                               "shape": list(arr.shape),
                               "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.isdir(final):
        # saving a step again (a replay from an earlier restore) replaces
        # it: a directory rename cannot overwrite a non-empty directory
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return steps[-1][0] if steps else None


def _checkpoint(directory: str, step: Optional[int]):
    """(directory, meta.json contents) of a committed checkpoint (latest
    by default); ``FileNotFoundError`` when there is none."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = _step_dir(directory, step)
    if d is None:
        raise FileNotFoundError(
            f"no checkpoint for step {step} under {directory} "
            f"(have steps {[s for s, _ in _list_steps(directory)]})")
    with open(os.path.join(d, "meta.json")) as f:
        return d, json.load(f)


def checkpoint_meta(directory: str, step: Optional[int] = None) -> dict:
    """The ``meta.json`` of a committed checkpoint (latest by default):
    ``{"step": n, "leaves": [{"path", "file", "shape", "dtype"}, ...]}``.

    Lets callers validate compatibility (shapes, pytree paths) *before*
    paying for the leaf loads -- and turn a would-be cryptic leaf error
    into a config mismatch named up front (``FleetService.restore``).
    Raises ``FileNotFoundError`` like ``restore_checkpoint`` when no
    (matching) checkpoint exists.
    """
    return _checkpoint(directory, step)[1]


def _devices(shardings, like) -> list:
    """``shardings``' device for each leaf of ``like``, in flatten order:
    ``shardings`` is a tree of ``like``'s structure whose leaves are
    ``torch.device``s (or device strings) or ``None`` (keep ``like``'s
    device); a device or ``None`` in place of a subtree covers all of it."""
    if shardings is None or isinstance(shardings, (torch.device, str)):
        return [shardings] * len(leaves_with_paths(like))
    if _is_namedtuple(like) or isinstance(like, (tuple, list)):
        if len(shardings) != len(like):
            raise ValueError("shardings does not have like's structure")
        return [d for s, c in zip(shardings, like) for d in _devices(s, c)]
    if isinstance(like, dict):
        if set(shardings) != set(like):
            raise ValueError("shardings does not have like's structure")
        return [d for k in sorted(like) for d in _devices(shardings[k],
                                                          like[k])]
    raise ValueError(f"shardings has a subtree where like has a leaf: "
                     f"{shardings!r}")


def checkpoint_leaves(directory: str, step: Optional[int] = None):
    """(``{path: numpy array}``, step) of a committed checkpoint (latest by
    default), whatever tree wrote it: e.g. a reference ``TrainState`` for
    ``models.train_state_from_numpy``."""
    d, meta = _checkpoint(directory, step)
    return ({m["path"]: np.load(os.path.join(d, m["file"]))
             for m in meta["leaves"]}, meta["step"])


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf is loaded on the
    host and becomes a tensor on the device and in the dtype of ``like``'s
    leaf there (a numpy array or Python scalar of its type where ``like``
    holds one).  ``shardings`` (a tree of ``like``'s structure of
    ``torch.device``s, or ``None``) puts each tensor leaf on another
    device: the checkpoint is device-agnostic.

    Raises ``FileNotFoundError`` when no (matching) checkpoint exists and
    ``ValueError`` on a structure mismatch between the checkpoint and
    ``like`` (missing leaf path or wrong shape) -- real control-flow
    exceptions callers can catch, never ``assert`` (which ``python -O``
    strips, silently turning a corrupt restore into garbage state).
    """
    d, meta = _checkpoint(directory, step)
    by_path = {m["path"]: m for m in meta["leaves"]}
    out = []
    for (path, leaf), dev in zip(leaves_with_paths(like),
                                 _devices(shardings, like)):
        m = by_path.get(path)
        if m is None:
            raise ValueError(
                f"checkpoint {d} has no leaf for pytree path {path!r} -- "
                "the saved structure does not match `like` (was a carry "
                "field renamed since the save?)")
        arr = np.load(os.path.join(d, m["file"]))
        host = leaf if isinstance(leaf, torch.Tensor) else to_numpy(leaf)
        if list(arr.shape) != list(host.shape):
            raise ValueError(
                f"checkpoint leaf {path!r} has shape {list(arr.shape)} but "
                f"`like` expects {list(host.shape)} (checkpoint {d})")
        out.append(_like_leaf(arr, leaf, host, dev))
    return unflatten(like, out), meta["step"]


def _like_leaf(arr: np.ndarray, leaf, host, device=None):
    """``arr`` as the kind of leaf ``leaf`` is: a tensor on ``device`` (else
    its device) in its dtype, a numpy array of its dtype, or a Python
    scalar of its type (``host``: the leaf, or its numpy form)."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(
            device=leaf.device if device is None else device,
            dtype=leaf.dtype)
    arr = arr.astype(host.dtype)
    if isinstance(leaf, np.ndarray) or arr.ndim:
        return arr
    return type(leaf)(arr.item())


def gc_checkpoints(directory: str, keep: int = 3):
    steps = _list_steps(directory)
    # not steps[:-keep]: for keep=0 that is the empty slice, keeping all;
    # and the stop must clamp at 0 -- with fewer checkpoints than `keep` a
    # negative stop would slice from the END, deleting the very
    # checkpoints retention promises to keep
    for _, d in steps[:max(0, len(steps) - keep)]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpointing so the caller's loop never blocks on
    storage; at most one write in flight, newer requests supersede queued
    ones (straggler-proof).

    "Supersede" means exactly that: when a save is already in flight AND
    one is queued behind it, ``submit`` drops the *queued* (older) state
    and enqueues the new one -- the freshest state always wins.  A failed
    save is logged and recorded in ``self.errors``; the worker survives,
    so one bad write (full disk, transient I/O error) cannot silently
    disable every later checkpoint for the rest of the run.
    """

    def __init__(self, directory: str, controller=None, keep: int = 3):
        self.directory = directory
        self.controller = controller
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._submit_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self.saved_steps = []
        self.errors = []       # [(step, exception)] of failed saves

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            state, step = item
            try:
                save_checkpoint(self.directory, state, step, self.controller)
                gc_checkpoints(self.directory, self.keep)
            except Exception as e:  # noqa: BLE001 -- the worker must survive
                logger.exception(
                    "async checkpoint of step %d failed; worker continues",
                    step)
                self.errors.append((step, e))
                continue
            self.saved_steps.append(step)

    def submit(self, state, step: int):
        """Snapshot ``state`` host-side and queue it for a background save;
        never blocks.  If an older snapshot is still waiting behind an
        in-flight save, it is replaced by this one."""
        # a copy of every leaf: a CPU tensor's or array's numpy view would
        # alias it, and caller mutations after submit would leak into the
        # checkpoint
        state = unflatten(state, [np.array(to_numpy(x))
                                  for _, x in leaves_with_paths(state)])
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("submit after close()")
            while True:
                try:
                    self._q.put_nowait((state, step))
                    return
                except queue.Full:
                    # drop the stale queued snapshot (NOT the new one) and
                    # retry; if the worker grabbed it first the queue is
                    # simply empty and the put succeeds next iteration
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    def close(self):
        """Flush any pending save and stop the worker.  The sentinel is
        enqueued OUTSIDE the submit lock: on a maxsize=1 queue the put can
        block behind an in-flight save, and holding the lock for that long
        would stall concurrent ``submit`` callers for the full save
        duration instead of failing them fast with the closed error."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)
        self._thread.join(timeout=60)
