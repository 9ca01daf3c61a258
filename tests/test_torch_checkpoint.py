"""The port's checkpoint manager (``repro_torch.checkpoint``): the
reference's hardening cases (junk-tolerant enumeration, retention, real
exceptions on corrupt or missing restores, the AsyncCheckpointer's
supersede, failed-save, close and snapshot behaviour), tensor leaves
restored in their dtype and onto their device, writes paced through the
port's AdapTBF controller, and the on-disk format shared with the
reference package in both directions."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro_torch import checkpoint
from repro_torch.checkpoint import manager
from repro_torch.pytree import leaves_with_paths
from repro_torch.storage import AdapTBFController


def tiny_state(x=1.0):
    return {"a": np.full((2, 3), x, np.float32),
            "b": {"c": np.arange(4, dtype=np.int32)}}


def wait_until(pred, timeout=30.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(0.005)


class GateController:
    """Stands in for an AdapTBF controller: ``request`` blocks on an event,
    so the test controls exactly when the in-flight save completes."""

    def __init__(self):
        self.gate = threading.Event()

    def request(self, job, nbytes, target=None):
        self.gate.wait(timeout=30)
        return 0


# -------------------------------------------------- junk-tolerant listing


def test_latest_step_ignores_non_checkpoint_entries(tmp_path):
    d = str(tmp_path)
    checkpoint.save_checkpoint(d, tiny_state(), step=3)
    checkpoint.save_checkpoint(d, tiny_state(), step=7)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_latest"))
    os.makedirs(os.path.join(d, "notes"))
    open(os.path.join(d, "step_00000011"), "w").close()   # a file, not a dir
    open(os.path.join(d, "README.md"), "w").close()
    assert checkpoint.latest_step(d) == 7
    assert checkpoint.latest_step(str(tmp_path / "never_made")) is None


def test_gc_keeps_newest_and_skips_junk(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        checkpoint.save_checkpoint(d, tiny_state(), step=s)
    os.makedirs(os.path.join(d, "step_00000099.tmp"))
    open(os.path.join(d, "keep.txt"), "w").close()
    checkpoint.gc_checkpoints(d, keep=2)
    kept = sorted(x for x in os.listdir(d) if manager._STEP_RE.fullmatch(x))
    assert kept == ["step_00000004", "step_00000005"]
    assert os.path.exists(os.path.join(d, "keep.txt"))
    assert os.path.exists(os.path.join(d, "step_00000099.tmp"))
    checkpoint.gc_checkpoints(d, keep=3)          # keep > count keeps all
    assert sorted(s for s, _ in manager._list_steps(d)) == [4, 5]


def test_saving_a_step_again_replaces_it(tmp_path):
    """A replay that restores step k and later saves k again (a service
    re-crossing a fault transition) gets the new state, not an error."""
    d = str(tmp_path)
    checkpoint.save_checkpoint(d, tiny_state(1.0), step=3)
    checkpoint.save_checkpoint(d, tiny_state(2.0), step=3)
    restored, step = checkpoint.restore_checkpoint(d, tiny_state(0.0))
    assert step == 3
    np.testing.assert_array_equal(restored["a"], tiny_state(2.0)["a"])
    assert sorted(os.listdir(d)) == ["step_00000003"]


def test_unpadded_step_dirname_round_trips(tmp_path):
    d = str(tmp_path)
    path = checkpoint.save_checkpoint(d, tiny_state(2.5), step=123)
    os.rename(path, os.path.join(d, "step_123"))
    assert checkpoint.latest_step(d) == 123
    restored, step = checkpoint.restore_checkpoint(d, tiny_state(0.0))
    assert step == 123
    np.testing.assert_array_equal(restored["a"], tiny_state(2.5)["a"])
    checkpoint.gc_checkpoints(d, keep=0)
    assert checkpoint.latest_step(d) is None


# ------------------------------------------- restore raises, never asserts


def test_restore_errors(tmp_path):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        checkpoint.restore_checkpoint(str(tmp_path / "nope"), tiny_state())
    checkpoint.save_checkpoint(d, tiny_state(), step=1)
    with pytest.raises(FileNotFoundError, match="step 5"):
        checkpoint.restore_checkpoint(d, tiny_state(), step=5)
    with pytest.raises(FileNotFoundError, match="step 5"):
        checkpoint.checkpoint_meta(d, step=5)
    renamed = {"a": np.zeros((2, 3), np.float32),
               "b": {"renamed": np.zeros(4, np.int32)}}
    with pytest.raises(ValueError, match="no leaf for pytree path"):
        checkpoint.restore_checkpoint(d, renamed)
    wrong = {"a": np.zeros((4, 4), np.float32),
             "b": {"c": np.zeros(4, np.int32)}}
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_checkpoint(d, wrong)


# --------------------------------------------- tensors, scalars, the format


def test_tensor_leaves_restore_in_their_dtype_and_place(tmp_path):
    d = str(tmp_path)
    state = {"f": torch.tensor([1.5, float("inf")]),
             "i": torch.tensor([[-1, 7]], dtype=torch.int32),
             "n": 12, "t": (torch.zeros(()), ()), "none": None}
    checkpoint.save_checkpoint(d, state, step=4)
    meta = checkpoint.checkpoint_meta(d)
    assert [(m["path"], m["dtype"], m["shape"]) for m in meta["leaves"]] == [
        ("['f']", "float32", [2]), ("['i']", "int32", [1, 2]),
        ("['n']", "int32", []), ("['t'][0]", "float32", [])]
    like = {"f": torch.zeros(2), "i": torch.zeros(1, 2, dtype=torch.int32),
            "n": 0, "t": (torch.ones(()), ()), "none": None}
    got, step = checkpoint.restore_checkpoint(d, like)
    assert step == 4 and got["n"] == 12 and isinstance(got["n"], int)
    assert got["i"].dtype == torch.int32 and got["none"] is None
    torch.testing.assert_close(got["f"], state["f"], rtol=0, atol=0)
    torch.testing.assert_close(got["i"], state["i"], rtol=0, atol=0)
    assert got["t"][1] == ()


def test_paths_are_the_reference_keystr_paths():
    import jax
    tree = {"z": np.zeros(1), "a": {"y": (np.ones(2), np.ones(3))},
            "m": [np.ones(1)]}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert [p for p, _ in leaves_with_paths(tree)] == \
        [jax.tree_util.keystr(p) for p, _ in flat]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_are_interchangeable_with_the_reference(tmp_path, writer):
    d = str(tmp_path)
    src, dst = ((jcheckpoint, checkpoint) if writer == "reference"
                else (checkpoint, jcheckpoint))
    src.save_checkpoint(d, tiny_state(3.25), step=9)
    got, step = dst.restore_checkpoint(d, tiny_state(0.0))
    assert step == 9
    np.testing.assert_array_equal(np.asarray(got["a"]), tiny_state(3.25)["a"])
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]),
                                  tiny_state()["b"]["c"])
    with open(os.path.join(d, "step_00000009", "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"step": 9, "leaves": [
        {"path": "['a']", "file": "leaf_00000.npy", "shape": [2, 3],
         "dtype": "float32"},
        {"path": "['b']['c']", "file": "leaf_00001.npy", "shape": [4],
         "dtype": "int32"}]}


def test_writes_are_paced_through_the_port_controller(tmp_path):
    """A controller on a virtual clock meters the checkpoint's bytes in
    1 MB RPC units for the checkpoint job."""
    now = [0.0]
    ctl = AdapTBFController(n_targets=1, capacity_rpc_per_s=100.0,
                            window_s=0.1, time_fn=lambda: now[0],
                            sleep_fn=lambda s: now.__setitem__(0, now[0] + s),
                            device="cpu")
    ctl.register_job("checkpoint", nodes=1.0)
    big = {"x": np.zeros((3, 1 << 18), np.float32),     # 3 MB: 3 RPCs
           "y": np.zeros(5, np.float32)}                 # 1 RPC at least
    checkpoint.save_checkpoint(str(tmp_path), big, step=1, controller=ctl)
    np.testing.assert_array_equal(ctl.observed_demand("checkpoint"), [4.0])
    got, _ = checkpoint.restore_checkpoint(str(tmp_path), big)
    np.testing.assert_array_equal(got["x"], big["x"])


# ------------------------------------------------------ AsyncCheckpointer


def test_async_default_keep_retains_older_checkpoints(tmp_path):
    ck = checkpoint.AsyncCheckpointer(str(tmp_path))
    try:
        ck.submit(tiny_state(1.0), step=1)
        wait_until(lambda: ck.saved_steps == [1])
        ck.submit(tiny_state(2.0), step=2)
        wait_until(lambda: ck.saved_steps == [1, 2])
    finally:
        ck.close()
    assert sorted(s for s, _ in manager._list_steps(str(tmp_path))) == [1, 2]


def test_async_supersede_drops_older_queued_state(tmp_path):
    gate = GateController()
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), controller=gate,
                                      keep=10)
    try:
        ck.submit(tiny_state(1.0), step=1)    # worker picks up, blocks
        wait_until(lambda: ck._q.empty())     # 1 is in flight
        ck.submit(tiny_state(2.0), step=2)    # queued
        ck.submit(tiny_state(3.0), step=3)    # must replace 2
        gate.gate.set()
        wait_until(lambda: len(ck.saved_steps) == 2)
        assert ck.saved_steps == [1, 3]
        restored, step = checkpoint.restore_checkpoint(
            str(tmp_path), tiny_state(0.0))
        assert step == 3
        np.testing.assert_array_equal(restored["a"], tiny_state(3.0)["a"])
    finally:
        gate.gate.set()
        ck.close()


def test_async_worker_survives_a_failed_save(tmp_path, monkeypatch):
    calls = {"n": 0}
    real_save = manager.save_checkpoint

    def flaky_save(directory, state, step, controller=None, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk full")
        return real_save(directory, state, step, controller, **kw)

    monkeypatch.setattr(manager, "save_checkpoint", flaky_save)
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), keep=10)
    try:
        ck.submit(tiny_state(1.0), step=1)    # this save fails
        wait_until(lambda: len(ck.errors) == 1)
        assert ck._thread.is_alive()
        assert isinstance(ck.errors[0][1], OSError)
        ck.submit(tiny_state(2.0), step=2)
        wait_until(lambda: ck.saved_steps == [2])
        assert checkpoint.latest_step(str(tmp_path)) == 2
    finally:
        ck.close()


def test_async_close_flushes_without_holding_submit_lock(tmp_path):
    gate = GateController()
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), controller=gate,
                                      keep=10)
    ck.submit(tiny_state(1.0), step=1)
    wait_until(lambda: ck._q.empty())
    ck.submit(tiny_state(2.0), step=2)
    closer = threading.Thread(target=ck.close)
    closer.start()
    wait_until(lambda: ck._closed)
    assert ck._submit_lock.acquire(timeout=5), \
        "close() held the submit lock while blocked on the sentinel put"
    ck._submit_lock.release()
    with pytest.raises(RuntimeError, match="close"):
        ck.submit(tiny_state(3.0), step=3)
    gate.gate.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    assert ck.saved_steps == [1, 2]
    ck.close()                               # idempotent


def test_async_submit_snapshots_state(tmp_path):
    """Caller mutations after submit, of arrays and of CPU tensors, must
    not leak into the checkpoint."""
    gate = GateController()
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), controller=gate)
    state = {"a": np.full((2, 3), 5.0, np.float32),
             "t": torch.full((3,), 5.0)}
    try:
        ck.submit(state, step=1)
        state["a"][:] = -1.0
        state["t"].fill_(-1.0)
        gate.gate.set()
        wait_until(lambda: ck.saved_steps == [1])
        restored, _ = checkpoint.restore_checkpoint(
            str(tmp_path), {"a": np.zeros((2, 3), np.float32),
                            "t": torch.zeros(3)})
        np.testing.assert_array_equal(restored["a"], np.full((2, 3), 5.0))
        torch.testing.assert_close(restored["t"], torch.full((3,), 5.0))
    finally:
        gate.gate.set()
        ck.close()
    with pytest.raises(RuntimeError, match="close"):
        ck.submit(tiny_state(), step=2)
