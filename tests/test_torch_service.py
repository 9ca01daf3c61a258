"""The port's online fleet controller (``repro_torch.storage.FleetService``)
on the CPU.

* Its own oracle, bitwise: streaming N windows through ``step`` equals one
  offline ``simulate_fleet`` run, for every built-in policy in both
  telemetry modes, coded dispatch and tiled horizons, and across a save ->
  kill -> restore at a mid-horizon window and inside an outage.
* The production round: ingest retry with backoff, the loss-mask
  degradation and the deadline watchdog on an injected clock.
* Restore validation, the checkpoint path contract, dtypes (int32
  counters, ``inf`` allocations) through the npy round trip.
* Against the reference package: a checkpoint written by its
  ``FleetService`` at window k restores into the port's and continues
  within the closed-loop tolerance of ``tests/test_torch_simulator.py``
  (unruled masks equal, values atol 1e-3), and the reverse;
  both write the same ``meta.json`` leaf list, and ``carry_from_numpy``
  keeps the reference carry's int32 leaves int32.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from test_service import EXPECTED_STATS_PATHS, small_fleet

from repro.storage import FleetConfig as JConfig
from repro.storage import FleetService as JService
from repro_torch.pytree import leaves_with_paths
from repro_torch.storage import (
    FLEET_CONTROL_CODES,
    FleetConfig,
    FleetService,
    StreamResult,
    carry_from_numpy,
    carry_to_numpy,
    faults,
    list_policies,
    simulate_fleet,
)
from repro_torch.storage.faults import lost_telemetry_row

torch.set_num_threads(1)

W, O, J, WT = 12, 4, 8, 10   # windows, OSTs, jobs, ticks per window
MODES = ("trajectory", "streaming")
FIELDS = ("served", "demand", "alloc", "record")


def _service(cfg, fleet, **kw):
    nodes, _rates, volume, cap, backlog = fleet
    return FleetService(cfg, nodes, volume, cap, backlog, device="cpu", **kw)


def _window(rates, w):
    return rates[w * WT:(w + 1) * WT]


def assert_same_stats(a, b):
    pa, pb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype, path
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                   msg=path)


def assert_results_bitwise(offline, online):
    if isinstance(offline, StreamResult):
        assert_same_stats(offline.stats, online.stats)
    else:
        for f in FIELDS:
            torch.testing.assert_close(getattr(online, f), getattr(offline, f),
                                       rtol=0, atol=0, msg=f)
    torch.testing.assert_close(online.queue_final, offline.queue_final,
                               rtol=0, atol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", list_policies())
def test_online_matches_offline_bitwise(policy, mode):
    fleet = small_fleet()
    nodes, rates, volume, cap, backlog = fleet
    cfg = FleetConfig(control=policy, telemetry=mode)
    offline = simulate_fleet(cfg, nodes, rates, volume, cap, backlog,
                             device="cpu")
    svc = _service(cfg, fleet)
    online = svc.run(rates)
    assert svc.window == W
    assert_results_bitwise(offline, online)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", list_policies())
def test_resume_from_mid_horizon_checkpoint_is_bitwise(policy, mode,
                                                       tmp_path):
    k = 7
    fleet = small_fleet(seed=1)
    nodes, rates, volume, cap, backlog = fleet
    cfg = FleetConfig(control=policy, telemetry=mode)
    offline = simulate_fleet(cfg, nodes, rates, volume, cap, backlog,
                             device="cpu")
    svc = _service(cfg, fleet, checkpoint_dir=str(tmp_path))
    outs = [svc.step(_window(rates, w)) for w in range(k)]
    svc.save()
    del svc                                            # "crash"
    svc2 = _service(cfg, fleet, checkpoint_dir=str(tmp_path))
    assert svc2.restore() == k and svc2.window == k
    outs += [svc2.step(_window(rates, w)) for w in range(k, W)]
    if mode == "trajectory":
        for i, f in enumerate(FIELDS):
            torch.testing.assert_close(torch.stack([o[i] for o in outs]),
                                       getattr(offline, f), rtol=0, atol=0,
                                       msg=f)
    else:
        assert all(o is None for o in outs)
        assert_same_stats(offline.stats, svc2.stats)
    torch.testing.assert_close(svc2.queue, offline.queue_final, rtol=0,
                               atol=0)


def test_online_coded_dispatch_matches_offline():
    fleet = small_fleet(seed=2)
    nodes, rates, volume, cap, backlog = fleet
    cfg = FleetConfig(control="coded", telemetry="streaming")
    for code in FLEET_CONTROL_CODES.values():
        offline = simulate_fleet(cfg, nodes, rates, volume, cap, backlog,
                                 control_code=code, device="cpu")
        online = _service(cfg, fleet, control_code=code).run(rates)
        assert_results_bitwise(offline, online)


def test_online_tiled_horizon_matches_offline():
    n_windows = 2 * W + 3
    fleet = small_fleet(seed=3)
    nodes, rates, volume, cap, backlog = fleet
    cfg = FleetConfig(control="adaptbf", telemetry="streaming")
    offline = simulate_fleet(cfg, nodes, rates, volume, cap, backlog,
                             n_windows=n_windows, device="cpu")
    online = _service(cfg, fleet).run(rates, n_windows=n_windows)
    assert int(online.stats.windows) == n_windows
    assert_results_bitwise(offline, online)


def test_budget_and_alloc_views():
    fleet = small_fleet()
    svc = _service(FleetConfig(control="adaptbf"), fleet)
    assert svc.window == 0
    assert torch.isinf(svc.budget).all()               # cold start: no rules
    for w in range(3):
        svc.step(_window(fleet[1], w))
    assert torch.isfinite(svc.budget).any()            # rules installed
    assert (svc.queue >= 0).all() and svc.alloc.shape == (O, J)
    assert svc.stats is None


# ----------------------------------------------- save, kill, restore, faults


def test_save_kill_restore_inside_an_outage_is_bitwise(tmp_path):
    """OSTs 1 and 2 go down for windows [3, 9); the service checkpoints
    itself on the way in (window 3), is saved again at window 6 inside
    the outage, killed, restored and run on: equal to the offline run
    with the same plan, bitwise."""
    fleet = small_fleet(seed=4)
    nodes, rates, volume, cap, backlog = fleet
    plan = faults.outage(W, O, 3, 9, osts=[1, 2])
    cfg = FleetConfig(control="adaptbf", telemetry="streaming")
    offline = simulate_fleet(cfg, nodes, rates, volume, cap, backlog,
                             fault_plan=plan, device="cpu")
    svc = _service(cfg, fleet, checkpoint_dir=str(tmp_path), fault_plan=plan)
    for w in range(6):
        svc.step(_window(rates, w))
    from repro_torch import checkpoint
    assert checkpoint.latest_step(str(tmp_path)) == 3   # the fault trigger
    svc.save()
    del svc
    svc2 = _service(cfg, fleet, checkpoint_dir=str(tmp_path), fault_plan=plan)
    assert svc2.restore() == 6
    saves = []
    svc2.save = lambda *a: saves.append(a)   # restored inside the outage:
    for w in range(6, W):                     # no new down transition
        svc2.step(_window(rates, w))
    assert saves == []
    assert_same_stats(offline.stats, svc2.stats)
    torch.testing.assert_close(svc2.queue, offline.queue_final, rtol=0,
                               atol=0)
    assert svc2.stats.down_windows.tolist() == [0, 6, 6, 0]
    # replaying from the trigger's checkpoint gives the same run
    svc3 = _service(cfg, fleet, checkpoint_dir=str(tmp_path), fault_plan=plan)
    assert svc3.restore(step=3) == 3
    for w in range(3, W):
        svc3.step(_window(rates, w))
    assert_same_stats(offline.stats, svc3.stats)


def test_checkpoint_roundtrip_preserves_inf_and_int_leaves(tmp_path):
    fleet = small_fleet()
    cfg = FleetConfig(control="adaptbf", telemetry="streaming")
    svc = _service(cfg, fleet, checkpoint_dir=str(tmp_path))
    svc.step(_window(fleet[1], 0))
    svc.save()
    svc2 = _service(cfg, fleet, checkpoint_dir=str(tmp_path))
    svc2.restore()
    before, after = leaves_with_paths(svc.carry), leaves_with_paths(svc2.carry)
    assert [p for p, _ in before] == [p for p, _ in after]
    for (path, a), (_, b) in zip(before, after):
        if isinstance(a, int):
            assert isinstance(b, int) and a == b, path
            continue
        assert a.dtype == b.dtype, path
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=path)
    assert torch.isinf(svc2.carry.vol_left).any()
    assert svc2.carry.stats.last_served.dtype == torch.int32
    assert svc2.carry.stats.windows.dtype == torch.int32


def test_carry_checkpoint_paths_are_the_reference_paths():
    svc = _service(FleetConfig(control="adaptbf", telemetry="streaming"),
                   small_fleet())
    paths = tuple(p for p, _ in leaves_with_paths(svc.carry))
    prefix = (".window", ".queue", ".vol_left", ".policy_state.record",
              ".policy_state.remainder", ".policy_state.alloc_prev", ".alloc")
    suffix = (".held.served", ".held.demand", ".held.alloc")
    assert paths == prefix + tuple(
        ".stats" + p for p in EXPECTED_STATS_PATHS) + suffix


# ---------------------------------------------------- production ingest


def test_ingest_retries_with_backoff_then_delivers():
    fleet = small_fleet()
    cfg = FleetConfig(control="adaptbf")
    svc, twin = _service(cfg, fleet), _service(cfg, fleet)
    calls, delays = [], []

    def fetch():
        calls.append(1)
        if len(calls) < 3:
            raise TimeoutError("stats RPC dropped")
        return _window(fleet[1], 0)

    res = svc.ingest(fetch, backoff_s=0.05, sleep=delays.append)
    assert res.delivered and res.attempts == 3
    assert delays == [0.05, 0.1]
    assert svc.retry_count == 2 and svc.lost_windows == 0
    for a, b in zip(res.out, twin.step(_window(fleet[1], 0))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ingest_failure_degrades_through_loss_mask():
    fleet = small_fleet()
    cfg = FleetConfig(control="adaptbf", telemetry="streaming")
    svc, twin = _service(cfg, fleet), _service(cfg, fleet)
    svc.step(_window(fleet[1], 0))
    twin.step(_window(fleet[1], 0))
    res = svc.ingest(lambda: None, retries=2, sleep=lambda _: None)
    assert not res.delivered and res.attempts == 3
    assert svc.lost_windows == 1 and svc.window == 2
    twin.step(np.zeros((WT, O, J), np.float32),
              faults_w=lost_telemetry_row(O))
    for (path, a), (_, b) in zip(leaves_with_paths(svc.carry),
                                 leaves_with_paths(twin.carry)):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=path)
    assert int(svc.stats.obs_lost.sum()) == O


def test_ingest_watchdog_cuts_retries_at_deadline():
    svc = _service(FleetConfig(), small_fleet())
    t = iter(np.arange(0.0, 100.0, 1.0))
    res = svc.ingest(lambda: None, retries=50, deadline_s=0.5,
                     sleep=lambda _: None, clock=lambda: next(t))
    assert not res.delivered and res.attempts == 1
    assert svc.lost_windows == 1


# ------------------------------------------- restore compatibility checks


def _saved(tmp_path, cfg, fleet):
    svc = _service(cfg, fleet, checkpoint_dir=str(tmp_path))
    svc.step(_window(fleet[1], 0))
    svc.save()
    return svc


@pytest.mark.parametrize("saved,live,match", [
    (dict(control="adaptbf"), dict(control="adaptbf", shrink=True),
     rf"\({O}, {J}\).*\({O - 1}, {J}\)"),
    (dict(control="adaptbf", telemetry="streaming"), dict(control="adaptbf"),
     "telemetry='streaming'.*telemetry='trajectory'"),
    (dict(control="adaptbf"), dict(control="aimd"),
     "different control policy"),
])
def test_restore_validation_names_the_mismatch(tmp_path, saved, live, match):
    fleet = small_fleet()
    _saved(tmp_path, FleetConfig(**saved), fleet)
    nodes, _, volume, cap, backlog = fleet
    n = O - 1 if live.pop("shrink", False) else O
    other = FleetService(FleetConfig(**live), nodes, volume[:n], cap[:n],
                         backlog[:n], checkpoint_dir=str(tmp_path),
                         device="cpu")
    with pytest.raises(ValueError, match=match):
        other.restore()


def test_guard_rails():
    fleet = small_fleet()
    nodes, rates, volume, cap, backlog = fleet
    with pytest.raises(ValueError, match="partition"):
        FleetService(FleetConfig(partition="ost_shard"), nodes, volume, cap,
                     backlog, device="cpu")
    svc = _service(FleetConfig(), fleet)
    with pytest.raises(ValueError, match="window_ticks"):
        svc.step(rates[: WT - 1])
    with pytest.raises(ValueError, match="checkpoint_dir"):
        svc.save()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        svc.restore()


@pytest.mark.parametrize("partition", ["ost_shard", "fleet_shard"])
def test_service_refuses_a_partition_with_the_reference_message(partition):
    """The online loop is one process: ``simulate_fleet`` runs the sharded
    layouts, and the service names it in the reference's words."""
    nodes, _, volume, cap, backlog = small_fleet()
    with pytest.raises(ValueError) as want:
        JService(JConfig(partition=partition), nodes, volume, cap, backlog)
    with pytest.raises(ValueError) as got:
        FleetService(FleetConfig(partition=partition), nodes, volume, cap,
                     backlog, device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------- checkpoints across the two packages


def _closed_loop_close(got, want, tag):
    """The closed-loop tolerance of ``tests/test_torch_simulator.py``:
    unruled masks equal, finite values within atol 1e-3."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=tag)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-3, err_msg=tag)


@pytest.mark.parametrize("mode,policy", [("streaming", "adaptbf"),
                                         ("trajectory", "static_wc")])
def test_checkpoints_cross_between_the_packages(mode, policy, tmp_path):
    """Both services run k windows and save.  The port restores the
    reference's checkpoint and runs on; the reference restores the port's
    and runs on; each continuation stays within the closed-loop tolerance
    of the reference's uninterrupted run.  (The reference's adaptbf step
    takes ~9 s to compile, so trajectory mode runs static_wc.)"""
    k = 6
    fleet = small_fleet()
    nodes, rates, volume, cap, backlog = fleet
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsvc = JService(JConfig(control=policy, telemetry=mode), nodes,
                    volume, cap, backlog, checkpoint_dir=jdir)
    psvc = _service(FleetConfig(control=policy, telemetry=mode), fleet,
                    checkpoint_dir=pdir)
    for w in range(k):
        jsvc.step(_window(rates, w))
        psvc.step(_window(rates, w))
    jsvc.save()
    psvc.save()
    jcarry_k = jsvc.carry
    metas = []
    for d in (jdir, pdir):
        with open(os.path.join(d, f"step_{k:08d}", "meta.json")) as f:
            metas.append([(m["path"], m["shape"], m["dtype"])
                          for m in json.load(f)["leaves"]])
    assert metas[0] == metas[1]

    want = [jsvc.step(_window(rates, w)) for w in range(k, W)]
    want_carry = jsvc.carry
    port = _service(FleetConfig(control=policy, telemetry=mode), fleet,
                    checkpoint_dir=jdir)
    assert port.restore() == k
    # the same carry handed over in memory: carry_from_numpy keeps the
    # int32 leaves int32 and round-trips the reference's paths and order
    flat, _ = jax.tree_util.tree_flatten_with_path(jcarry_k)
    leaves = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    carry = carry_from_numpy(leaves, device="cpu")
    back = carry_to_numpy(carry)
    assert list(back) == list(leaves)
    for (key, x), (_, y) in zip(back.items(), carry_to_numpy(
            port.carry).items()):
        assert x.dtype == leaves[key].dtype == y.dtype, key
        np.testing.assert_array_equal(x, leaves[key], err_msg=key)
        np.testing.assert_array_equal(y, leaves[key], err_msg=key)
    got = [port.step(_window(rates, w)) for w in range(k, W)]
    jsvc.checkpoint_dir = pdir                   # the reverse direction
    assert jsvc.restore() == k
    back = [jsvc.step(_window(rates, w)) for w in range(k, W)]
    if mode == "trajectory":
        for w, (g, b, r) in enumerate(zip(got, back, want)):
            for i, f in enumerate(FIELDS):
                _closed_loop_close(g[i], r[i], f"port w{k + w} {f}")
                _closed_loop_close(torch.from_numpy(np.array(b[i])), r[i],
                                   f"reference w{k + w} {f}")
    else:
        for carry, tag in ((port.carry, "port"), (jsvc.carry, "reference")):
            for (path, x), (_, y) in zip(leaves_with_paths(carry.stats),
                                         leaves_with_paths(want_carry.stats)):
                x = x if isinstance(x, torch.Tensor) else \
                    torch.from_numpy(np.array(x))
                if x.dtype == torch.int32:
                    np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                                  err_msg=f"{tag}{path}")
                elif ".comp." not in path:
                    np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                               rtol=1e-5, atol=1e-3,
                                               err_msg=f"{tag}{path}")
    _closed_loop_close(port.queue, want_carry.queue, "queue")
