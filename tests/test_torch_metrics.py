"""The port's metrics (``repro_torch.storage.metrics``): the same numpy code
as the reference's, so on the same inputs every metric and finalizer is
equal to the reference's bitwise; and on the port's own runs the
streaming finalizers agree with the trajectory metrics of the same run
(the tolerances of ``tests/test_streaming_telemetry.py``), on every
registered fleet and single-target scenario and for every built-in
policy.  Plus the reference's unit cases (batched carries, the p99
backlog semantics, all-zero fleets)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.storage import FleetConfig as JConfig
from repro.storage import metrics as jm
from repro.storage import simulate_fleet as jsimulate_fleet
from repro_torch.pytree import leaves_with_paths, unflatten
from repro_torch.storage import (
    FleetConfig,
    SimConfig,
    get_scenario,
    list_fleet_scenarios,
    list_scenarios,
    metrics,
    random_fleet,
    simulate,
    simulate_fleet,
    utilization,
)
from repro_torch.storage import simulator

torch.set_num_threads(1)

O, J, T = 4, 6, 200
SINGLE = sorted(set(list_scenarios()) - set(list_fleet_scenarios()))
POLICIES = ("adaptbf", "static", "nobw", "static_wc", "aimd")


def _args(s):
    return (s.nodes, s.issue_rate, s.volume, s.capacity_per_tick,
            s.max_backlog)


def assert_stream_matches_trajectory(stats, served, demand, nodes, cap_w,
                                     tag=""):
    """The reference's agreement contract: streaming finalizers == the
    trajectory metrics."""
    np.testing.assert_allclose(
        metrics.streaming_aggregate_mb(stats), metrics.aggregate_mb(served),
        rtol=1e-5, err_msg=f"{tag}: aggregate")
    np.testing.assert_allclose(
        metrics.streaming_mean_utilization(stats),
        metrics.mean_utilization(served, cap_w), rtol=1e-5,
        err_msg=f"{tag}: utilization")
    s_j = served.sum(axis=1) if served.ndim == 3 else served
    d_j = demand.sum(axis=1) if demand.ndim == 3 else demand
    np.testing.assert_allclose(
        metrics.streaming_fairness(stats, nodes),
        metrics.fairness(s_j, nodes, d_j), rtol=1e-5, atol=1e-7,
        err_msg=f"{tag}: fairness")
    np.testing.assert_allclose(
        metrics.streaming_job_slowdown(stats, cap_w),
        metrics.job_slowdown(served, cap_w), rtol=1e-5, equal_nan=True,
        err_msg=f"{tag}: slowdown")
    exact = metrics.p99_queue(demand, served)
    approx = metrics.streaming_p99_queue(stats)
    assert approx <= exact * 1.3 + 0.05, f"{tag}: p99 {approx} vs {exact}"
    assert approx >= exact * 0.77 - 0.05, f"{tag}: p99 {approx} vs {exact}"


@pytest.mark.parametrize("name", list_fleet_scenarios())
def test_fleet_streaming_matches_trajectory_every_scenario(name):
    scn = get_scenario(name, duration_s=3.0)
    cfg = FleetConfig(control="adaptbf")
    traj = simulate_fleet(cfg, *_args(scn), device="cpu")
    stream = simulate_fleet(cfg._replace(telemetry="streaming"), *_args(scn),
                            device="cpu")
    cap_w = scn.capacity_per_tick * cfg.window_ticks
    served, demand = traj.served.numpy(), traj.demand.numpy()
    assert int(stream.stats.windows) == served.shape[0]
    assert_stream_matches_trajectory(stream.stats, served, demand, scn.nodes,
                                     cap_w, tag=name)
    torch.testing.assert_close(stream.queue_final, traj.queue_final, rtol=0,
                               atol=0)


@pytest.mark.parametrize("name", SINGLE)
def test_single_target_streaming_matches_trajectory_every_scenario(name):
    scn = get_scenario(name, duration_s=3.0)
    args = (scn.nodes, scn.issue_rate, scn.volume, scn.max_backlog)
    cfg = SimConfig(control="adaptbf")
    traj = simulate(cfg, *args, device="cpu")
    stream = simulate(cfg._replace(telemetry="streaming"), *args,
                      device="cpu")
    cap_w = cfg.capacity_per_tick * cfg.window_ticks
    assert stream.stats.served_sum.ndim == 1
    assert_stream_matches_trajectory(stream.stats, traj.served.numpy(),
                                     traj.demand.numpy(), scn.nodes, cap_w,
                                     tag=name)


@pytest.mark.parametrize("control", POLICIES)
def test_streaming_agrees_for_every_registered_policy(control):
    """The accumulators are policy-agnostic, including nobw's all-infinite
    allocations (masked out of the allocation moments)."""
    scn = get_scenario("fleet_churn", duration_s=2.0)
    cfg = FleetConfig(control=control)
    traj = simulate_fleet(cfg, *_args(scn), device="cpu")
    stream = simulate_fleet(cfg._replace(telemetry="streaming"), *_args(scn),
                            device="cpu")
    cap_w = scn.capacity_per_tick * cfg.window_ticks
    assert_stream_matches_trajectory(stream.stats, traj.served.numpy(),
                                     traj.demand.numpy(), scn.nodes, cap_w,
                                     tag=control)
    alloc_windows = stream.stats.alloc_windows.numpy()
    if control == "nobw":
        assert (alloc_windows == 0).all()
    else:
        alloc = traj.alloc.double().numpy()
        np.testing.assert_allclose(
            stream.stats.alloc_sum.numpy(),
            np.where(np.isfinite(alloc), alloc, 0.0).sum(axis=0),
            rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(alloc_windows,
                                      np.isfinite(alloc).sum(axis=0))


# ------------------------------------- bitwise against the reference's code


@pytest.fixture(scope="module")
def reference_run():
    """A reference fleet run in both telemetry modes (``static``: a quick
    compile), as numpy."""
    s = random_fleet(seed=3, n_ost=O, n_jobs=J, duration_s=T * 0.01)
    args = (jnp.asarray(s.nodes), jnp.asarray(s.issue_rate),
            jnp.asarray(s.volume), jnp.asarray(s.capacity_per_tick))
    traj = jsimulate_fleet(JConfig(control="static"), *args)
    stream = jsimulate_fleet(JConfig(control="static", telemetry="streaming"),
                             *args)
    return {"scenario": s, "served": np.asarray(traj.served),
            "demand": np.asarray(traj.demand), "stats": stream.stats,
            "traj": traj}


def test_trajectory_metrics_equal_reference(reference_run):
    s, served, demand = (reference_run[k]
                         for k in ("scenario", "served", "demand"))
    cap_w = s.capacity_per_tick * 10
    nodes = s.nodes
    cases = [
        ("jain_index", (served.sum((0, 1)),)),
        ("priority_normalized_throughput", (served.sum(1), nodes)),
        ("fairness", (served.sum(1), nodes, demand.sum(1))),
        ("fairness", (served.sum(1), np.broadcast_to(nodes, (O, J)))),
        ("mean_utilization", (served, cap_w)),
        ("mean_utilization", (served.sum(1), cap_w.sum(), False)),
        ("aggregate_mb", (served,)),
        ("p99_queue", (demand, served)),
        ("job_slowdown", (served, cap_w)),
        ("job_slowdown", (served.sum(1), 80.0)),
        ("job_slowdown", (np.stack([served, served[::-1]]),
                          np.stack([cap_w, cap_w * 2]))),
    ]
    for name, args in cases:
        want = getattr(jm, name)(*args)
        got = getattr(metrics, name)(*args)
        np.testing.assert_array_equal(got, want, err_msg=name)
        # tensors in, the same numbers out
        t_args = [torch.from_numpy(np.array(a))
                  if isinstance(a, np.ndarray) else a for a in args]
        np.testing.assert_array_equal(getattr(metrics, name)(*t_args), want,
                                      err_msg=f"{name} (tensors)")
    cfg = FleetConfig()
    want = jm.utilization(reference_run["traj"], cfg, s.capacity_per_tick)
    np.testing.assert_array_equal(
        metrics.utilization(reference_run["traj"], cfg, s.capacity_per_tick),
        want)


def test_streaming_finalizers_equal_reference(reference_run):
    """The port's finalizers on the reference's stats leaves, numpy and as
    port tensors, give the reference finalizers' values bitwise."""
    s, jstats = reference_run["scenario"], reference_run["stats"]
    cap_w = s.capacity_per_tick * 10
    np_stats = unflatten(jstats, [np.asarray(x)
                                  for _, x in leaves_with_paths(jstats)])
    t_stats = unflatten(jstats, [torch.from_numpy(np.array(x))
                                 for _, x in leaves_with_paths(jstats)])
    for stats in (np_stats, t_stats):
        assert metrics.streaming_aggregate_mb(stats) == \
            jm.streaming_aggregate_mb(jstats)
        assert metrics.streaming_fairness(stats, s.nodes) == \
            jm.streaming_fairness(jstats, s.nodes)
        assert metrics.streaming_mean_utilization(stats) == \
            jm.streaming_mean_utilization(jstats)
        assert metrics.streaming_mean_utilization(stats, busy_only=False) \
            == jm.streaming_mean_utilization(jstats, busy_only=False)
        assert metrics.streaming_p99_queue(stats) == \
            jm.streaming_p99_queue(jstats)
        np.testing.assert_array_equal(
            metrics.streaming_job_slowdown(stats, cap_w),
            jm.streaming_job_slowdown(jstats, cap_w))


# ------------------------------------------------------- the reference's units


@pytest.fixture(scope="module")
def fleet_run():
    s = random_fleet(seed=3, n_ost=O, n_jobs=J, duration_s=T * 0.01)
    args = (np.broadcast_to(s.nodes, (O, J)).copy(), s.issue_rate, s.volume)
    traj = simulate_fleet(FleetConfig(), *args,
                          capacity_per_tick=s.capacity_per_tick, device="cpu")
    stream = simulate_fleet(FleetConfig(telemetry="streaming"), *args,
                            capacity_per_tick=s.capacity_per_tick,
                            device="cpu")
    return {"scenario": s, "args": args, "traj": traj, "stream": stream}


def _batched_stats(n):
    """n fleets' stats stacked on a leading axis, and the per-fleet stats."""
    per = []
    for i in range(n):
        s = random_fleet(seed=i, n_ost=O, n_jobs=J, duration_s=T * 0.01)
        per.append((s, simulate_fleet(
            FleetConfig(telemetry="streaming"), s.nodes, s.issue_rate,
            s.volume, s.capacity_per_tick, device="cpu").stats))
    stacked = unflatten(per[0][1], [
        torch.stack(xs) for xs in zip(*(
            [x for _, x in leaves_with_paths(st)] for _, st in per))])
    return stacked, per


def test_streaming_finalizers_batched_equal_per_fleet_loop():
    stats, per = _batched_stats(3)
    nodes = np.stack([s.nodes for s, _ in per])
    cap_w = np.stack([s.capacity_per_tick for s, _ in per]) * 10
    agg = metrics.streaming_aggregate_mb(stats)
    fair = metrics.streaming_fairness(stats, nodes)
    util = metrics.streaming_mean_utilization(stats)
    p99 = metrics.streaming_p99_queue(stats)
    slow = metrics.streaming_job_slowdown(stats, cap_w)
    assert agg.shape == fair.shape == util.shape == p99.shape == (3,)
    assert slow.shape == (3, J)
    for i, (s, st) in enumerate(per):
        assert agg[i] == metrics.streaming_aggregate_mb(st)
        assert fair[i] == metrics.streaming_fairness(st, s.nodes)
        assert util[i] == metrics.streaming_mean_utilization(st)
        assert p99[i] == metrics.streaming_p99_queue(st)
        np.testing.assert_array_equal(
            slow[i], metrics.streaming_job_slowdown(st, cap_w[i]))


def test_p99_queue_is_standing_backlog(fleet_run):
    """The engine's demand signal is served + the queue standing at window
    end, so demand - served IS the carried backlog: pinned against the
    queue of each window prefix run on its own."""
    cfg = FleetConfig()
    s, args, res = fleet_run["scenario"], fleet_run["args"], fleet_run["traj"]
    n_windows = res.served.shape[0]
    lag = res.demand.double().numpy() - res.served.double().numpy()
    for w in (1, n_windows // 2, n_windows):
        prefix = simulate_fleet(cfg, args[0], args[1][: w * cfg.window_ticks],
                                args[2], capacity_per_tick=s.capacity_per_tick,
                                device="cpu")
        np.testing.assert_allclose(lag[w - 1], prefix.queue_final.numpy(),
                                   atol=1e-4, err_msg=f"window {w}")
    assert metrics.p99_queue(res.demand, res.served) == pytest.approx(
        float(np.percentile(np.maximum(lag, 0.0).ravel(), 99)))
    assert metrics.streaming_p99_queue(fleet_run["stream"].stats) >= \
        metrics.p99_queue(res.demand, res.served) - 1e-9


def test_all_zero_fleet_edges():
    zero = np.zeros((8, O, J))
    stats = simulate_fleet(FleetConfig(telemetry="streaming"),
                           np.ones((O, J), np.float32),
                           np.zeros((T, O, J), np.float32),
                           np.full((O, J), np.inf, np.float32),
                           device="cpu").stats
    assert metrics.fairness(zero, np.ones(J), demand_wj=zero) == 1.0
    assert metrics.streaming_fairness(stats, np.ones(J)) == 1.0
    assert metrics.jain_index(np.array([])) == 1.0
    assert metrics.mean_utilization(zero, 100.0, busy_only=True) == 0.0
    assert metrics.streaming_mean_utilization(stats, busy_only=True) == 0.0
    assert np.isnan(metrics.job_slowdown(zero, 100.0)).all()
    assert np.isnan(metrics.streaming_job_slowdown(stats, 100.0)).all()
    # every zero backlog lands in bin 0: the percentile is its upper edge
    assert metrics.streaming_p99_queue(stats) == \
        metrics.telemetry.bin_upper_edge(0)
    assert isinstance(metrics.streaming_aggregate_mb(stats), float)


def test_utilization_single_definition_and_reexport():
    scn = get_scenario("allocation_ivd", duration_s=3.0)
    cfg = SimConfig(control="adaptbf")
    res = simulate(cfg, scn.nodes, scn.issue_rate, scn.volume,
                   scn.max_backlog, device="cpu")
    a = utilization(res, cfg)
    np.testing.assert_array_equal(a, metrics.utilization(res, cfg))
    np.testing.assert_array_equal(a, simulator.utilization(res, cfg))
    assert a.shape == (res.served.shape[0],)
