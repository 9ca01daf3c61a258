"""The port's streaming telemetry (``repro_torch.storage.telemetry``) against
the reference's, on the same seeded numpy window inputs.

* ``update_stats`` over several windows, with and without a fault row, with
  unruled (infinite) allocations: the element-wise Kahan fields, the
  histogram, ``lag_max`` and every int32 counter bitwise; the three row
  sums (``util_sum``, ``lag_sum``, ``lag_sumsq``) reduce over J in another
  order (float64, rounded once), so their compensated estimates (sum plus
  residual) are held at rtol 1e-6.
* ``lag_bin`` itself: the two packages' ``log10`` differ by ulps on about a
  third of float32 values, which moves a value lying within an ulp of a
  bin edge into the neighbouring bin.  Off the edges the bins agree; the
  flips are pinned where found (ROADMAP queue C).
* The checkpoint naming contract, ``init_stats`` and ``squeeze_stats``,
  and the Kahan sums past float32's 2^24 cliff.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_service import EXPECTED_STATS_PATHS

from repro.storage import faults as jfaults
from repro.storage import telemetry as jtel
from repro_torch.pytree import leaves_with_paths
from repro_torch.storage import FaultPlan, SimConfig, StreamResult, simulate
from repro_torch.storage import telemetry as tel

torch.set_num_threads(1)

O, J, N_WIN = 4, 16, 6
ROW_SUMS = ("util_sum", "lag_sum", "lag_sumsq")


def _windows(seed, n=N_WIN):
    """Per-window (served, demand, alloc, cap_w) like the engine's: demand
    is served plus a standing queue; some jobs idle, some unruled, some
    OSTs at zero capacity (down, serving nothing)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cap_w = rng.choice([100.0, 200.0, 0.0], O).astype(np.float32)
        served = (rng.random((O, J)) * 30).astype(np.float32)
        served[rng.random((O, J)) < 0.25] = 0.0
        served[cap_w == 0] = 0.0                 # a down OST serves nothing
        queue = (rng.random((O, J)) * 200).astype(np.float32)
        queue[rng.random((O, J)) < 0.3] = 0.0
        demand = (served + queue).astype(np.float32)
        alloc = rng.integers(0, 60, (O, J)).astype(np.float32)
        alloc[rng.random((O, J)) < 0.3] = np.inf
        out.append((served, demand, alloc, cap_w))
    return out


def _fault_rows(seed, n=N_WIN):
    plan = jfaults.random_fault_plan(seed, n, O, mtbf_windows=3.0,
                                     mttr_windows=2.0, droop_frac=0.5,
                                     loss_p=0.3)
    return [plan.row(w) for w in range(n)]


def _fold_both(windows, rows):
    ref = jtel.init_stats(O, J)
    port = tel.init_stats(O, J)
    for w, (served, demand, alloc, cap_w) in enumerate(windows):
        row = None if rows is None else rows[w]
        ref = jtel.update_stats(
            ref, jnp.asarray(served), jnp.asarray(demand), jnp.asarray(alloc),
            jnp.asarray(cap_w),
            faults_w=None if row is None else jfaults.FaultPlan(
                *(jnp.asarray(x) for x in row)))
        port = tel.update_stats(
            port, torch.from_numpy(served), torch.from_numpy(demand),
            torch.from_numpy(alloc), torch.from_numpy(cap_w),
            faults_w=None if row is None else FaultPlan(
                *(torch.from_numpy(np.asarray(x)) for x in row)))
    return ref, port


@pytest.mark.parametrize("with_faults", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_stats_matches_reference(seed, with_faults):
    windows = _windows(seed)
    rows = _fault_rows(seed) if with_faults else None
    ref, port = _fold_both(windows, rows)
    ref_leaves = [(p, np.asarray(x)) for p, x in leaves_with_paths(ref)]
    port_leaves = [(p, x.numpy()) for p, x in leaves_with_paths(port)]
    assert [p for p, _ in ref_leaves] == [p for p, _ in port_leaves]
    row_sums = {f".{f}" for f in ROW_SUMS} | {f".comp.{f}" for f in ROW_SUMS}
    for (path, want), (_, got) in zip(ref_leaves, port_leaves):
        assert got.dtype == want.dtype, path
        if path not in row_sums:
            np.testing.assert_array_equal(got, want, err_msg=path)
    for f in ROW_SUMS:   # the compensated estimates, sum + residual
        got = (getattr(port, f).double() + getattr(port.comp, f).double())
        want = (np.asarray(getattr(ref, f), np.float64)
                + np.asarray(getattr(ref.comp, f), np.float64))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=f)
    assert int(port.windows) == N_WIN
    assert (port.alloc_windows.numpy() < N_WIN).any()      # inf allocs masked
    if with_faults:
        assert port.down_windows.sum() > 0 and port.obs_lost.sum() > 0
    else:
        assert not port.down_windows.any()


#: values where the reference's and the port's CPU ``log10`` round to
#: different sides of a bin edge (value, reference bin, port bin); the
#: exact (float64) bin is the port's in each case
EDGE_FLIPS = [(np.float32(649.38104), 77, 76), (np.float32(865.96356), 79, 78)]


def test_lag_bin_agrees_with_the_reference_off_bin_edges():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.random(50_000).astype(np.float32) * 1000,
        rng.integers(0, 5000, 50_000).astype(np.float32),
        (10.0 ** (np.arange(-40, 120) / 16)).astype(np.float32),
        np.array([0.0, -1.0, 1.0, 10.0, 100.0, 1e6, 1e7, 1e-2, 1e-3,
                  np.inf, -np.inf, np.nan], np.float32),
    ]).astype(np.float32)
    want = np.asarray(jtel.lag_bin(jnp.asarray(vals)))
    got = tel.lag_bin(torch.from_numpy(vals)).numpy()
    assert got.dtype == np.int32
    exact = ((np.log10(np.maximum(vals.astype(np.float64), 1e-30))
              - tel.LAG_LOG10_LO) / (tel.LAG_LOG10_HI - tel.LAG_LOG10_LO)
             * tel.NBINS)
    flips = np.nonzero(got != want)[0]
    # every disagreement sits within float32 rounding of a bin edge
    off_edge = np.abs(exact[flips] - np.round(exact[flips])) > 1e-4
    assert not off_edge.any(), vals[flips][off_edge]
    assert len(flips) <= 10, len(flips)
    for v, ref_bin, port_bin in EDGE_FLIPS:
        x = np.array([v], np.float32)
        assert int(np.asarray(jtel.lag_bin(jnp.asarray(x)))[0]) == ref_bin
        assert int(tel.lag_bin(torch.from_numpy(x))[0]) == port_bin
        assert int(np.floor(((np.log10(np.float64(v)) + 2.0) / 8.0) * 128)) \
            == port_bin
    # the ends: zeros, negatives and NaN in bin 0, +inf in the last bin
    special = np.array([0.0, -5.0, np.nan, np.inf, 1e9], np.float32)
    np.testing.assert_array_equal(
        tel.lag_bin(torch.from_numpy(special)).numpy(), [0, 0, 0, 127, 127])
    np.testing.assert_array_equal(
        np.asarray(jtel.lag_bin(jnp.asarray(special))), [0, 0, 0, 127, 127])


def test_bin_upper_edge_matches_reference():
    for b in (0, 1, 63, 127):
        assert tel.bin_upper_edge(b) == jtel.bin_upper_edge(b)


def test_stream_stats_leaf_paths_match_reference():
    assert tel.stream_stats_leaf_paths() == jtel.stream_stats_leaf_paths()
    assert tel.stream_stats_leaf_paths() == EXPECTED_STATS_PATHS


def test_init_and_squeeze_stats_match_reference():
    ref, port = jtel.init_stats(3, 5), tel.init_stats(3, 5)
    for (path, a), (_, b) in zip(leaves_with_paths(ref),
                                 leaves_with_paths(port)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=path)
        assert b.numpy().dtype == np.asarray(a).dtype, path
    sq_ref = jtel.squeeze_stats(jtel.init_stats(1, 5))
    sq_port = tel.squeeze_stats(tel.init_stats(1, 5))
    assert [tuple(np.shape(x)) for _, x in leaves_with_paths(sq_ref)] == \
        [tuple(x.shape) for _, x in leaves_with_paths(sq_port)]


def test_single_target_streaming_returns_squeezed_stats():
    rng = np.random.default_rng(4)
    rates = rng.integers(0, 30, (60, 3)).astype(np.float32)
    nodes = np.array([10.0, 20.0, 30.0], np.float32)
    volume = np.full(3, np.inf, np.float32)
    traj = simulate(SimConfig(), nodes, rates, volume, device="cpu")
    res = simulate(SimConfig(telemetry="streaming"), nodes, rates, volume,
                   device="cpu")
    assert isinstance(res, StreamResult)
    assert res.stats.served_sum.shape == (3,)
    assert res.stats.lag_hist.shape == (tel.NBINS,)
    assert int(res.stats.windows) == traj.served.shape[0]
    torch.testing.assert_close(res.stats.served_sum + res.stats.comp.served_sum,
                               traj.served.sum(0), rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(res.queue_final, traj.queue_final, rtol=0,
                               atol=0)


def test_kahan_sums_survive_past_f32_precision_cliff():
    """At long horizons a plain float32 running sum stalls (adding 1.0 to
    2^24 rounds back to 2^24 every time); the compensated accumulators must
    not.  Pre-load the carry at the cliff and fold 2000 unit windows, each
    of which a plain sum would drop."""
    n = 2000
    stats = tel.init_stats(1, 1)
    cliff = 2.0 ** 24
    stats = stats._replace(
        served_sum=torch.full((1, 1), cliff), util_sum=torch.full((1,), cliff),
        windows=torch.tensor(2 ** 24, dtype=torch.int32))
    one, cap = torch.ones(1, 1), torch.ones(1)
    for _ in range(n):
        stats = tel.update_stats(stats, one, one, one, cap)
    assert float(stats.served_sum[0, 0]) + float(
        stats.comp.served_sum[0, 0]) == cliff + n
    assert float(stats.util_sum[0]) + float(stats.comp.util_sum[0]) \
        == cliff + n
    assert int(stats.windows) == 2 ** 24 + n             # int32 exact
    assert stats.windows.dtype == torch.int32
