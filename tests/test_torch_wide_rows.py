"""Rows wider than one thread block (8192 < J <= 65536): the host's cluster
rule, and the port's plain allocation and window service at such widths
against the reference.

On the card the three fleet kernels run a row of J jobs on a thread-block
cluster of ``dispatch.cluster_size(J)`` blocks; the plain versions, which
CPU tensors take, are J-generic.  Here the plain versions at O=2, J=16384
and J=12289 are held against the reference's ``fleet_allocate`` and its
XLA window service (``repro.kernels.fleet_window.ops._serve_window_xla``),
each jitted once at J=16384: the J=12289 rows reach it padded with
inactive lanes (no demand, no queue, no rates, a zero budget), which take
no tokens, rank below every real lane and add nothing to a row sum.

Tolerances, the parity contract: the integer allocation bitwise
(``np.array_equal``); served, queue and volume within 4 float32 ulps
(``rtol=2**-21``, plus ``atol=1e-6`` at zero), since the port's row sums
accumulate in float64 and the reference's in float32, in another order;
record and remainder within atol 1e-3, the reference's kernel tolerance
(``tests/test_kernel_adaptbf.py``): a remainder is x - floor(x) of a share
x of up to 50000 tokens, so it carries the ulps of x (5.7e-6 seen)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptbf as jadaptbf
from repro.core.state import AllocatorState as JState
from repro.kernels.fleet_window.ops import _serve_window_xla
from repro_torch.kernels import dispatch
from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
from repro_torch.kernels.fleet_window import ops as fw_ops

torch.set_num_threads(1)

O, PAD_J, W = 2, 16384, 10
RTOL, ATOL = 2.0**-21, 1e-6


@pytest.mark.parametrize("j,c", [(1, 1), (4096, 1), (8192, 1), (8193, 2),
                                 (16384, 2), (16385, 4), (32768, 4),
                                 (32769, 8), (65536, 8)])
def test_cluster_rule(j, c):
    assert dispatch.cluster_size(j) == c


def test_cluster_rule_raises_past_the_limit():
    assert dispatch.MAX_JOBS == 65536
    with pytest.raises(ValueError, match="65536"):
        dispatch.cluster_size(65537)


def _alloc_inputs(j, seed):
    rng = np.random.default_rng(seed)
    demand = rng.integers(0, 3000, (O, j)).astype(np.float32)
    demand[rng.random((O, j)) < 0.3] = 0.0
    nodes = rng.integers(1, 128, (O, j)).astype(np.float32)
    record = rng.integers(-200, 200, (O, j)).astype(np.float32)
    remainder = (rng.random((O, j)) - 0.5).astype(np.float32)
    prev = rng.integers(0, 500, (O, j)).astype(np.float32)
    cap = np.array([1000.0, 50000.0], np.float32)
    return demand, nodes, record, remainder, prev, cap


@jax.jit
def _ref_alloc(demand, nodes, record, remainder, prev, cap):
    state, alloc = jadaptbf.fleet_allocate(
        JState(record=record, remainder=remainder, alloc_prev=prev),
        demand, nodes, cap, u_max=64.0, integer_tokens=True)
    return alloc, state.record, state.remainder


def _close(got, want, name):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=name)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL,
                               err_msg=name)


@pytest.mark.parametrize("j", [16384, 12289])
def test_plain_alloc_at_wide_rows_matches_reference(j):
    host = _alloc_inputs(j, seed=j)
    padded = [np.pad(x, ((0, 0), (0, PAD_J - j))) for x in host[:5]]
    want = [np.asarray(x)[:, :j] for x in _ref_alloc(
        *(jnp.asarray(x) for x in (*padded, host[5])))]
    got = [x.numpy() for x in alloc_ops.fleet_alloc(
        *(torch.from_numpy(x) for x in host))]
    np.testing.assert_array_equal(got[0], want[0], err_msg="alloc")
    for name, g, w in zip(("record", "remainder"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=name)
    active = host[0] > 0
    assert (got[0][~active] == 0).all()
    np.testing.assert_array_equal(got[0].astype(np.float64).sum(1), host[5])


def _window_inputs(j, seed):
    rng = np.random.default_rng(seed)
    queue = (rng.random((O, j)) * 12).astype(np.float32)
    vol = np.where(rng.random((O, j)) < 0.3, np.inf,
                   rng.integers(0, 200, (O, j))).astype(np.float32)
    budget = np.where(rng.random((O, j)) < 0.5, np.inf,
                      rng.integers(0, 30, (O, j))).astype(np.float32)
    budget[:, ::7] = 0.0
    rates = rng.integers(0, 3, (W, O, j)).astype(np.float32)
    backlog = rng.choice([16.0, 64.0, 256.0], (O, j)).astype(np.float32)
    # one row where the ruled jobs' wants fit (phase 1 unscaled), one where
    # they exceed the capacity; both leave phase 2 some and not all
    cap = np.array([6.0 * j, 2.0 * j], np.float32)
    return queue, vol, budget, rates, backlog, cap


_ref_window = jax.jit(_serve_window_xla)


@pytest.mark.parametrize("j", [16384, 12289])
def test_plain_window_at_wide_rows_matches_reference(j):
    host = _window_inputs(j, seed=j + 1)
    pad = [(0, 0), (0, PAD_J - j)]
    queue, vol, budget, rates, backlog, cap = host
    padded = (np.pad(queue, pad), np.pad(vol, pad), np.pad(budget, pad),
              np.pad(rates, [(0, 0)] + pad), np.pad(backlog, pad))
    want = [np.asarray(x)[:, :j] for x in _ref_window(
        *(jnp.asarray(x) for x in padded), jnp.asarray(cap)[:, None])]
    got = [x.numpy() for x in fw_ops.fleet_window_serve(
        *(torch.from_numpy(x) for x in host))]
    for name, g, w in zip(("queue", "vol_left", "served"), got, want):
        _close(g, w, name)
    served = got[2].astype(np.float64).sum(1)
    assert (served <= cap.astype(np.float64) * W + 1e-3).all()
    assert (served > 0).all()


def test_wrappers_run_the_plain_versions_past_the_limit_on_the_cpu():
    """J = 65537 raises only on the card: CPU tensors take the plain
    versions, and no kernel is launched."""
    j = dispatch.MAX_JOBS + 1
    before = (fw_ops.launches, alloc_ops.launches)
    host = [torch.from_numpy(x) for x in _window_inputs(j, seed=3)]
    host[3] = host[3][:1]                                   # one tick
    queue, _, served = fw_ops.fleet_window_serve(*host)
    assert served.shape == (O, j) and bool(queue.isfinite().all())
    args = [torch.from_numpy(x) for x in _alloc_inputs(j, seed=4)]
    alloc, _, _ = alloc_ops.fleet_alloc(*args)
    assert alloc.shape == (O, j)
    assert (fw_ops.launches, alloc_ops.launches) == before
