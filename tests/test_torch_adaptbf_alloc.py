"""The allocation kernel's plain version (``repro_torch`` ``fleet_alloc`` on
CPU tensors) against the reference's in-kernel allocator
``repro.kernels.adaptbf_alloc.kernel._alloc_block``, called eagerly, on the
reference's own kernel fixtures.

The reference is called on every case padded to one shape, with inactive
padding rows and lanes (demand 0), as its own kernel dispatcher pads: such
lanes take no tokens and rank below every real lane, so the real lanes'
result is unchanged, and eager JAX compiles its primitives once instead of
once per shape.  The port runs unpadded.

Tolerance: atol 1e-3, the reference's kernel tolerance
(``tests/test_kernel_adaptbf.py``).  Row sums of non-integer shares reduce
in another order than XLA:CPU, so float remainders may differ by ulps;
allocations must be integer-valued."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_adaptbf import _case

from repro.kernels.adaptbf_alloc import ops as jops
from repro.kernels.adaptbf_alloc.kernel import _alloc_block
from repro_torch.core import AllocatorState, allocate, fleet_allocate
from repro_torch.kernels.adaptbf_alloc import ops as tops

torch.set_num_threads(1)

PAD_O, PAD_J = 24, 320


def _np(args):
    return [np.array(a) for a in args]


def _ref(demand, nodes, record, remainder, alloc_prev, capacity):
    o, j = demand.shape
    padded = [np.pad(x, ((0, PAD_O - o), (0, PAD_J - j)))
              for x in (demand, nodes, record, remainder, alloc_prev)]
    cap = np.pad(capacity, (0, PAD_O - o))[:, None]
    out = _alloc_block(*(jnp.asarray(x) for x in padded), jnp.asarray(cap),
                       64.0)
    return [np.asarray(x)[:o, :j] for x in out]


def _port(*args):
    return [x.numpy() for x in tops.fleet_alloc(
        *(torch.from_numpy(np.array(x)) for x in args))]


def _assert_close(got, want, tag):
    for name, g, w in zip(("alloc", "record", "remainder"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-3, err_msg=f"{tag}/{name}")
    np.testing.assert_array_equal(got[0], np.floor(got[0]),
                                  err_msg=f"{tag}: alloc not integer-valued")


@pytest.mark.parametrize("o,j", [(1, 4), (3, 16), (8, 128), (17, 100),
                                 (5, 256), (2, 300)])
def test_plain_alloc_matches_reference(o, j):
    args = _np(_case(o, j, seed=o * 100 + j))
    _assert_close(_port(*args), _ref(*args), f"o={o} j={j}")


@pytest.mark.parametrize("cap", [1.0, 17.0, 999.0, 100000.0])
def test_capacity_sweep(cap):
    args = _np(_case(4, 64, seed=int(cap) % 97, cap=cap))
    got = _port(*args)
    _assert_close(got, _ref(*args), f"cap={cap}")
    act = args[0] > 0
    for row in range(4):  # conservation on every OST row
        want = cap if act[row].any() else 0.0
        assert got[0][row].astype(np.float64).sum() == pytest.approx(
            want, abs=0.01)


def test_multi_window_evolution():
    """Five windows, each side fed its own previous state: the trajectories
    must stay together step for step."""
    o, j = 4, 32
    demand, nodes, _, rem, prev, cap = _np(_case(o, j, seed=7))
    record = np.zeros((o, j), np.float32)
    port = (record, rem, prev)
    ref = (record, rem, prev)
    rng = np.random.default_rng(3)
    for w in range(5):
        demand = rng.integers(0, 2500, (o, j)).astype(np.float32)
        got = _port(demand, nodes, *port, cap)
        want = _ref(demand, nodes, *ref, cap)
        _assert_close(got, want, f"window {w}")
        port = (got[1], got[2], got[0])
        ref = (want[1], want[2], want[0])


def test_plain_alloc_matches_jitted_oracle():
    """One case against the reference's kernel oracle ``fleet_alloc_ref``
    (the vmapped core allocator, one compile)."""
    args = _np(_case(17, 100, seed=1700))
    want = [np.asarray(x) for x in jops.fleet_alloc_ref(
        *(jnp.asarray(a) for a in args))[:3]]
    _assert_close(_port(*args), want, "fleet_alloc_ref")


def test_single_target_allocate_is_the_row_view():
    """``allocate`` ([J]) is one row of ``fleet_allocate``, bitwise."""
    demand, nodes, record, rem, prev, cap = (
        torch.from_numpy(a) for a in _np(_case(3, 40, seed=5)))
    state = AllocatorState(record, rem, prev)
    fleet, fleet_alloc = fleet_allocate(state, demand, nodes, cap)
    for i in range(3):
        one, alloc = allocate(AllocatorState(record[i], rem[i], prev[i]),
                              demand[i], nodes[i], cap[i])
        assert torch.equal(alloc, fleet_alloc[i])
        for a, b in zip(one, fleet):
            assert torch.equal(a, b[i])


def test_wrapper_rejects_mixed_and_unknown_devices():
    args = [torch.from_numpy(a) for a in _np(_case(2, 8, seed=1))]
    with pytest.raises(ValueError, match="device"):
        tops.fleet_alloc(*args[:5], args[5].to("meta"))
    with pytest.raises(ValueError, match="device"):
        tops.fleet_alloc(*(a.to("meta") for a in args))
