"""The window-service kernel's plain version (``repro_torch``
``fleet_window_serve`` on CPU tensors) against the reference's oracle
``repro.kernels.fleet_window.ref.fleet_window_ref`` on the reference's own
kernel fixtures, the all-ruled and all-unruled extremes included.

Tolerance: finite masks identical and finite values within atol 1e-4, the
reference's kernel tolerance (``tests/test_kernel_fleet_window.py``): row
sums reduce in another order (float64 here, float32 in XLA), so served
values differ by ulps.

The kernel's own tick (``ref.serve_tick_model``: the second row sum, sum(s1),
taken only where phase 1 overflows the capacity while an unruled job waits)
is held bitwise against the port's ``_serve_tick`` and its window against
``fleet_window_ref``, over rows with every lane ruled or unruled, budgets of
+inf and 0, a capacity equal to phase 1's wants, a capacity of 0, and
backlog caps below the queue; and against the reference's ``_serve_tick``
at the tolerance above."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_fleet_window import _assert_matches, _case

from repro.kernels.fleet_window import ops as jops
from repro.storage.simulator import _serve_tick as jtick
from repro_torch.kernels.fleet_window import ops as tops
from repro_torch.kernels.fleet_window import ref as tref
from repro_torch.kernels.numerics import row_sum
from repro_torch.storage.simulator import _serve_tick as ttick

torch.set_num_threads(1)


def _both(args):
    want = jops.fleet_window_ref(*args)
    got = tops.fleet_window_serve(*(torch.from_numpy(np.array(a))
                                    for a in args))
    _assert_matches([g.numpy() for g in got], want)
    return got


@pytest.mark.parametrize("o,j,w", [(1, 4, 1), (3, 16, 10), (8, 128, 10),
                                   (17, 100, 7), (5, 300, 10)])
def test_plain_window_matches_reference(o, j, w):
    _both(_case(o, j, w, seed=o * 1000 + j + w))


@pytest.mark.parametrize("unruled_frac", [0.0, 1.0])
def test_all_ruled_and_all_unruled_extremes(unruled_frac):
    args = _case(4, 64, 10, seed=int(unruled_frac * 7) + 2,
                 unruled_frac=unruled_frac)
    _, _, served = _both(args)
    cap = np.asarray(args[5], np.float64)
    assert (served.double().sum(-1).numpy() <= cap * 10 + 1e-3).all()


def test_wrapper_rejects_mixed_devices():
    args = [torch.from_numpy(np.array(a)) for a in _case(2, 8, 2, seed=1)]
    with pytest.raises(ValueError, match="device"):
        tops.fleet_window_serve(*args[:5], args[5].to("meta"))


# ------------------------------------------------- the kernel's tick model

TICK_ROWS, TICK_J = 6, 37
TICK_CASES = ["mixed", "all_ruled", "all_unruled", "inf_and_zero_budgets",
              "capacity_equals_wants", "capacity_zero", "overflow",
              "backlog_below_queue"]


def _tick_case(kind, seed):
    """One tick's inputs ([R, J] rows, capacity [R, 1]) of a kind: ``mixed``
    (half the lanes unruled, a 0 budget every 7th lane, backlog caps below
    the queue every 5th, capacities that some rows' phase 1 overflows), and
    variants with every lane ruled or unruled, budgets of only +inf and 0,
    the capacity equal to phase 1's wants (scale1 exactly 1, nothing
    spare), a capacity of 0, a capacity every row's phase 1 overflows, and
    every backlog cap below the queue (nothing issued)."""
    rng = np.random.default_rng(seed)
    shape = (TICK_ROWS, TICK_J)
    queue = (rng.random(shape) * 12).astype(np.float32)
    vol = np.where(rng.random(shape) < 0.3, np.inf,
                   rng.integers(0, 200, shape)).astype(np.float32)
    unruled = {"all_ruled": 0.0, "all_unruled": 1.0}.get(kind, 0.5)
    budget = np.where(rng.random(shape) < unruled, np.inf,
                      rng.integers(0, 30, shape)).astype(np.float32)
    budget[:, ::7] = 0.0 if kind != "all_unruled" else np.inf
    if kind == "inf_and_zero_budgets":
        budget = np.where(rng.random(shape) < 0.5, np.inf, 0.0).astype(
            np.float32)
    rate = rng.integers(0, 3, shape).astype(np.float32)
    backlog = rng.choice([16.0, 64.0, 256.0], shape).astype(np.float32)
    backlog[:, ::5] = queue[:, ::5] * 0.5
    if kind == "backlog_below_queue":
        backlog = queue * 0.5
    cap = rng.integers(4, 40, (TICK_ROWS, 1)).astype(np.float32)
    cap[::3] = 1000.0                     # rows that phase 1 fits
    if kind == "capacity_zero":
        cap[:] = 0.0
    if kind == "overflow":
        cap[:] = 0.5
    args = [torch.from_numpy(x) for x in
            (queue, vol, budget, rate, backlog, cap)]
    if kind == "capacity_equals_wants":
        # phase 1's wants after this tick's issue, rounded as the tick does
        issued = ttick(*args)[4]
        queue_t = torch.clamp_min(args[0] + issued, 0.0)
        want1 = torch.where(torch.isfinite(args[2]), torch.minimum(
            queue_t, torch.clamp_min(args[2], 0.0)), 0.0)
        args[5] = row_sum(want1)
    return args


@pytest.mark.parametrize("kind", TICK_CASES)
def test_tick_model_bitwise_the_plain_tick(kind):
    """Every output of the kernel's tick model equals ``_serve_tick``'s bit
    for bit (finite and not), in every kind of row; the kinds where sum(s1)
    is known form it in no row."""
    args = _tick_case(kind, seed=TICK_CASES.index(kind) + 5)
    *got, formed = tref.serve_tick_model(*args)
    want = ttick(*args)
    for name, g, w in zip(("queue", "vol_left", "budget", "served",
                           "issued"), got, want, strict=True):
        assert g.dtype == w.dtype == torch.float32, name
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    if kind in ("all_ruled", "all_unruled", "capacity_equals_wants"):
        assert not bool(formed.any()), kind
    if kind in ("overflow", "capacity_zero"):
        assert bool(formed.any()), kind


def test_tick_model_takes_both_paths():
    """The mixed rows hold rows that form sum(s1) and rows that skip it
    (phase 1 fits, or nothing unruled waits)."""
    *_, formed = tref.serve_tick_model(*_tick_case("mixed", seed=5))
    assert bool(formed.any()) and not bool(formed.all())


@pytest.mark.parametrize("kind", TICK_CASES)
def test_tick_model_matches_reference_tick(kind):
    """The kernel's tick model against the reference's ``_serve_tick`` at
    the kernel tolerance (the reference sums rows in float32)."""
    args = _tick_case(kind, seed=TICK_CASES.index(kind) + 5)
    *got, _ = tref.serve_tick_model(*args)
    want = jtick(*(jnp.asarray(a.numpy()) for a in args))
    for name, g, w in zip(("queue", "vol_left", "budget", "served",
                           "issued"), got, want, strict=True):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=name)
        fin = np.isfinite(g)
        np.testing.assert_allclose(g[fin], w[fin], atol=1e-4, err_msg=name)


@pytest.mark.parametrize("o,j,w", [(4, 8, 10), (9, 37, 10), (17, 100, 7)])
def test_window_model_bitwise_the_plain_window(o, j, w):
    """A window of the kernel's ticks equals ``fleet_window_ref`` bit for
    bit on the reference's fixtures, +inf and 0 budgets and backlog caps
    below the queue on some lanes, capacities scaled so that some
    row-ticks form sum(s1) and others skip it."""
    args = [torch.from_numpy(np.array(a)) for a in
            _case(o, j, w, seed=o * 7 + j)]
    args[2][:, ::7] = 0.0
    args[4][:, ::5] = args[0][:, ::5] * 0.5
    args[5] = args[5] * torch.where(torch.arange(o) % 2 == 0, 1.0, 20.0)
    (q, v, s), formed = tref.fleet_window_model(*args)
    want = tref.fleet_window_ref(*args)
    for g, x in zip((q, v, s), want, strict=True):
        assert torch.equal(g.view(torch.int32), x.view(torch.int32))
    assert formed.shape == (w, o)
    assert bool(formed.any()) and not bool(formed.all())
