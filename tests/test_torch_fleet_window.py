"""The window-service kernel's plain version (``repro_torch``
``fleet_window_serve`` on CPU tensors) against the reference's oracle
``repro.kernels.fleet_window.ref.fleet_window_ref`` on the reference's own
kernel fixtures, the all-ruled and all-unruled extremes included.

Tolerance: finite masks identical and finite values within atol 1e-4, the
reference's kernel tolerance (``tests/test_kernel_fleet_window.py``): row
sums reduce in another order (float64 here, float32 in XLA), so served
values differ by ulps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_fleet_window import _assert_matches, _case

from repro.kernels.fleet_window import ops as jops
from repro_torch.kernels.fleet_window import ops as tops

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
