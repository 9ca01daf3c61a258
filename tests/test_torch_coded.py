"""Coded dispatch (``control="coded"``, ``CodedPolicy``) in the port.

* Inside the port, coded equals direct dispatch of the selected member
  bitwise, window 0 (the ``init_alloc`` cold start) included, under the
  "scan" and "mega" backends, for the default codes
  (``FLEET_CONTROL_CODES``) and a subset with stateful members in other
  positions.
* Against the reference's ``control="coded"`` with the same code: atol
  1e-3 with finite masks equal (row sums reduce in another order).
* ``control_code`` is a host int or a 0-d integer tensor, read once per
  run; ``select_by_code`` keeps the reference's where-chain semantics.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies import select_by_code as jselect_by_code
from repro.storage import FleetConfig as JConfig
from repro.storage import simulate_fleet as jsimulate_fleet
from repro_torch.core import select_by_code
from repro_torch.storage import (
    FLEET_CONTROL_CODES,
    FleetConfig,
    control_codes,
    simulate_fleet,
)

torch.set_num_threads(1)

FIELDS = ("served", "demand", "alloc", "record", "queue_final")
SUBSET = ("aimd", "static_wc", "adaptbf")


def _case(o=4, j=24, t=40, seed=2):
    rng = np.random.default_rng(seed)
    nodes = rng.integers(1, 32, (j,)).astype(np.float32)
    rates = rng.integers(0, 4, (t, o, j)).astype(np.float32)
    vol = np.where(rng.random((o, j)) < 0.5, np.inf,
                   500.0).astype(np.float32)
    caps = rng.integers(5, 25, (o,)).astype(np.float32)
    return nodes, rates, vol, caps


def _assert_equal(a, b, tag):
    for f in FIELDS:
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=0, equal_nan=True, msg=f"{tag}/{f}")


@pytest.mark.parametrize("serve", ["scan", "mega"])
@pytest.mark.parametrize("members", [None, SUBSET])
def test_coded_equals_direct_dispatch_bitwise(serve, members):
    case = _case()
    codes = (FLEET_CONTROL_CODES if members is None
             else control_codes(members))
    extra = {} if members is None else dict(coded_policies=members)
    for name, code in codes.items():
        direct = simulate_fleet(FleetConfig(control=name,
                                            serve_backend=serve),
                                *case, device="cpu")
        coded = simulate_fleet(
            FleetConfig(control="coded", serve_backend=serve, **extra),
            *case, control_code=code, device="cpu")
        _assert_equal(coded, direct, f"{serve}/{name}")
        # window 0 is the cold start: the member's own init_alloc
        torch.testing.assert_close(coded.alloc[0], direct.alloc[0], rtol=0,
                                   atol=0, equal_nan=True)


def test_coded_matches_reference():
    """Port coded against the reference's coded run with the same code
    (its "mega" backend, one compiled program for every code)."""
    case = _case(seed=8)
    cfg = dict(control="coded", serve_backend="mega")
    for code in FLEET_CONTROL_CODES.values():
        got = simulate_fleet(FleetConfig(**cfg), *case, control_code=code,
                             device="cpu")
        want = jsimulate_fleet(JConfig(**cfg), *map(jnp.asarray, case),
                               control_code=jnp.int32(code))
        for f in FIELDS:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                          err_msg=f"code {code}/{f}")
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], atol=1e-3,
                                       err_msg=f"code {code}/{f}")


def test_control_code_forms():
    """An int, a 0-d tensor and a 0-d numpy integer select the same member;
    anything else raises."""
    case = _case(o=2, j=8, t=20)
    cfg = FleetConfig(control="coded")
    base = simulate_fleet(cfg, *case, control_code=1, device="cpu")
    for code in (torch.tensor(1), torch.tensor(1, dtype=torch.int32),
                 np.int32(1)):
        _assert_equal(simulate_fleet(cfg, *case, control_code=code,
                                     device="cpu"), base, repr(code))
    for bad in (torch.tensor([1]), 1.0, torch.tensor(1.0)):
        with pytest.raises(ValueError, match="integer scalar"):
            simulate_fleet(cfg, *case, control_code=bad, device="cpu")


@pytest.mark.parametrize("code", [-1, 0, 1, 2, 3])
def test_select_by_code_matches_reference(code):
    """The where-chain: a code past the members selects the last value,
    for a host int and a tensor code alike."""
    values = [np.full((2, 3), float(i), np.float32) for i in range(3)]
    want = np.asarray(jselect_by_code(jnp.int32(code),
                                      [jnp.asarray(v) for v in values]))
    tv = [torch.from_numpy(v) for v in values]
    np.testing.assert_array_equal(select_by_code(code, tv).numpy(), want)
    np.testing.assert_array_equal(
        select_by_code(torch.tensor(code), tv).numpy(), want)
