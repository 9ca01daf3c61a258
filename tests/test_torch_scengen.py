"""The port's copies of the numpy input builders (scengen, striping,
faults) give bitwise the reference's arrays."""
import numpy as np
import pytest

from repro.storage import faults as jfaults
from repro.storage import scengen as jscengen
from repro.storage import striping as jstriping
from repro_torch.storage import faults as tfaults
from repro_torch.storage import scengen as tscengen
from repro_torch.storage import striping as tstriping


def _assert_same(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


@pytest.mark.parametrize("profile", sorted(jscengen.PROFILES))
def test_random_fleet_bitwise(profile):
    assert sorted(tscengen.PROFILES) == sorted(jscengen.PROFILES)
    for seed in (0, 3):
        _assert_same(
            tscengen.random_fleet(seed, n_ost=4, n_jobs=12, profile=profile,
                                  duration_s=3.0),
            jscengen.random_fleet(seed, n_ost=4, n_jobs=12, profile=profile,
                                  duration_s=3.0))


@pytest.mark.parametrize("policy", ["round_robin", "progressive"])
def test_striping_bitwise(policy):
    rng = np.random.default_rng(5)
    issue = rng.integers(0, 30, (120, 7)).astype(np.float32)
    volume = np.where(rng.random(7) < 0.4, np.inf,
                      rng.integers(100, 2000, 7)).astype(np.float32)
    backlog = rng.choice([32.0, 256.0], 7).astype(np.float32)
    _assert_same(tstriping.route(policy, issue, volume, backlog, 5),
                 jstriping.route(policy, issue, volume, backlog, 5))


def test_fault_plans_bitwise():
    _assert_same(tfaults.random_fault_plan(7, 40, 6, mtbf_windows=8,
                                           mttr_windows=3, loss_p=0.2),
                 jfaults.random_fault_plan(7, 40, 6, mtbf_windows=8,
                                           mttr_windows=3, loss_p=0.2))
    _assert_same(tfaults.compose(tfaults.outage(9, 3, 2, 5, osts=[1]),
                                 tfaults.droop(9, 3, 0, 4, 0.3)),
                 jfaults.compose(jfaults.outage(9, 3, 2, 5, osts=[1]),
                                 jfaults.droop(9, 3, 0, 4, 0.3)))
