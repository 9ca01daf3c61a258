"""The port's scenario registry (``repro_torch.storage.workloads``) against
the reference's: the same names, the same kinds, and for every registered
scenario the same arrays bitwise (both build them in numpy from the same
seeds), plus the registry's error contract."""
import numpy as np
import pytest

from repro.storage import workloads as jw
from repro_torch.storage import workloads as w


def test_registry_lists_the_reference_names():
    assert w.list_scenarios() == jw.list_scenarios()
    assert w.list_fleet_scenarios() == jw.list_fleet_scenarios()


@pytest.mark.parametrize("name", jw.list_scenarios())
def test_every_registered_scenario_matches_reference_bitwise(name):
    want = jw.get_scenario(name)
    got = w.get_scenario(name)
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for field, a, b in zip(want._fields, want, got):
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype, field
            np.testing.assert_array_equal(b, a, err_msg=f"{name}.{field}")
        else:
            assert b == a, f"{name}.{field}"


@pytest.mark.parametrize("kw", [dict(seed=3, n_ost=4, n_jobs=6),
                                dict(seed=7, duration_s=3.0)])
def test_generated_scenarios_take_the_reference_knobs(kw):
    for name in (n for n in jw.list_fleet_scenarios() if "_gen_" in n):
        want, got = jw.get_scenario(name, **kw), w.get_scenario(name, **kw)
        for field, a, b in zip(want._fields, want, got):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=f"{name}.{field}")


def test_trace_helpers_match_reference():
    np.testing.assert_array_equal(w.continuous(50, 3.5, start_tick=7),
                                  jw.continuous(50, 3.5, start_tick=7))
    np.testing.assert_array_equal(w.active_between(50, 2.0, 5, 30),
                                  jw.active_between(50, 2.0, 5, 30))
    np.testing.assert_array_equal(
        w.periodic_bursts(90, 40.0, 25, burst_ticks=3, start_tick=4),
        jw.periodic_bursts(90, 40.0, 25, burst_ticks=3, start_tick=4))


def test_registry_errors_name_the_choices():
    with pytest.raises(ValueError, match="unknown scenario.*allocation_ivd"):
        w.get_scenario("no_such_scenario")
    with pytest.raises(ValueError, match="bad arguments.*signature"):
        w.get_scenario("fleet_churn", n_osts=4)
    with pytest.raises(ValueError, match="annotate its return type"):
        w.register_scenario("unannotated")(lambda: None)
    assert "unannotated" not in w.list_scenarios()


def test_fleet_kind_follows_the_return_annotation():
    @w.register_scenario("zz_custom_fleet")
    def custom(duration_s: float = 1.0) -> w.FleetScenario:
        return w.get_scenario("fleet_churn", duration_s=duration_s)

    try:
        assert "zz_custom_fleet" in w.list_fleet_scenarios()
        assert w.get_scenario("zz_custom_fleet").name == "fleet_churn"
    finally:
        del w.SCENARIOS["zz_custom_fleet"]
