"""The port's ``AdapTBFController`` against the reference's on a virtual
clock: the same calls give the same targets, budgets, records, observed
demand and window count, including the denied-once demand rule (a denied
request retried with the same id counts its demand once per window) and
the demand a blocked ``request`` waiter re-registers after a roll.

The port's allocator sums rows in float64 and rounds once; the budgets are
integer token counts here and compare exactly, the records to 1e-4."""
import numpy as np
import pytest

from repro.storage import RPC_BYTES as J_RPC_BYTES
from repro.storage import AdapTBFController as JController
from repro_torch.storage import RPC_BYTES, AdapTBFController


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def time(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _pair(**kw):
    clocks = (VirtualClock(), VirtualClock())
    jc = JController(time_fn=clocks[0].time, sleep_fn=clocks[0].sleep, **kw)
    tc = AdapTBFController(time_fn=clocks[1].time, sleep_fn=clocks[1].sleep,
                           device="cpu", **kw)
    return (jc, tc), clocks


def _same(ctls, jobs):
    jc, tc = ctls
    assert jc.windows_run == tc.windows_run
    for job in jobs:
        np.testing.assert_array_equal(tc.budget_of(job), jc.budget_of(job),
                                      err_msg=job)
        np.testing.assert_allclose(tc.records_of(job), jc.records_of(job),
                                   atol=1e-4, err_msg=job)
        np.testing.assert_array_equal(tc.observed_demand(job),
                                      jc.observed_demand(job), err_msg=job)
        np.testing.assert_array_equal(tc.stripe_set(job), jc.stripe_set(job))


def test_rpc_unit_is_the_references():
    assert RPC_BYTES == J_RPC_BYTES


@pytest.mark.parametrize("n_targets,stripes", [(1, None), (4, (1, 2, 4))])
def test_request_pacing_matches_reference(n_targets, stripes):
    ctls, clocks = _pair(n_targets=n_targets, capacity_rpc_per_s=400.0,
                         window_s=0.1)
    jobs = {"train": 8.0, "ckpt": 1.0, "data": 3.0}
    for ctl in ctls:
        for i, (name, nodes) in enumerate(jobs.items()):
            ctl.register_job(name, nodes=nodes,
                             stripe_count=stripes[i] if stripes else None)
    rng = np.random.default_rng(0)
    script = [(list(jobs)[rng.integers(3)], int(rng.integers(1, 9)))
              for _ in range(60)]
    for step, (job, mb) in enumerate(script):
        targets = [ctl.request(job, mb * RPC_BYTES) for ctl in ctls]
        assert targets[0] == targets[1], step
        assert clocks[0].t == clocks[1].t, step
        if step % 10 == 9:
            for clk in clocks:
                clk.sleep(0.1)
            _same(ctls, jobs)
    assert ctls[0].windows_run >= 3
    _same(ctls, jobs)


def test_try_consume_and_denied_once_rule_match_reference():
    """Serving admission: two classes poll every step with stable request
    ids; a denied head-of-queue request counts its demand once a window."""
    ctls, clocks = _pair(n_targets=1, capacity_rpc_per_s=2000.0,
                         window_s=0.05)
    classes = {"serve:interactive": 3.0, "serve:batch": 1.0}
    for ctl in ctls:
        for name, prio in classes.items():
            ctl.register_job(name, nodes=prio)
    rng = np.random.default_rng(3)
    heads = {name: (i, int(rng.integers(10, 60)))
             for i, name in enumerate(classes)}
    next_id = len(classes)
    for step in range(200):
        for name in classes:
            rid, tokens = heads[name]
            got = [ctl.try_consume(name, tokens, request_id=rid)
                   for ctl in ctls]
            assert got[0] == got[1], (step, name)
            if got[0]:
                heads[name] = (next_id, int(rng.integers(10, 60)))
                next_id += 1
        if step % 7 == 6:
            _same(ctls, classes)
        for clk in clocks:
            clk.sleep(0.004)
    assert ctls[0].windows_run > 10
    _same(ctls, classes)


def test_denied_retries_count_demand_once():
    ctls, _ = _pair(n_targets=1, capacity_rpc_per_s=100.0, window_s=0.1)
    for ctl in ctls:
        ctl.register_job("a", nodes=1.0)
        ctl._budget[:] = 5.0                  # a ruled, small budget
        for _ in range(4):                    # the same request, retried
            assert not ctl.try_consume("a", 8.0, request_id=42)
        assert not ctl.try_consume("a", 8.0)  # anonymous, counted once
        assert not ctl.try_consume("a", 8.0)
        assert ctl.try_consume("a", 3.0)
    _same(ctls, ["a"])
    np.testing.assert_array_equal(ctls[1].observed_demand("a"), [19.0])
