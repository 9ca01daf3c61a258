"""The window megakernel's plain version (``repro_torch``
``mega_window_round`` on CPU tensors) and ``serve_backend="mega"`` against
the reference's ``mega_window_round`` and ``simulate_fleet``.

* One round: each policy, three chained rounds from an evolved state and a
  fourth with a fault row (an outage, a lost-telemetry window and droop),
  every round fed the same inputs on both sides.  Finite masks equal and
  atol 1e-3, the reference's own megakernel tolerance
  (``tests/test_kernel_window_mega.py``): row sums reduce in another order
  (float64 here, float32 in XLA), so served values differ by ulps.
* Whole runs: every policy end to end (atol 1e-3, finite masks equal, the
  ROADMAP parity contract), one generated scenario on horizon totals.
* Inside the port, on the CPU ``mega`` is the same composition as ``scan``,
  so the two are bitwise equal, faults included.
* The wrapper's contract errors, with the reference's messages.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policies import PolicyContext as JContext
from repro.core.policies import get_policy as jget_policy
from repro.core.state import AllocatorState as JAllocatorState
from repro.kernels.window_mega import ops as jops
from repro.storage import FleetConfig as JConfig
from repro.storage import random_fleet as jrandom_fleet
from repro.storage import simulate_fleet as jsimulate_fleet
from repro_torch.core.policies import (
    AdapTBFPolicy,
    ControlPolicy,
    PolicyContext,
    get_policy,
    list_policies,
)
from repro_torch.core.state import AllocatorState
from repro_torch.kernels.window_mega import ops as tops
from repro_torch.storage import FaultPlan, FleetConfig, simulate_fleet

torch.set_num_threads(1)

POLICIES = ("adaptbf", "static", "nobw", "static_wc", "aimd")
FIELDS = ("served", "demand", "alloc", "record", "queue_final")
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")


def _assert_close(got, want, atol, tag):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=tag)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=atol, err_msg=tag)


def _round_inputs(o, j, w, seed):
    """Seeded numpy inputs of one control round (shaped like
    ``test_kernel_window_mega._round_args``)."""
    rng = np.random.default_rng(seed)
    return dict(
        nodes=rng.integers(1, 8, (o, j)).astype(np.float32),
        cap_tick=rng.integers(4, 20, (o,)).astype(np.float32),
        queue=(rng.random((o, j)) * 6).astype(np.float32),
        vol=np.where(rng.random((o, j)) < 0.4, np.inf,
                     200.0).astype(np.float32),
        backlog=rng.choice([16.0, 64.0, 256.0], (o, j)).astype(np.float32),
        rates=[rng.integers(0, 3 + 3 * (r % 2), (w, o, j)).astype(np.float32)
               for r in range(4)])


_JROUNDS = {}


def _jround(control):
    """The reference round for one policy, compiled once per shape and
    fault presence (``interpret=None``: its XLA fallback, as its own CPU
    tests run it)."""
    if control in _JROUNDS:
        return _JROUNDS[control]
    policy = jget_policy(control)

    def fn(nodes, cap_w, cap_tick, backlog, queue, vol, alloc, held, pstate,
           rates, telem=None, up=None):
        ctx = JContext(nodes=nodes, cap_w=cap_w)
        return jops.mega_window_round(policy, ctx, cap_tick, backlog, queue,
                                      vol, alloc, held, pstate, rates,
                                      telem_ok=telem, up=up)
    _JROUNDS[control] = jax.jit(fn)
    return _JROUNDS[control]


def _torch(tree):
    """A reference argument as port tensors; an ``AllocatorState`` becomes
    the port's."""
    if isinstance(tree, JAllocatorState):
        return AllocatorState(*map(_torch, tree))
    if isinstance(tree, tuple):
        return tuple(map(_torch, tree))
    return torch.from_numpy(np.array(tree))


def _flat(out, leaves):
    return [*out[:7], *leaves(out[7]), out[8]]


def _evolved(control, x, w, seed):
    """A running fleet's policy state and standing allocation: integer
    allocations with stopped rules, nonzero lend/borrow records and
    fractional remainders (adaptbf), carried rates (aimd)."""
    rng = np.random.default_rng(seed)
    o, j = x["nodes"].shape
    alloc = np.where(rng.random((o, j)) < 0.3, 0.0,
                     rng.integers(1, 20, (o, j))).astype(np.float32)
    jctx = JContext(nodes=jnp.asarray(x["nodes"]),
                    cap_w=jnp.asarray(x["cap_tick"] * w))
    pstate = jget_policy(control).init_state(jctx)
    if control == "adaptbf":
        pstate = JAllocatorState(
            record=jnp.asarray(rng.integers(-40, 40, (o, j)), jnp.float32),
            remainder=jnp.asarray(rng.random((o, j)) - 0.5, jnp.float32),
            alloc_prev=jnp.asarray(rng.integers(0, 30, (o, j)), jnp.float32))
    elif control == "aimd":
        pstate = jnp.asarray(1.0 + rng.random((o, j))
                             * x["cap_tick"][:, None] * w, jnp.float32)
        alloc[rng.random(o) < 0.5] = np.inf      # uncongested rows
    elif control in ("static", "nobw"):
        alloc = np.asarray(jget_policy(control).init_alloc(jctx))
    return pstate, jnp.asarray(alloc)


@pytest.mark.parametrize("o,j,w", [(3, 16, 10), (9, 100, 7)])
@pytest.mark.parametrize("control", POLICIES)
def test_mega_round_matches_reference(control, o, j, w):
    """Three chained rounds from an evolved state, then a faulted round:
    OST 0 loses telemetry (the step sees the held observation), OST 1 is
    down (no service, no issue; adaptbf's ledger is written off) and OST 2
    runs at half capacity."""
    x = _round_inputs(o, j, w, seed=o * 100 + j)
    jpol, tpol = jget_policy(control), get_policy(control)
    pstate, alloc = _evolved(control, x, w, seed=j)
    held = (jnp.zeros((o, j)), jnp.zeros((o, j)), alloc)
    queue, vol = jnp.asarray(x["queue"]), jnp.asarray(x["vol"])
    up = np.ones(o, np.float32)
    up[1] = 0.0
    telem = np.ones(o, np.float32)
    telem[0] = 0.0
    scale = np.ones(o, np.float32)
    scale[2] = 0.5
    for r in range(4):
        faulted = r == 3
        cap_tick = x["cap_tick"] * (up * scale if faulted else 1.0)
        rates = x["rates"][r] * (up[None, :, None] if faulted else 1.0)
        args = [x["nodes"], cap_tick * w, cap_tick, x["backlog"], queue, vol,
                alloc, held, pstate, rates]
        if faulted:
            args += [telem, up]
        want = _jround(control)(*jax.tree.map(jnp.asarray, args))

        t = [_torch(a) for a in args]
        ctx = PolicyContext(nodes=t[0], cap_w=t[1])
        got = tops.mega_window_round(tpol, ctx, *t[2:])
        assert tops.launches == 0                # CPU: the plain version
        flat_w = _flat(want, jax.tree.leaves)
        flat_g = _flat(got, tops._leaves)
        assert len(flat_g) == len(flat_w)
        for i, (g, wv) in enumerate(zip(flat_g, flat_w)):
            _assert_close(g.numpy(), wv, 1e-3, f"{control} round {r} "
                          f"leaf {i}")
        if faulted:
            assert (got[2][1] == 0).all()         # a down row serves nothing
            torch.testing.assert_close(got[5][0], t[7][1][0], rtol=0, atol=0)
            if control == "adaptbf":
                assert (got[7].record[1] == 0).all()
        queue, vol = want[0], want[1]
        held, pstate, alloc = tuple(want[4:7]), want[7], want[8]


def _fleet_case(o, j, t, seed):
    rng = np.random.default_rng(seed)
    nodes = rng.integers(1, 32, (j,)).astype(np.float32)
    rates = rng.integers(0, 4, (t, o, j)).astype(np.float32)
    vol = np.where(rng.random((o, j)) < 0.5, np.inf,
                   500.0).astype(np.float32)
    caps = rng.integers(5, 25, (o,)).astype(np.float32)
    return nodes, rates, vol, caps


@pytest.mark.parametrize("control", POLICIES)
def test_mega_run_matches_reference(control):
    """``simulate_fleet(serve_backend="mega")`` end to end against the
    reference's, on the fixture of its own megakernel test."""
    case = _fleet_case(6, 48, 60, seed=5)
    cfg = dict(control=control, serve_backend="mega")
    got = simulate_fleet(FleetConfig(**cfg), *case, device="cpu")
    want = jsimulate_fleet(JConfig(**cfg), *map(jnp.asarray, case))
    for f in FIELDS:
        _assert_close(getattr(got, f).numpy(), getattr(want, f), 1e-3,
                      f"{control}/{f}")


@pytest.mark.parametrize("profile,seed", [
    ("mixed", 3), ("saturation", 11), ("burst", 7),
])
def test_mega_generated_scenario_horizon_totals(profile, seed):
    """The reference's generated scenarios on horizon totals.  A demand one
    ulp apart can flip an integer remainder tie and fork the closed loop
    (``saturation`` 11 forks at window 7: demand 74.799995 here, 74.8 in
    the reference, and one token changes jobs), so per-window equality is
    not the claim: per-OST and fleet totals hold to 1e-3 relative, and each
    job's total on each OST to one token per window."""
    scn = jrandom_fleet(seed, n_ost=4, n_jobs=8, profile=profile,
                        duration_s=3.0)
    args = (scn.nodes, scn.issue_rate, scn.volume, scn.capacity_per_tick,
            scn.max_backlog)
    cfg = dict(control="adaptbf", serve_backend="mega")
    got = simulate_fleet(FleetConfig(**cfg), *args, device="cpu")
    want = jsimulate_fleet(JConfig(**cfg), *map(jnp.asarray, args))
    got_s = got.served.double().numpy()
    want_s = np.asarray(want.served, np.float64)
    n_windows = got_s.shape[0]
    np.testing.assert_allclose(got_s.sum((0, 2)), want_s.sum((0, 2)),
                               rtol=1e-3)
    np.testing.assert_allclose(got_s.sum(), want_s.sum(), rtol=1e-3)
    np.testing.assert_allclose(got_s.sum(0), want_s.sum(0), rtol=0,
                               atol=n_windows)
    cap_w = np.asarray(scn.capacity_per_tick, np.float64) * 10
    assert (got_s.sum(-1) <= cap_w + 1e-3).all()


@pytest.mark.parametrize("control", POLICIES)
def test_mega_equals_scan_bitwise_on_cpu(control):
    """On CPU tensors the mega round is the scan window's own composition,
    so whole runs agree bitwise, with a fault plan too."""
    nodes, rates, vol, caps = _fleet_case(4, 24, 40, seed=4)
    n_w = 4
    plan = FaultPlan(*(np.ones((n_w, 4), np.float32) for _ in range(3)))
    plan.up[2, 1] = 0.0
    plan.telem_ok[3, 0] = 0.0
    plan.cap_scale[1, 2] = 0.5
    for fault_plan in (None, plan):
        res = {serve: simulate_fleet(
                   FleetConfig(control=control, serve_backend=serve),
                   nodes, rates, vol, caps, fault_plan=fault_plan,
                   device="cpu")
               for serve in ("scan", "mega")}
        for f in FIELDS:
            torch.testing.assert_close(
                getattr(res["mega"], f), getattr(res["scan"], f), rtol=0,
                atol=0, equal_nan=True, msg=f"{control}/{f}")


def test_custom_policy_runs_the_plain_round_on_cpu():
    """The plain round composes any policy's own gate and step, so a
    policy the kernel has no case for (here a subclass of a built-in, which
    does not inherit the built-in's device id) runs on CPU tensors."""
    class Halved(AdapTBFPolicy):
        def step(self, state, obs, ctx):
            state, alloc = super().step(state, obs, ctx)
            return state, torch.floor(alloc / 2)

    assert type(Halved()).__dict__.get("device_id") is None
    o, j, w = 2, 12, 5
    x = _round_inputs(o, j, w, seed=3)
    t = {k: torch.from_numpy(v) for k, v in x.items() if k != "rates"}
    ctx = PolicyContext(nodes=t["nodes"], cap_w=t["cap_tick"] * w)
    pol = Halved()
    alloc = pol.init_alloc(ctx)
    out = tops.mega_window_round(
        pol, ctx, t["cap_tick"], t["backlog"], t["queue"], t["vol"], alloc,
        (torch.zeros(o, j), torch.zeros(o, j), alloc), pol.init_state(ctx),
        torch.from_numpy(x["rates"][0]))
    base = tops.mega_window_round(
        get_policy("adaptbf"), ctx, t["cap_tick"], t["backlog"], t["queue"],
        t["vol"], alloc, (torch.zeros(o, j), torch.zeros(o, j), alloc),
        pol.init_state(ctx), torch.from_numpy(x["rates"][0]))
    torch.testing.assert_close(out[8], torch.floor(base[8] / 2))


def test_device_ids_match_the_kernel():
    """Each built-in's ``device_id`` names the same case in
    ``csrc/window_mega.cu``; custom policies have none."""
    src = (CSRC / "window_mega.cu").read_text()
    enum = {name.lower(): int(v) for name, v in
            re.findall(r"POLICY_(\w+) = (\d+),", src)}
    assert enum == {name: type(get_policy(name)).__dict__["device_id"]
                    for name in list_policies()}
    assert ControlPolicy.device_id is None
    start = src.index("struct MegaParams")
    fields = re.findall(r"^\s+(?:const )?(?:float|int)\*? (\w+);",
                        src[start:src.index("};", start)], re.M)
    assert fields == [f for f, _ in tops._Params._fields_]


def test_rowless_and_non_oj_state_are_rejected():
    """The reference's contract errors: a state leaf without a leading OST
    axis cannot be blocked over rows; the kernel takes [O, J] leaves."""
    with pytest.raises(ValueError, match="mega"):
        tops._flatten_state({"scalarish": torch.ones(3)}, o=8)
    with pytest.raises(ValueError, match="mega"):
        tops._flatten_state((torch.ones(8, 4), torch.tensor(1.0)), o=8)
    with pytest.raises(ValueError, match="O, J"):
        tops._check_oj(tops._flatten_state(torch.ones(4, 8), o=4), 4, 16)
    o, j, w = 4, 16, 4
    x = _round_inputs(o, j, w, seed=0)
    t = {k: torch.from_numpy(v) for k, v in x.items() if k != "rates"}
    ctx = PolicyContext(nodes=t["nodes"], cap_w=t["cap_tick"] * w)
    pol = get_policy("adaptbf")
    bad = pol.init_state(ctx)._replace(record=torch.zeros(()))
    alloc = pol.init_alloc(ctx)
    with pytest.raises(ValueError, match="leading OST axis"):
        tops.mega_window_round(pol, ctx, t["cap_tick"], t["backlog"],
                               t["queue"], t["vol"], alloc,
                               (alloc, alloc, alloc), bad,
                               torch.from_numpy(x["rates"][0]))
