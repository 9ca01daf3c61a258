"""The port's fleet engine (``repro_torch.storage``) on the CPU, through the
plain versions of its kernels, against the reference engine.

* Closed loop: every policy on the reference's invariant fixture, held to
  the reference's own checker (``test_invariants._check_invariants``) and
  compared with the reference's ``simulate_fleet`` window by window.  On
  this fixture the closed loop does not fork: integer allocations and
  records agree exactly and served/demand within atol 1e-3 (row sums of
  fractional service reduce in another order, so they differ by ulps).
* Other options: the kernel backends' strings on the CPU, ``n_windows``
  tiling, a fault plan (outage plus telemetry loss), ``simulate`` as the
  O=1 view.
* Carry across: a reference carry after k windows continues in the port,
  a coded one too.
* Device rule: ``device=None`` needs a GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_invariants import WINDOW_TICKS, _build_case, _check_invariants

from repro.core.policies import CodedPolicy as JCodedPolicy
from repro.core.policies import PolicyContext as JContext
from repro.core.policies import get_policy as jget_policy
from repro.storage import FleetConfig as JConfig
from repro.storage import simulate_fleet as jsimulate_fleet
from repro.storage import simulator as jsim
from repro_torch.storage import (
    FaultPlan,
    FleetConfig,
    SimConfig,
    carry_from_numpy,
    carry_to_numpy,
    faults,
    get_policy,
    init_carry,
    simulate,
    simulate_fleet,
    window_step,
)
from repro_torch.core.policies import CodedPolicy, PolicyContext

torch.set_num_threads(1)

FIELDS = ("served", "demand", "alloc", "record", "queue_final")
POLICIES = ("adaptbf", "static", "nobw", "static_wc", "aimd")


def _assert_close(got, want, atol, tag):
    for f in FIELDS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=f"{tag}/{f}")
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], atol=atol,
                                   err_msg=f"{tag}/{f}")


def _assert_equal(a, b, tag):
    for f in FIELDS:
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=0, equal_nan=True, msg=f"{tag}/{f}")


def _reference_run(control, case, n_windows=None):
    """The reference engine on ``case``.  adaptbf steps the reference's
    per-window body (``window_step``, what its ``simulate_fleet`` scans)
    eagerly, sharing its compiled allocator with the carry test below; the
    other policies run the reference's ``simulate_fleet``."""
    if control != "adaptbf":
        return jsimulate_fleet(
            JConfig(control=control, window_ticks=WINDOW_TICKS),
            *(jnp.asarray(x) for x in case))
    nodes, rates, volume, caps, backlog = case
    o, j = volume.shape
    jcfg, jpol, jctx = _reference_engine(nodes, caps, o, j)
    carry = jsim.init_carry(jcfg, jpol, jctx, jnp.asarray(volume))
    outs = []
    for rates_w in rates.reshape(-1, WINDOW_TICKS, o, j)[:n_windows]:
        carry, out = jsim.window_step(jcfg, jpol, jctx, jnp.asarray(caps),
                                      jnp.asarray(backlog), carry,
                                      jnp.asarray(rates_w))
        outs.append(out)
    stacked = [np.stack([np.asarray(x) for x in col]) for col in zip(*outs)]
    return jsim.FleetResult(*stacked, queue_final=np.asarray(carry.queue),
                            window_seconds=0.0), carry


def _reference_engine(nodes, caps, o, j):
    jctx = JContext(nodes=jnp.broadcast_to(jnp.asarray(nodes), (o, j)),
                    cap_w=jnp.asarray(caps) * WINDOW_TICKS)
    return JConfig(window_ticks=WINDOW_TICKS), jget_policy("adaptbf"), jctx


@pytest.mark.parametrize("control", POLICIES)
def test_closed_loop_invariants_and_reference_parity(control):
    case = _build_case(2, seed=1234)
    cfg = FleetConfig(control=control, window_ticks=WINDOW_TICKS)
    res = simulate_fleet(cfg, *case, device="cpu")
    _check_invariants(control, cfg, case, res)
    want = _reference_run(control, case)
    if control == "adaptbf":
        want = want[0]
    _assert_close(res, want, 1e-3, control)
    for f in ("alloc", "record"):   # integer token state: exact
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("control", ["adaptbf", "static_wc", "aimd"])
def test_float_tokens_match_reference(control):
    """``integer_tokens=False``: float budgets (``passthrough``)."""
    case = _build_case(2, seed=77)
    cfg = FleetConfig(control=control, window_ticks=WINDOW_TICKS,
                      integer_tokens=False)
    res = simulate_fleet(cfg, *case, device="cpu")
    _check_invariants(control, cfg, case, res)
    want = jsimulate_fleet(
        JConfig(control=control, window_ticks=WINDOW_TICKS,
                integer_tokens=False), *(jnp.asarray(x) for x in case))
    _assert_close(res, want, 1e-3, f"{control}/float")


def test_kernel_backends_run_their_plain_versions_on_cpu():
    """On CPU tensors the "fused"/"pallas" strings take the kernels' plain
    versions, which are the "scan"/"core" code: bitwise the same run."""
    case = _build_case(2, seed=7)
    base = simulate_fleet(FleetConfig(window_ticks=WINDOW_TICKS), *case,
                          device="cpu")
    kern = simulate_fleet(
        FleetConfig(window_ticks=WINDOW_TICKS, serve_backend="fused",
                    alloc_backend="pallas"), *case, device="cpu")
    _assert_equal(kern, base, "fused/pallas")
    with pytest.raises(ValueError, match="integer tokens"):
        simulate_fleet(FleetConfig(window_ticks=WINDOW_TICKS,
                                   alloc_backend="pallas",
                                   integer_tokens=False), *case, device="cpu")


def test_n_windows_tiles_the_trace():
    nodes, rates, volume, caps, backlog = _build_case(2, seed=5)
    cfg = FleetConfig(window_ticks=WINDOW_TICKS)
    tiled = simulate_fleet(cfg, nodes, rates, volume, caps, backlog,
                           n_windows=3 * rates.shape[0] // WINDOW_TICKS,
                           device="cpu")
    explicit = simulate_fleet(cfg, nodes, np.concatenate([rates] * 3),
                              volume, caps, backlog, device="cpu")
    _assert_equal(tiled, explicit, "tiled")
    trimmed = simulate_fleet(cfg, nodes, rates, volume, caps, backlog,
                             n_windows=2, device="cpu")
    assert trimmed.served.shape[0] == 2
    torch.testing.assert_close(trimmed.served, tiled.served[:2], rtol=0,
                               atol=0)


def _fault_plan(n_windows, n_ost):
    """OST 1 down for windows [1, 3); OST 0 loses telemetry in [2, 4)."""
    plan = faults.outage(n_windows, n_ost, 1, 3, osts=[1])
    lost = faults.no_faults(n_windows, n_ost)
    lost.telem_ok[2:4, 0] = 0.0
    return faults.compose(plan, lost)


@pytest.mark.parametrize("control", ["adaptbf", "aimd"])
def test_fault_plan_outage_and_lost_telemetry(control):
    case = _build_case(2, seed=21)
    nodes, rates, volume, caps, backlog = case
    n_w = rates.shape[0] // WINDOW_TICKS
    plan = _fault_plan(n_w, 2)
    cfg = FleetConfig(control=control, window_ticks=WINDOW_TICKS)
    res = simulate_fleet(cfg, *case, fault_plan=plan, device="cpu")
    down = plan.up == 0
    served = res.served.numpy()
    assert (served[down] == 0.0).all()          # a down row serves exactly 0
    assert (res.served[~torch.from_numpy(down)].sum(-1) > 0).any()
    if control == "adaptbf":                    # ledger written off while down
        assert (res.record.numpy()[down] == 0.0).all()
    clean = simulate_fleet(cfg, *case, device="cpu")
    assert not torch.equal(res.served, clean.served)
    if control == "aimd":   # one cheap reference compile of the faulted engine
        want = jsimulate_fleet(
            JConfig(control=control, window_ticks=WINDOW_TICKS),
            *(jnp.asarray(x) for x in case),
            fault_plan=jsim.FaultPlan(*(jnp.asarray(x) for x in plan)))
        _assert_close(res, want, 1e-3, f"{control}/faulted")


def test_simulate_is_the_single_ost_view():
    """Decentralization: each OST row of a fleet run equals a single-target
    run on that row's demand, bitwise."""
    nodes, rates, volume, caps, backlog = _build_case(3, seed=9)
    cfg = FleetConfig(window_ticks=WINDOW_TICKS, capacity_per_tick=10.0)
    fleet = simulate_fleet(cfg, nodes, rates, volume, None, backlog,
                           device="cpu")
    for i in range(3):
        one = simulate(SimConfig(window_ticks=WINDOW_TICKS,
                                 capacity_per_tick=10.0),
                       nodes, rates[:, i], volume[i], backlog[i],
                       device="cpu")
        _assert_equal(one, fleet.per_ost(i), f"ost {i}")


def test_reference_carry_continues_in_the_port():
    """Run the reference's ``window_step`` for k windows, hand its carry
    over by the checkpoint's pytree path strings, and take one more window
    on each side.  One window is open loop: atol 1e-4."""
    case = _build_case(2, seed=31)
    nodes, rates, volume, caps, backlog = case
    o, j = volume.shape
    k = 3
    _, jcarry = _reference_run("adaptbf", case, n_windows=k)
    jcfg, jpol, jctx = _reference_engine(nodes, caps, o, j)
    rates_w = rates.reshape(-1, WINDOW_TICKS, o, j)
    flat, _ = jax.tree_util.tree_flatten_with_path(jcarry)
    leaves = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}

    carry = carry_from_numpy(leaves, device="cpu")
    assert carry.window == k
    back = carry_to_numpy(carry)
    assert list(back) == list(leaves)           # same paths, same order
    for key, x in leaves.items():
        np.testing.assert_array_equal(back[key], x, err_msg=key)

    jcarry2, jout = jsim.window_step(jcfg, jpol, jctx, jnp.asarray(caps),
                                     jnp.asarray(backlog), jcarry,
                                     jnp.asarray(rates_w[k]))
    ctx = PolicyContext(nodes=torch.from_numpy(nodes).expand(o, j).contiguous(),
                        cap_w=torch.from_numpy(caps) * WINDOW_TICKS)
    carry2, out = window_step(FleetConfig(window_ticks=WINDOW_TICKS),
                              get_policy("adaptbf"), ctx,
                              torch.from_numpy(caps),
                              torch.from_numpy(backlog), carry,
                              torch.from_numpy(np.ascontiguousarray(
                                  rates_w[k])))
    for name, g, w in zip(out._fields, out, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=name)
    flat2, _ = jax.tree_util.tree_flatten_with_path(jcarry2)
    got2 = carry_to_numpy(carry2)
    for p, x in flat2:
        key = jax.tree_util.keystr(p)
        np.testing.assert_allclose(got2[key], np.asarray(x), atol=1e-4,
                                   err_msg=key)


def test_init_carry_matches_the_reference_paths():
    o, j = 2, 5
    ctx = PolicyContext(nodes=torch.ones(o, j), cap_w=torch.full((o,), 50.0))
    for control in POLICIES:
        carry = init_carry(FleetConfig(control=control), get_policy(control),
                           ctx, torch.full((o, j), np.inf))
        jctx = JContext(nodes=jnp.ones((o, j)), cap_w=jnp.full((o,), 50.0))
        jcarry = jsim.init_carry(JConfig(control=control),
                                 jget_policy(control), jctx,
                                 jnp.full((o, j), jnp.inf))
        flat, _ = jax.tree_util.tree_flatten_with_path(jcarry)
        want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
        got = carry_to_numpy(carry)
        assert list(got) == list(want), control
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{control}{key}")


def test_device_none_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = _build_case(1, seed=3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        simulate_fleet(FleetConfig(window_ticks=WINDOW_TICKS), *case)
    nodes, rates, volume, _, backlog = case
    with pytest.raises(RuntimeError, match='device="cpu"'):
        simulate(SimConfig(window_ticks=WINDOW_TICKS), nodes, rates[:, 0],
                 volume[0], backlog[0])


@pytest.mark.parametrize("kw,code,err,match", [
    (dict(telemetry="psychic"), None, ValueError, "telemetry"),
    (dict(partition="ost_shard"), None, ValueError,
     "torch.distributed.init_process_group"),
    (dict(control="coded"), None, ValueError, "requires control_code"),
    (dict(), 0, ValueError, 'requires cfg.control == "coded"'),
    (dict(serve_backend="warp"), None, ValueError, "unknown"),
    (dict(partition="mesh"), None, ValueError, "unknown"),
])
def test_unported_and_unknown_options_raise(kw, code, err, match):
    """Unknown options raise ``ValueError``, and so does ``ost_shard``
    without a process group (no silent single-device run); coded dispatch
    follows the reference's rules (a code exactly when
    ``control="coded"``)."""
    case = _build_case(1, seed=3)
    with pytest.raises(err, match=match):
        simulate_fleet(FleetConfig(window_ticks=WINDOW_TICKS, **kw), *case,
                       control_code=code, device="cpu")


def test_reference_coded_carry_continues_in_the_port():
    """A coded carry written by the reference (``.policy_state[i]...``
    leaves, a stateless member leaving none) continues in the port: three
    reference windows under ``control="coded"``, the carry handed over by
    its pytree path strings, then one more window on each side (atol
    1e-4, one window is open loop)."""
    case = _build_case(2, seed=41)
    nodes, rates, volume, caps, backlog = case
    o, j = volume.shape
    members, code, k = ("static", "adaptbf", "aimd"), 1, 3
    jcfg = JConfig(window_ticks=WINDOW_TICKS, control="coded",
                   coded_policies=members)
    jpol = JCodedPolicy(members)
    jctx = JContext(nodes=jnp.broadcast_to(jnp.asarray(nodes), (o, j)),
                    cap_w=jnp.asarray(caps) * WINDOW_TICKS,
                    control_code=jnp.int32(code))
    step = jax.jit(lambda c, r: jsim.window_step(
        jcfg, jpol, jctx, jnp.asarray(caps), jnp.asarray(backlog), c, r))
    rates_w = rates.reshape(-1, WINDOW_TICKS, o, j)
    jcarry = jsim.init_carry(jcfg, jpol, jctx, jnp.asarray(volume))
    for w in range(k):
        jcarry, _ = step(jcarry, jnp.asarray(rates_w[w]))
    flat, _ = jax.tree_util.tree_flatten_with_path(jcarry)
    leaves = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    assert ".policy_state[1].record" in leaves
    assert ".policy_state[2]" in leaves         # aimd's rate leaf

    policy = CodedPolicy(members)
    with pytest.raises(ValueError, match="CodedPolicy"):
        carry_from_numpy(leaves, device="cpu")
    carry = carry_from_numpy(leaves, device="cpu", policy=policy)
    assert carry.policy_state[0] == ()
    back = carry_to_numpy(carry)
    assert list(back) == list(leaves)           # same paths, same order
    for key, x in leaves.items():
        np.testing.assert_array_equal(back[key], x, err_msg=key)

    jcarry2, jout = step(jcarry, jnp.asarray(rates_w[k]))
    ctx = PolicyContext(nodes=torch.from_numpy(nodes).expand(o, j).contiguous(),
                        cap_w=torch.from_numpy(caps) * WINDOW_TICKS,
                        control_code=code)
    carry2, out = window_step(
        FleetConfig(window_ticks=WINDOW_TICKS, control="coded",
                    coded_policies=members), policy, ctx,
        torch.from_numpy(caps), torch.from_numpy(backlog), carry,
        torch.from_numpy(np.ascontiguousarray(rates_w[k])))
    for name, g, w in zip(out._fields, out, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=name)
    flat2, _ = jax.tree_util.tree_flatten_with_path(jcarry2)
    got2 = carry_to_numpy(carry2)
    assert list(got2) == [jax.tree_util.keystr(p) for p, _ in flat2]
    for p, x in flat2:
        key = jax.tree_util.keystr(p)
        np.testing.assert_allclose(got2[key], np.asarray(x), atol=1e-4,
                                   err_msg=key)


def test_fault_plan_must_cover_the_run_horizon():
    case = _build_case(2, seed=3)
    with pytest.raises(ValueError, match="fault_plan.up"):
        simulate_fleet(FleetConfig(window_ticks=WINDOW_TICKS), *case,
                       fault_plan=FaultPlan(*faults.no_faults(2, 2)),
                       device="cpu")
