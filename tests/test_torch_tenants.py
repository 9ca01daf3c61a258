"""The port's tenant axis (``repro_torch.storage.simulate_tenants``) on the
CPU, through the plain versions of its kernels.

* Inside the port, bitwise: a batched run equals a Python loop of per-fleet
  ``simulate_fleet`` runs, every leaf, for ("scan", "core"), ("fused",
  "pallas") and ("mega", "pallas") in both telemetry modes, under per-fleet
  codes over the whole policy registry plus one out-of-range code, on
  heterogeneous fleets, without faults and with shared and batched fault
  plans (tolerance 0).  The streaming finalizers on a batched carry equal
  the per-fleet ones exactly.
* Against the reference's ``simulate_tenants`` on its own fixture
  (``_tenant_worker.tenant_args``: F=4, O=4, J=6, 1 s), under the parity
  contract: whole-token allocations and every int32 counter exact;
  float values within atol 1e-3 (row sums reduce in another order, so they
  differ by ulps); streaming sums within rtol 1e-5; each OST's backlog
  histogram holding the same count (a value within an ulp of a bin edge
  may land in the next bin: ROADMAP queue C.3).
* The reference's rank rules and error messages.
* ``partition="fleet_shard"`` on a grid of 4 gloo ranks (2x2, 1x4 and the
  default 4x1): every rank's whole result bitwise the unsharded batch,
  under per-fleet codes and a batched fault plan and with every argument
  shared; the reference's divisibility messages; no process group raises.
* The megakernel's case for a subclass of a built-in policy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tenant_worker import TENANT_F, tenant_args, tenant_fault_plan
from test_torch_sharding import BACKENDS as SHARD_BACKENDS
from test_torch_sharding import Ranks, assert_bitwise

from repro.storage import FleetConfig as JConfig
from repro.storage import simulate_tenants as jsimulate_tenants
from repro_torch.core.policies import (
    AdapTBFPolicy,
    AIMDPolicy,
    ControlPolicy,
    _where,
    get_policy,
)
from repro_torch.kernels.dispatch import check_rates
from repro_torch.kernels.window_mega.ops import megakernel_case
from repro_torch.pytree import leaves_with_paths
from repro_torch.storage import (
    FaultPlan,
    FleetConfig,
    metrics,
    simulate_fleet,
    simulate_tenants,
)

torch.set_num_threads(1)

#: the five built-in policies as one coded set, named here rather than read
#: from a registry: other test files register policies of their own in the
#: same process
ALL_POLICIES = ("adaptbf", "aimd", "nobw", "static", "static_wc")
#: every registered policy on its own fleet, then one out-of-range code
#: (the last member's gate and allocation, no state advance)
CODES = np.array([*range(len(ALL_POLICIES)), len(ALL_POLICIES) + 2], np.int32)
F = len(CODES)
BACKENDS = [("scan", "core"), ("fused", "pallas"), ("mega", "pallas")]


def _np(tree):
    return tuple(np.array(x) for x in tree)


@pytest.fixture(scope="module")
def fleets():
    """F heterogeneous fleets (each its own seeded scenario)."""
    nodes, rates, volume, cap, _ = _np(tenant_args(f=F))
    return nodes, rates, volume, cap


def _plan(cfg, kind):
    if kind == "none":
        return None
    plan = FaultPlan(*_np(tenant_fault_plan(cfg, f=F)))
    return FaultPlan(*(x[1] for x in plan)) if kind == "shared" else plan


def _assert_stack_equal(batched, loop, tag):
    """Every tensor leaf of ``batched`` at fleet i equals the i-th per-fleet
    result's, bitwise (NaN-free: inf compares equal to inf)."""
    want = [dict(leaves_with_paths(r)) for r in loop]
    paths = [p for p, x in leaves_with_paths(batched)
             if isinstance(x, torch.Tensor)]
    assert paths == [p for p, x in leaves_with_paths(loop[0])
                     if isinstance(x, torch.Tensor)]
    for path, x in leaves_with_paths(batched):
        if not isinstance(x, torch.Tensor):
            assert all(x == w[path] for w in want), (tag, path)
            continue
        assert x.shape[0] == len(loop), (tag, path)
        for i, w in enumerate(want):
            assert x[i].dtype == w[path].dtype, (tag, path)
            assert torch.equal(x[i], w[path]), f"{tag} fleet {i} {path}"


@pytest.mark.parametrize("plan", ["none", "shared", "batched"])
@pytest.mark.parametrize("telemetry", ["trajectory", "streaming"])
@pytest.mark.parametrize("serve,alloc", BACKENDS)
def test_batched_equals_per_fleet_loop_bitwise(fleets, serve, alloc,
                                               telemetry, plan):
    nodes, rates, volume, cap = fleets
    cfg = FleetConfig(control="coded", coded_policies=ALL_POLICIES,
                      telemetry=telemetry, serve_backend=serve,
                      alloc_backend=alloc)
    fault_plan = _plan(cfg, plan)
    batched = simulate_tenants(cfg, nodes, rates, volume,
                               capacity_per_tick=cap, control_code=CODES,
                               fault_plan=fault_plan, device="cpu")
    loop = [simulate_fleet(
        cfg, nodes[i], rates[i], volume[i], capacity_per_tick=cap[i],
        control_code=int(CODES[i]),
        fault_plan=(fault_plan if plan != "batched"
                    else FaultPlan(*(x[i] for x in fault_plan))),
        device="cpu") for i in range(F)]
    _assert_stack_equal(batched, loop, f"{serve}/{alloc}/{telemetry}/{plan}")


def test_all_shared_arguments_give_identical_fleets(fleets):
    """Every argument shared (the trace too) and ``n_fleets``: each slice
    is the one shared run, bitwise."""
    nodes, rates, volume, cap = fleets
    cfg = FleetConfig(serve_backend="fused", alloc_backend="pallas")
    out = simulate_tenants(cfg, nodes[0], rates[0], volume[0],
                           capacity_per_tick=cap[0], n_fleets=3,
                           device="cpu")
    one = simulate_fleet(cfg, nodes[0], rates[0], volume[0],
                         capacity_per_tick=cap[0], device="cpu")
    _assert_stack_equal(out, [one] * 3, "shared")


def test_stream_stats_gain_leading_fleet_axis(fleets):
    nodes, rates, volume, cap = fleets
    out = simulate_tenants(FleetConfig(telemetry="streaming"), nodes, rates,
                           volume, capacity_per_tick=cap, device="cpu")
    o, j = volume.shape[1:]
    for path, leaf in leaves_with_paths(out.stats):
        assert leaf.shape[0] == F, path
        if path not in (".windows", ".busy_windows"):
            assert leaf.shape[1] == o, path
    for counter in (out.stats.windows, out.stats.busy_windows):
        assert counter.shape == (F,) and counter.dtype == torch.int32
    assert out.queue_final.shape == (F, o, j)
    assert int(out.stats.windows[0]) == rates.shape[1] // 10


def test_streaming_finalizers_on_a_batched_carry_equal_per_fleet(fleets):
    """The port's ``streaming_*`` finalizers reduce over the trailing row
    axes only: on the batched carry they equal the per-fleet values."""
    nodes, rates, volume, cap = fleets
    cfg = FleetConfig(control="coded", coded_policies=ALL_POLICIES,
                      telemetry="streaming")
    stats = simulate_tenants(cfg, nodes, rates, volume, capacity_per_tick=cap,
                             control_code=CODES, device="cpu").stats
    loop = [simulate_fleet(cfg, nodes[i], rates[i], volume[i],
                           capacity_per_tick=cap[i],
                           control_code=int(CODES[i]), device="cpu").stats
            for i in range(F)]
    cap_w = cap * cfg.window_ticks
    agg = metrics.streaming_aggregate_mb(stats)
    fair = metrics.streaming_fairness(stats, nodes)
    util = metrics.streaming_mean_utilization(stats)
    util_all = metrics.streaming_mean_utilization(stats, busy_only=False)
    p99 = metrics.streaming_p99_queue(stats)
    slow = metrics.streaming_job_slowdown(stats, cap_w)
    assert agg.shape == fair.shape == util.shape == p99.shape == (F,)
    assert slow.shape == (F, volume.shape[-1])
    for i, s in enumerate(loop):
        assert agg[i] == metrics.streaming_aggregate_mb(s)
        assert fair[i] == metrics.streaming_fairness(s, nodes[i])
        assert util[i] == metrics.streaming_mean_utilization(s)
        assert util_all[i] == metrics.streaming_mean_utilization(
            s, busy_only=False)
        assert p99[i] == metrics.streaming_p99_queue(s)
        np.testing.assert_array_equal(
            slow[i], metrics.streaming_job_slowdown(s, cap_w[i]))


def _bad_cases(nodes, rates, volume, cap):
    """(label, args, kwargs, cfg) the reference refuses with ValueError."""
    plan = FaultPlan(*_np(tenant_fault_plan(JConfig(), f=TENANT_F)))
    mixed = plan._replace(up=plan.up[0])
    return [
        ("extents", (nodes, rates[:3], volume), {}, None),
        ("n_fleets", (nodes, rates, volume), dict(n_fleets=3), None),
        ("none batched", (nodes[0], rates[0], volume[0]), {}, None),
        ("rate rank", (nodes, rates[0, 0], volume), {}, None),
        ("nodes rank", (nodes[None], rates, volume), {}, None),
        ("cap rank", (nodes, rates, volume), dict(capacity_per_tick=cap[None]),
         None),
        ("mixed plan", (nodes, rates, volume), dict(fault_plan=mixed), None),
        ("unknown partition", (nodes, rates, volume), {}, "bogus"),
        ("ost_shard", (nodes, rates, volume), {}, "ost_shard"),
    ]


def test_errors_carry_the_reference_messages():
    nodes, rates, volume, cap, _ = _np(tenant_args())
    for label, args, kw, partition in _bad_cases(nodes, rates, volume, cap):
        jcfg, cfg = JConfig(), FleetConfig()
        if partition is not None:
            jcfg = jcfg._replace(partition=partition)
            cfg = cfg._replace(partition=partition)
        with pytest.raises(ValueError) as want:
            jsimulate_tenants(jcfg, *(jnp.asarray(x) for x in args), **kw)
        with pytest.raises(ValueError) as got:
            simulate_tenants(cfg, *args, **kw, device="cpu")
        assert str(got.value) == str(want.value), label
    with pytest.raises(ValueError,
                       match="torch.distributed.init_process_group"):
        simulate_tenants(FleetConfig(partition="fleet_shard"), nodes, rates,
                         volume, device="cpu")
    with pytest.raises(ValueError, match="integer"):
        simulate_tenants(FleetConfig(control="coded"), nodes, rates, volume,
                         control_code=np.zeros(TENANT_F), device="cpu")


def test_device_none_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, rates, volume, _, _ = _np(tenant_args())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        simulate_tenants(FleetConfig(), nodes, rates, volume)


#: one registry member a fleet of the reference's fixture
REFERENCE_CODES = np.arange(TENANT_F, dtype=np.int32) % len(ALL_POLICIES)


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's ``simulate_tenants`` on its own fixture, once a
    telemetry mode (each is one compile of the coded registry)."""
    nodes, rates, volume, cap, _ = tenant_args()
    codes = REFERENCE_CODES
    out = {}
    for telemetry in ("trajectory", "streaming"):
        cfg = JConfig(control="coded", coded_policies=ALL_POLICIES,
                      telemetry=telemetry)
        out[telemetry] = jax.tree.map(np.asarray, jsimulate_tenants(
            cfg, nodes, rates, volume, capacity_per_tick=cap,
            control_code=codes))
    return out


@pytest.mark.parametrize("telemetry", ["trajectory", "streaming"])
def test_reference_parity(reference_runs, telemetry):
    nodes, rates, volume, cap, _ = _np(tenant_args())
    codes = REFERENCE_CODES
    cfg = FleetConfig(control="coded", coded_policies=ALL_POLICIES,
                      telemetry=telemetry)
    got = simulate_tenants(cfg, nodes, rates, volume, capacity_per_tick=cap,
                           control_code=codes, device="cpu")
    want = reference_runs[telemetry]
    if telemetry == "trajectory":
        for f in ("served", "demand", "alloc", "record", "queue_final"):
            g, w = getattr(got, f).numpy(), getattr(want, f)
            assert g.shape == w.shape, f
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                          err_msg=f)
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-3,
                                       err_msg=f)
        # integer token allocations (whole-token budgets) exact
        g, w = got.alloc.numpy(), want.alloc
        whole = np.isfinite(w) & (w == np.floor(w))
        assert whole.any()
        np.testing.assert_array_equal(g[whole], w[whole])
        return
    for (path, g), w in zip(leaves_with_paths(got.stats),
                            jax.tree.leaves(want.stats)):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif path.endswith("lag_hist") and not path.startswith(".comp"):
            np.testing.assert_array_equal(g.sum(-1), w.sum(-1), err_msg=path)
        elif not path.startswith(".comp"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=path)
    np.testing.assert_allclose(got.queue_final.numpy(), want.queue_final,
                               rtol=0, atol=1e-3)


def test_megakernel_case_of_policy_subclasses():
    """A subclass of a built-in that overrides none of the policy methods
    runs its base's megakernel case; one that overrides any of them, or a
    custom policy, has none (and raises on the card, naming "Megakernel
    coverage")."""
    class Plain(AdapTBFPolicy):
        pass

    class Tuned(AIMDPolicy):
        md = 0.5                     # a constant the kernel takes as input

    class Gated(AdapTBFPolicy):
        def gate(self, alloc, ctx):
            return alloc

    class Custom(ControlPolicy):
        def init_alloc(self, ctx):
            return ctx.nodes

    for name in ALL_POLICIES:
        assert megakernel_case(get_policy(name)) == \
            type(get_policy(name)).__dict__["device_id"]
    assert megakernel_case(Plain()) == AdapTBFPolicy.device_id
    assert megakernel_case(Tuned()) == AIMDPolicy.device_id
    assert megakernel_case(Gated()) is None
    assert megakernel_case(Custom()) is None


def _reclaim_override(cls):
    class Reclaims(cls):
        @staticmethod
        def _reclaim(state, obs):
            return state
    return Reclaims()


def _new_helper(cls):
    class Helper(cls):
        def _scale(self, x):
            return 2 * x
    return Helper()


def _instance_attribute(cls):
    policy = type("Renamed", (cls,), {"name": "renamed"})()
    policy.gate = lambda alloc, ctx: alloc
    return policy


def _tuned_instance(cls):
    class Tuned(cls):
        def __init__(self):
            self.md = 0.5
    return Tuned()


@pytest.mark.parametrize("base", [AdapTBFPolicy, AIMDPolicy])
@pytest.mark.parametrize("make,case", [
    (_reclaim_override, None), (_new_helper, None),
    (_instance_attribute, None), (_tuned_instance, "base")])
def test_megakernel_case_refuses_any_other_definition(base, make, case):
    """A subclass, or an instance, that defines anything but the kernel's
    inputs (``name``, AIMD's constants, an ``__init__`` setting only them)
    has no megakernel case, even where what it overrides is a helper the
    policy methods call (adaptbf's ``_reclaim``), not one of them."""
    want = base.device_id if case == "base" else None
    assert megakernel_case(make(base)) == want


def test_per_row_codes_select_whole_rows_of_any_leaf_rank():
    """An [R, 1] code column selects rows of an [R] leaf as [R], not the
    [R, R] a plain broadcast would give."""
    cond = torch.tensor([[True], [False], [True]])
    a, b = torch.arange(3.0), -torch.arange(3.0)
    assert torch.equal(_where(cond, a, b), torch.tensor([0.0, -1.0, 2.0]))
    a2, b2 = torch.ones(3, 4), torch.zeros(3, 4)
    assert torch.equal(_where(cond, a2, b2)[:, 0], torch.tensor([1., 0, 1]))


def test_fleet_kernels_take_rates_by_fleet_stride():
    """What the fleet kernels read: [W, R, J], or [F, W, O, J] with each
    fleet contiguous and any fleet stride that is a multiple of J."""
    trace = torch.zeros(7, 10, 4, 6)
    assert check_rates(trace[2], 4, 6) == (10, 4, 0)
    shared = trace[2].expand(3, 10, 4, 6)
    assert check_rates(shared, 12, 6) == (10, 4, 0)
    batched = torch.zeros(3, 7, 10, 4, 6)[:, 2]
    assert check_rates(batched, 12, 6) == (10, 4, 7 * 10 * 4)
    no_ticks = torch.zeros(0, 4, 6).as_strided((0, 4, 6), (0, 0, 0))
    assert check_rates(no_ticks, 4, 6) == (0, 4, 0)
    with pytest.raises(ValueError, match="cover"):
        check_rates(batched, 8, 6)
    with pytest.raises(ValueError, match="contiguous"):
        check_rates(torch.zeros(3, 10, 4, 12)[..., :6], 12, 6)
    with pytest.raises(TypeError, match="float32"):
        check_rates(batched.double(), 12, 6)


# ------------------------------------------------- fleet_shard on 4 ranks

#: (mesh_shape, backend, telemetry), each under per-fleet codes and a
#: batched fault plan
SHARDED = [(mesh, backend, telemetry) for mesh in ((2, 2), (1, 4))
           for backend in SHARD_BACKENDS
           for telemetry in ("trajectory", "streaming")]


def _sharded_cfg(backend, telemetry, partition="none"):
    serve, alloc = SHARD_BACKENDS[backend]
    return dict(control="coded", coded_policies=ALL_POLICIES,
                telemetry=telemetry, serve_backend=serve, alloc_backend=alloc,
                partition=partition)


def _sharded_args(fleets, backend, telemetry):
    nodes, rates, volume, cap = fleets
    plan = _plan(FleetConfig(**_sharded_cfg(backend, telemetry)), "batched")
    return (nodes, rates, volume), dict(capacity_per_tick=cap,
                                        control_code=CODES, fault_plan=plan)


def _shared_args(fleets):
    nodes, rates, volume, cap = fleets
    return (nodes[0], rates[0], volume[0]), dict(capacity_per_tick=cap[0],
                                                 n_fleets=4)


@pytest.fixture(scope="module")
def four_ranks(fleets, tmp_path_factory):
    jobs = []
    for mesh, backend, telemetry in SHARDED:
        args, kw = _sharded_args(fleets, backend, telemetry)
        jobs.append((f"{mesh}/{backend}/{telemetry}", "tenants",
                     _sharded_cfg(backend, telemetry, "fleet_shard"), args,
                     dict(kw, mesh_shape=mesh)))
    args, kw = _shared_args(fleets)
    jobs.append(("shared", "tenants",
                 dict(telemetry="streaming", serve_backend="fused",
                      alloc_backend="pallas", partition="fleet_shard"),
                 args, dict(kw, mesh_shape=(2, 2))))
    nodes, rates, volume, cap = fleets
    shard = dict(partition="fleet_shard")
    jobs += [
        ("default mesh", "tenants", dict(shard, telemetry="streaming"),
         (nodes[:4], rates[:4], volume[:4]), dict(capacity_per_tick=cap[:4])),
        ("fleets not divisible", "tenants", shard, (nodes, rates, volume),
         dict(mesh_shape=(4, 1))),
        ("osts not divisible", "tenants", shard,
         (nodes[:, :2], rates[:, :, :2], volume[:, :2]),
         dict(mesh_shape=(1, 4))),
        ("mesh short of the world", "tenants", shard, (nodes, rates, volume),
         dict(mesh_shape=(1, 2))),
    ]
    ranks = Ranks(4, jobs, tmp_path_factory.mktemp("tenant_ranks"))
    yield ranks
    ranks.stop()


@pytest.mark.parametrize("mesh,backend,telemetry", SHARDED)
def test_fleet_shard_is_bitwise_the_unsharded_batch(fleets, four_ranks, mesh,
                                                    backend, telemetry):
    args, kw = _sharded_args(fleets, backend, telemetry)
    want = simulate_tenants(FleetConfig(**_sharded_cfg(backend, telemetry)),
                            *args, **kw, device="cpu")
    tag = f"{mesh}/{backend}/{telemetry}"
    assert_bitwise(four_ranks.result(tag), want, tag)


def test_fleet_shard_with_every_argument_shared(fleets, four_ranks):
    """One shared trace (fleet stride 0 on every rank's block) and
    ``n_fleets``."""
    args, kw = _shared_args(fleets)
    want = simulate_tenants(
        FleetConfig(telemetry="streaming", serve_backend="fused",
                    alloc_backend="pallas"), *args, **kw, device="cpu")
    assert_bitwise(four_ranks.result("shared"), want, "shared")


def test_fleet_shard_default_mesh_puts_every_rank_on_fleets(fleets,
                                                           four_ranks):
    nodes, rates, volume, cap = fleets
    want = simulate_tenants(FleetConfig(telemetry="streaming"), nodes[:4],
                            rates[:4], volume[:4], capacity_per_tick=cap[:4],
                            device="cpu")
    assert_bitwise(four_ranks.result("default mesh"), want, "default mesh")


@pytest.mark.parametrize("key,message", [
    ("fleets not divisible", 'partition="fleet_shard" needs n_fleets (6) '
     "divisible by the mesh fleet axis (4 devices)"),
    ("osts not divisible", 'partition="fleet_shard" needs n_ost (2) '
     "divisible by the mesh ost axis (4 devices)"),
    ("mesh short of the world", 'partition="fleet_shard" runs one shard on '
     "every rank: the mesh {'fleet': 1, 'ost': 2} covers 2 of the 4 ranks"),
])
def test_fleet_shard_refuses_a_mesh_that_does_not_fit(four_ranks, key,
                                                      message):
    """The reference's divisibility messages; the port's grid must also
    cover every rank (each receives the whole result)."""
    assert four_ranks.results()[key] == ("error", "ValueError", message)
