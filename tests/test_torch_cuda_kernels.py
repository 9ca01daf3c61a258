"""The port's CUDA kernels against their plain PyTorch versions on the card,
at widths that take every lanes-per-thread variant the kernels compile
(J = 1 to 8192, one block a row) and rows over a thread-block cluster of 2,
4 and 8 blocks (J = 8193 to the 65536 maximum) -- the window megakernel for
every policy case and for coded dispatch -- plus the wrappers' input checks
(J = 65537 raises before any launch) and the kernel
paths of ``simulate_fleet``, and the allocation round and the
megakernel on rows built to stress the radix select and the excess
descent; the tenant axis (the fleet kernels over F fleets' rows, the rate
trace by fleet stride, the megakernel under per-fleet codes, and
``simulate_tenants`` bitwise the per-fleet loop); ``partition=
"ost_shard"`` on two gloo ranks sharing the card, bitwise the unsharded
kernel run; and the LM kernels (flash attention, flash decode, the SSD scan)
over head dims 16-128, GQA groups 1 and 4, ragged lengths, S at the tile
and chunk edges and S != T, decode lengths around the host plan's split
length, SSD state dims 16-128, and both element types, with their
wrappers' input checks (the bfloat16 attention's and SSD scan's TMA and
the decode's 16-byte copies want 16-byte aligned bases and strides); and
the training kernels: the attention backward (bfloat16 on the tensor
cores, float32 SIMT) over GQA, S != T, ragged S and head dims 16-128, the
SSD backward against autograd of the plain scan (warm start, no skip, gy
only, gstate only, S = 1, P = 16 with N = 128, 32 chunks of carry, S =
64 k + 1, cum in the thousands), its bfloat16 tensor-core kernels by the
profiler's kernel names and its TMA checks, both bitwise across two
calls, and a trainer's crash and restore bitwise on the card; the MoE
block (bitwise across two calls, the CPU's experts and output) and the
MoE and frontend smoke models' attention launches.  Narrow rows (J <= 32,
one warp a row in B1, B2 and B3): every policy case, coded fleets with an
out-of-range code and faults, the search stress rows, 1 to 4096 rows, B1's
warp rows bitwise its one-block instance at fleet strides 0 and T*O, each
library's launches by row layout (the warp-row instances, never the plain
versions), and the small tenants' run on the warp rows alone.

A CUDA kernel has no CPU mode, so every test here needs a GPU and skips
without one.  JAX is not needed (and not installed on a GPU host); run
from the repository root with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.policies import (
    AdapTBFPolicy,
    CodedPolicy,
    PolicyContext,
    get_policy,
)
from repro_torch.core.state import AllocatorState
from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
from repro_torch.kernels.dispatch import BLOCK_JOBS, MAX_JOBS
from repro_torch.kernels.fleet_window import ops as fw_ops
from repro_torch.kernels.window_mega import ops as mega_ops
from repro_torch.storage import (
    DEFAULT_CODED_POLICIES,
    FleetConfig,
    random_fleet,
    simulate_fleet,
)

pytestmark = pytest.mark.requires_cuda

# one block a row at LPT 1, 1, 2, 4, 8, 16; then a cluster of 2 (8193 to
# 16384), 4 (16385 to 32768) and 8 (to 65536) blocks a row, ragged slices
# included (J % c != 0, slices of J not a multiple of 4)
WIDE_WIDTHS = [8193, 12289, 16384, 16385, 32768, 40000, MAX_JOBS]
WIDTHS = [1, 100, 513, 2048, 4096, BLOCK_JOBS, *WIDE_WIDTHS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _window_case(o, j, w, seed, dev):
    rng = np.random.default_rng(seed)
    queue = (rng.random((o, j)) * 12).astype(np.float32)
    vol = np.where(rng.random((o, j)) < 0.3, np.inf,
                   rng.integers(0, 200, (o, j))).astype(np.float32)
    budget = np.where(rng.random((o, j)) < 0.5, np.inf,
                      rng.integers(0, 30, (o, j))).astype(np.float32)
    rates = rng.integers(0, 3, (w, o, j)).astype(np.float32)
    backlog = rng.choice([16.0, 64.0, 256.0], (o, j)).astype(np.float32)
    cap = rng.integers(4, 40, (o,)).astype(np.float32)
    return [torch.as_tensor(x, device=dev)
            for x in (queue, vol, budget, rates, backlog, cap)]


def _alloc_case(o, j, seed, dev):
    rng = np.random.default_rng(seed)
    demand = rng.integers(0, 3000, (o, j)).astype(np.float32)
    demand[rng.random((o, j)) < 0.3] = 0.0
    nodes = rng.integers(1, 128, (o, j)).astype(np.float32)
    record = rng.integers(-200, 200, (o, j)).astype(np.float32)
    remainder = (rng.random((o, j)) - 0.5).astype(np.float32)
    prev = rng.integers(0, 500, (o, j)).astype(np.float32)
    cap = rng.choice([17.0, 1000.0, 50000.0], (o,)).astype(np.float32)
    return [torch.as_tensor(x, device=dev)
            for x in (demand, nodes, record, remainder, prev, cap)]


@pytest.mark.parametrize("j", WIDTHS)
def test_window_kernel_matches_plain(cuda, j):
    args = _window_case(3, j, 10, seed=j, dev=cuda)
    got = fw_ops.fleet_window_serve(*args)
    want = fw_ops.fleet_window_ref(*args)
    for name, g, w in zip(("queue", "vol_left", "served"), got, want):
        assert torch.equal(g.isfinite(), w.isfinite()), name
        fin = w.isfinite()
        torch.testing.assert_close(g[fin], w[fin], rtol=0, atol=1e-4,
                                   msg=name)


@pytest.mark.parametrize("j", WIDTHS)
def test_alloc_kernel_matches_plain(cuda, j):
    args = _alloc_case(5, j, seed=j, dev=cuda)
    got = alloc_ops.fleet_alloc(*args)
    want = alloc_ops.fleet_alloc_ref(*args)[:3]
    for name, g, w in zip(("alloc", "record", "remainder"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3, msg=name)
    assert torch.equal(got[0], got[0].floor())
    total = got[0].double().sum(-1)
    want_total = torch.where((args[0] > 0).any(-1), args[5].double(), 0.0)
    torch.testing.assert_close(total, want_total, rtol=0, atol=1e-2)


def _alloc_stress(j, seed):
    """Six rows built for the allocation's searches: (0) every remainder
    key tied, (1) remainders of -0.0 beside +0.0, (2) no active job (every
    key -inf, budget 0), (3) zero capacity over carried remainders of 3.5
    (a multi-round excess), (4) J - 1 tokens over J equal shares (k =
    count - 1 among ties), (5) a random row."""
    rng = np.random.default_rng(seed)
    o = 6
    demand = rng.integers(1, 3000, (o, j)).astype(np.float32)
    nodes = np.full((o, j), 8.0, np.float32)
    record = np.zeros((o, j), np.float32)
    remainder = np.full((o, j), 0.25, np.float32)
    prev = np.full((o, j), 100.0, np.float32)
    cap = np.array([1000.0, 1000.0, 1000.0, 0.0, j - 1.0, 50000.0],
                   np.float32)
    remainder[1, ::2] = -0.0
    remainder[1, 1::2] = 0.0
    demand[2] = 0.0
    remainder[3] = 3.5
    remainder[4] = 0.0
    demand[5, rng.random(j) < 0.3] = 0.0
    nodes[5] = rng.integers(1, 128, j)
    record[5] = rng.integers(-200, 200, j)
    remainder[5] = rng.random(j) - 0.5
    prev[5] = rng.integers(0, 500, j)
    return demand, nodes, record, remainder, prev, cap


# 1 to 32: one warp a row in B2 and B3; 33: the first one-block width
STRESS_WIDTHS = [1, 7, 8, 31, 32, 33, 4093, 4095, 4096, BLOCK_JOBS,
                 *WIDE_WIDTHS]


@pytest.mark.parametrize("j", STRESS_WIDTHS)
def test_alloc_kernel_on_search_stress_rows(cuda, j):
    """Allocations integer-equal to the plain round, record and remainder
    within 1e-3, on rows that drive the radix select through ties, -inf
    rows, zero budgets and multi-round excess."""
    args = [torch.as_tensor(x, device=cuda) for x in _alloc_stress(j, j)]
    got = alloc_ops.fleet_alloc(*args)
    want = alloc_ops.fleet_alloc_ref(*args)[:3]
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(("record", "remainder"), got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3, msg=name)


@pytest.mark.parametrize("o,j,w,cap_scale", [
    (1, 4093, 10, 1), (133, 3, 10, 1), (265, 4093, 1, 1), (133, 4096, 0, 1),
    (265, 64, 10, 1), (3, 8192, 10, 1), (5, 4093, 10, 1000)])
def test_window_kernel_edge_shapes(cuda, o, j, w, cap_scale):
    """Rows of J % 4 != 0 (off a 16-byte boundary), O one past a full wave (133 rows at one block an
    SM, 265 at two), W of 0 and 1, a capacity phase 1 fits (its scale
    exactly 1); budgets of +inf and 0 and backlog caps below the queue on
    some lanes."""
    queue, vol, budget, rates, backlog, cap = _window_case(o, j, w, o + j,
                                                           cuda)
    cap = cap * cap_scale
    budget[:, ::7] = 0.0
    backlog[:, ::5] = queue[:, ::5] * 0.5
    before = fw_ops.launches
    got = fw_ops.fleet_window_serve(queue, vol, budget, rates, backlog, cap)
    assert fw_ops.launches == before + 1
    want = fw_ops.fleet_window_ref(queue, vol, budget, rates, backlog, cap)
    for name, g, w_ in zip(("queue", "vol_left", "served"), got, want):
        assert torch.equal(g.isfinite(), w_.isfinite()), name
        fin = w_.isfinite()
        torch.testing.assert_close(g[fin], w_[fin], rtol=0, atol=1e-4,
                                   msg=name)


@pytest.mark.parametrize("o,j", [(133, 64), (265, 4093), (1, 4093),
                                 (265, 1)])
def test_alloc_kernel_edge_shapes(cuda, o, j):
    """O one past a full wave and J % 4 != 0: allocations equal to the
    plain round, record and remainder within 1e-3."""
    args = _alloc_case(o, j, seed=o + j, dev=cuda)
    before = alloc_ops.launches
    got = alloc_ops.fleet_alloc(*args)
    assert alloc_ops.launches == before + 1
    want = alloc_ops.fleet_alloc_ref(*args)[:3]
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(("record", "remainder"), got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3, msg=name)


def _mega_stress_args(j, dev):
    """The window megakernel's adaptbf round on ``_alloc_stress`` rows (row
    2 gets no traffic, so it observes no demand)."""
    demand, nodes, record, remainder, prev, cap = _alloc_stress(j, j + 1)
    rng = np.random.default_rng(j)
    o, w = 6, 10

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    cap_tick = t(cap / w)
    ctx = PolicyContext(nodes=t(nodes), cap_w=cap_tick * w)
    queue = rng.random((o, j)) * 12
    rates = rng.integers(0, 4, (w, o, j)).astype(np.float32)
    queue[2] = 0.0
    rates[:, 2] = 0.0
    alloc = t(rng.integers(0, 20, (o, j)))
    zeros = torch.zeros((o, j), device=dev)
    return [get_policy("adaptbf"), ctx, cap_tick,
            t(rng.choice([16.0, 64.0], (o, j))), t(queue),
            t(np.full((o, j), np.inf)), alloc, (zeros, zeros, alloc),
            AllocatorState(t(record), t(remainder), t(prev)), t(rates)]


def _mega_close(got, want):
    assert torch.equal(got[8], want[8])
    for i, (g, w_) in enumerate(zip(_mega_leaves(got), _mega_leaves(want),
                                    strict=True)):
        assert torch.equal(g.isfinite(), w_.isfinite()), i
        fin = w_.isfinite()
        torch.testing.assert_close(g[fin], w_[fin], rtol=0, atol=1e-3,
                                   msg=f"leaf {i}")


@pytest.mark.parametrize("j", STRESS_WIDTHS)
def test_mega_kernel_on_search_stress_rows(cuda, j):
    """The window megakernel's adaptbf case on the same rows (row 2 gets
    no traffic, so it observes no demand), against its plain round."""
    args = _mega_stress_args(j, cuda)
    _mega_close(mega_ops.mega_window_round(*args),
                mega_ops.ref.mega_round_ref(*args))


@pytest.mark.parametrize("j", WIDE_WIDTHS)
def test_cluster_rows_bitwise_and_repeatable(cuda, j):
    """Rows over a cluster of 2, 4 or 8 blocks (ragged slices included), on
    the search stress rows: every remainder tied (exact ties across every
    slice edge), -0.0 beside +0.0, a zero budget over carried remainders
    whose floors overshoot it (the excess descent runs, over several
    rounds), J - 1 tokens over J equal shares (k = count - 1 among ties
    that cross every edge), and a random row.  B2 and B3's adaptbf case:
    the integer allocation equal to the plain version's (``torch.equal``),
    every other field within its bound, and two back-to-back calls bitwise
    equal in every output."""
    args = [torch.as_tensor(x, device=cuda) for x in _alloc_stress(j, j)]
    got = alloc_ops.fleet_alloc(*args)
    again = alloc_ops.fleet_alloc(*args)
    want = alloc_ops.fleet_alloc_ref(*args)[:3]
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(("record", "remainder"), got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3, msg=name)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    margs = _mega_stress_args(j, cuda)
    mgot = mega_ops.mega_window_round(*margs)
    magain = mega_ops.mega_window_round(*margs)
    _mega_close(mgot, mega_ops.ref.mega_round_ref(*margs))
    assert all(torch.equal(g, a) for g, a in
               zip(_mega_leaves(mgot), _mega_leaves(magain), strict=True))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda, monkeypatch):
    args = _alloc_case(2, 64, seed=1, dev=cuda)
    with pytest.raises(TypeError, match="float32"):
        alloc_ops.fleet_alloc(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        alloc_ops.fleet_alloc(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="several devices"):
        alloc_ops.fleet_alloc(args[0].cpu(), *args[1:])
    # J = 65537: ValueError naming the limit, before any launch and without
    # the plain version
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fw_ops.ref, "fleet_window_ref", plain)
    monkeypatch.setattr(alloc_ops.ref, "fleet_alloc_ref", plain)
    before = (fw_ops.launches, alloc_ops.launches)
    wide = _window_case(1, 65537, 1, seed=2, dev=cuda)
    with pytest.raises(ValueError, match="65536"):
        fw_ops.fleet_window_serve(*wide)
    wide = _alloc_case(1, 65537, seed=2, dev=cuda)
    with pytest.raises(ValueError, match="65536"):
        alloc_ops.fleet_alloc(*wide)
    assert (fw_ops.launches, alloc_ops.launches) == before


MEGA_CASES = ["adaptbf", "static", "nobw", "static_wc", "aimd", "coded0",
              "coded2"]


def _mega_round(name, j, seed, dev, o=3):
    """An evolved round of o rows at width j: integer allocations with
    stopped rules, nonzero records and fractional remainders (adaptbf),
    carried rates and unruled rows (aimd); coded over the default members.
    The fault columns lose row 0's telemetry and take row 1 down (every
    third row from there when o > 3)."""
    rng = np.random.default_rng(seed)
    w = 10

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    code = int(name[5:]) if name.startswith("coded") else None
    policy = (CodedPolicy(DEFAULT_CODED_POLICIES) if code is not None
              else get_policy(name))
    cap_tick = t(rng.integers(1, 3, (o,)) * max(j // 2, 2))
    ctx = PolicyContext(nodes=t(rng.integers(1, 64, (o, j))),
                        cap_w=cap_tick * w, control_code=code)
    alloc = np.where(rng.random((o, j)) < 0.3, 0.0,
                     rng.integers(1, 20, (o, j))).astype(np.float32)
    pstate = policy.init_state(ctx)
    evolved = AllocatorState(t(rng.integers(-50, 50, (o, j))),
                             t(rng.random((o, j)) - 0.5),
                             t(rng.integers(0, 30, (o, j))))
    if name == "adaptbf":
        pstate = evolved
    elif code is not None:
        pstate = (evolved, (), ())
    elif name == "aimd":
        pstate = t(1.0 + rng.random((o, j)) * 30.0)
        alloc[0] = np.inf
    alloc = (policy.init_alloc(ctx) if name in ("static", "nobw")
             else t(alloc))
    zeros = torch.zeros((o, j), device=dev)
    args = [policy, ctx, cap_tick, t(rng.choice([16.0, 64.0], (o, j))),
            t(rng.random((o, j)) * 12),
            t(np.where(rng.random((o, j)) < 0.3, np.inf, 150.0)), alloc,
            (zeros, zeros, alloc), pstate,
            t(rng.integers(0, 4, (w, o, j)))]
    faults = (t(np.resize([0.0, 1.0, 1.0], o)), t(np.resize([1.0, 0.0, 1.0], o)))
    return args, faults


def _mega_leaves(out):
    return [*out[:7], *mega_ops._leaves(out[7]), out[8]]


@pytest.mark.parametrize("j", WIDTHS)
@pytest.mark.parametrize("name", MEGA_CASES)
def test_mega_kernel_matches_plain(cuda, name, j):
    """One round, then a round with OST 0's telemetry lost and OST 1 down,
    at every lanes-per-thread width, for every policy case and coded."""
    args, faults = _mega_round(name, j, seed=j, dev=cuda)
    for extra in ((), faults):
        before = mega_ops.launches
        got = mega_ops.mega_window_round(*args, *extra)
        assert mega_ops.launches == before + 1
        want = mega_ops.ref.mega_round_ref(*args, *extra)
        for i, (g, w) in enumerate(zip(_mega_leaves(got), _mega_leaves(want),
                                       strict=True)):
            assert torch.equal(g.isfinite(), w.isfinite()), (name, i)
            fin = w.isfinite()
            torch.testing.assert_close(g[fin], w[fin], rtol=0, atol=1e-3,
                                       msg=f"{name} leaf {i}")
        args[4:9] = [want[0], want[1], want[8], tuple(want[4:7]), want[7]]


def test_mega_raises_for_what_the_kernel_has_no_case_for(cuda, monkeypatch):
    """A policy without a device id of its own (NotImplementedError) and
    rows past 65536 jobs (ValueError) raise on CUDA tensors, before any
    launch, and never fall back to the plain round."""
    class Custom(AdapTBFPolicy):
        def step(self, state, obs, ctx):
            return super().step(state, obs, ctx)

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain round")

    monkeypatch.setattr(mega_ops.ref, "mega_round_ref", plain)
    args, _ = _mega_round("adaptbf", 64, seed=1, dev=cuda)
    before = mega_ops.launches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mega_ops.mega_window_round(Custom(), *args[1:])
    wide, _ = _mega_round("adaptbf", 65537, seed=2, dev=cuda)
    with pytest.raises(ValueError, match="65536"):
        mega_ops.mega_window_round(*wide)
    bad = list(args)
    bad[8] = AllocatorState(*(x[:, :8].contiguous() for x in args[8]))
    with pytest.raises(ValueError, match="O, J"):
        mega_ops.mega_window_round(*bad)
    assert mega_ops.launches == before


def test_simulate_fleet_mega_path_matches_plain_path(cuda):
    """serve_backend="mega" launches the megakernel once a window and
    nothing else, and matches the plain path; coded equals direct."""
    scn = random_fleet(3, n_ost=8, n_jobs=300, profile="mixed",
                       duration_s=1.0)
    args = (scn.nodes, scn.issue_rate, scn.volume, scn.capacity_per_tick,
            scn.max_backlog)
    fw_ops.launches = alloc_ops.launches = mega_ops.launches = 0
    mega = simulate_fleet(FleetConfig(serve_backend="mega"), *args)
    n_windows = mega.served.shape[0]
    assert (mega_ops.launches, fw_ops.launches, alloc_ops.launches) == (
        n_windows, 0, 0)
    plain = simulate_fleet(FleetConfig(), *args, device="cuda")
    coded = simulate_fleet(FleetConfig(control="coded",
                                       serve_backend="mega"), *args,
                           control_code=0)
    for f in ("served", "demand", "alloc", "record", "queue_final"):
        a, b = getattr(mega, f), getattr(plain, f)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3, equal_nan=True,
                                   msg=f)
        assert torch.equal(getattr(coded, f), a), f


def test_simulate_fleet_kernel_path_matches_plain_path(cuda):
    scn = random_fleet(3, n_ost=8, n_jobs=300, profile="mixed",
                       duration_s=1.0)
    args = (scn.nodes, scn.issue_rate, scn.volume, scn.capacity_per_tick,
            scn.max_backlog)
    fw_ops.launches = alloc_ops.launches = 0
    kern = simulate_fleet(FleetConfig(serve_backend="fused",
                                      alloc_backend="pallas"), *args)
    n_windows = kern.served.shape[0]
    assert (fw_ops.launches, alloc_ops.launches) == (n_windows, n_windows)
    plain = simulate_fleet(FleetConfig(), *args, device="cuda")
    for f in ("served", "demand", "alloc", "record", "queue_final"):
        a, b = getattr(kern, f), getattr(plain, f)
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3, equal_nan=True,
                                   msg=f)


@pytest.mark.parametrize("serve,alloc", [("fused", "pallas"),
                                         ("mega", "core")])
def test_ost_shard_on_the_card_is_bitwise_the_kernel_run(cuda, tmp_path,
                                                         serve, alloc):
    """Two gloo ranks sharing the card (``device=None``: ``cuda:0`` for
    both), each launching its path's kernels once a window on its own 4 of
    8 OST rows; the gathered result on every rank bitwise the unsharded
    kernel run, in both telemetry modes."""
    from test_torch_sharding import Ranks, assert_bitwise

    from repro_torch.kernels import _build
    _build.build(["fleet_window", "adaptbf_alloc", "window_mega"])
    scn = random_fleet(3, n_ost=8, n_jobs=300, profile="mixed",
                       duration_s=1.0)
    args = (scn.nodes, scn.issue_rate, scn.volume, scn.capacity_per_tick,
            scn.max_backlog)
    modes = ("trajectory", "streaming")
    ranks = Ranks(2, [(tel, "fleet", dict(
        serve_backend=serve, alloc_backend=alloc, telemetry=tel,
        partition="ost_shard"), args, {}) for tel in modes], tmp_path,
        device=None)
    try:
        for tel in modes:
            want = simulate_fleet(FleetConfig(serve_backend=serve,
                                              alloc_backend=alloc,
                                              telemetry=tel), *args)
            assert_bitwise(ranks.result(tel), want, tel)
            n = scn.issue_rate.shape[0] // 10
            per_window = ({"fleet_window": n, "adaptbf_alloc": n,
                           "window_mega": 0} if serve == "fused" else
                          {"fleet_window": 0, "adaptbf_alloc": 0,
                           "window_mega": n})
            assert ranks.launches(tel) == [per_window] * 2, tel
    finally:
        ranks.stop()


@pytest.mark.parametrize("serve,alloc", [("fused", "pallas"),
                                         ("mega", "core")])
@pytest.mark.parametrize("telemetry", ["trajectory", "streaming"])
def test_fleet_service_on_the_card_equals_simulate_fleet(cuda, serve, alloc,
                                                         telemetry, tmp_path):
    """The online service steps the kernels once a window and equals the
    offline run bitwise, across a save and restore inside an outage; the
    streaming stats keep their int32 counters on the card."""
    from repro_torch.pytree import leaves_with_paths
    from repro_torch.storage import FleetService, faults
    scn = random_fleet(3, n_ost=8, n_jobs=300, profile="mixed",
                       duration_s=1.0)
    n_windows = scn.issue_rate.shape[0] // 10
    plan = faults.outage(n_windows, 8, 3, 7, osts=[1, 5])
    cfg = FleetConfig(serve_backend=serve, alloc_backend=alloc,
                      telemetry=telemetry)
    args = (scn.nodes, scn.volume, scn.capacity_per_tick, scn.max_backlog)
    offline = simulate_fleet(cfg, scn.nodes, scn.issue_rate, scn.volume,
                             scn.capacity_per_tick, scn.max_backlog,
                             fault_plan=plan)
    rates = torch.as_tensor(scn.issue_rate, device=cuda)
    svc = FleetService(cfg, *args, checkpoint_dir=str(tmp_path),
                       fault_plan=plan)
    k = 5
    fw_ops.launches = alloc_ops.launches = mega_ops.launches = 0
    outs = [svc.step(rates[w * 10:(w + 1) * 10]) for w in range(k)]
    svc.save()
    svc = FleetService(cfg, *args, checkpoint_dir=str(tmp_path),
                       fault_plan=plan)
    assert svc.restore() == k
    outs += [svc.step(scn.issue_rate[w * 10:(w + 1) * 10])   # numpy in
             for w in range(k, n_windows)]
    want = ((0, 0, n_windows) if serve == "mega"
            else (n_windows, n_windows, 0))
    assert (fw_ops.launches, alloc_ops.launches, mega_ops.launches) == want
    if telemetry == "trajectory":
        for i, f in enumerate(("served", "demand", "alloc", "record")):
            assert torch.equal(torch.stack([o[i] for o in outs]),
                               getattr(offline, f)), f
    else:
        for (path, a), (_, b) in zip(leaves_with_paths(offline.stats),
                                     leaves_with_paths(svc.stats)):
            assert b.device.type == "cuda" and a.dtype == b.dtype, path
            assert torch.equal(a, b), path
        assert svc.stats.windows.dtype == torch.int32
        assert int(svc.stats.windows) == n_windows
    assert torch.equal(svc.queue, offline.queue_final)


# ------------------------------------------------------- the tenant axis

FLEET_WIDTHS = [1, 8, 4097, 12289]


def _fleet_rates(n_fleets, o, j, w, layout, seed, dev):
    """Window 1 of a two-window trace: [F, W, O, J] with the fleet axis a
    stride-0 expand of one shared trace, or a slice of an [F, T, O, J]
    trace (fleet stride T*O*J)."""
    rng = np.random.default_rng(seed)
    if layout == "shared":
        trace = rng.integers(0, 3, (2, w, o, j)).astype(np.float32)
        return torch.as_tensor(trace, device=dev)[1].expand(n_fleets, w, o, j)
    trace = rng.integers(0, 3, (n_fleets, 2, w, o, j)).astype(np.float32)
    return torch.as_tensor(trace, device=dev)[:, 1]


@pytest.mark.parametrize("layout", ["shared", "batched"])
@pytest.mark.parametrize("n_fleets", [1, 3])
@pytest.mark.parametrize("j", FLEET_WIDTHS)
def test_window_kernel_reads_rates_by_fleet_stride(cuda, j, n_fleets, layout):
    """F fleets of O=5 rows in one launch: against the plain version (atol
    1e-4, as the single-fleet test), and each fleet's rows bitwise equal to
    that fleet launched alone."""
    o, w = 5, 10
    args = _window_case(n_fleets * o, j, 1, seed=j + n_fleets, dev=cuda)
    rates = _fleet_rates(n_fleets, o, j, w, layout, seed=j, dev=cuda)
    args[3] = rates
    before = fw_ops.launches
    got = fw_ops.fleet_window_serve(*args)
    assert fw_ops.launches == before + 1
    want = fw_ops.fleet_window_ref(*args)
    for name, g, x in zip(("queue", "vol_left", "served"), got, want):
        assert torch.equal(g.isfinite(), x.isfinite()), name
        fin = x.isfinite()
        torch.testing.assert_close(g[fin], x[fin], rtol=0, atol=1e-4,
                                   msg=name)
    for f in range(n_fleets):
        rows = slice(f * o, (f + 1) * o)
        alone = fw_ops.fleet_window_serve(
            *(x[rows].contiguous() for x in args[:3]), rates[f],
            args[4][rows].contiguous(), args[5][rows].contiguous())
        for g, a in zip(got, alone):
            assert torch.equal(g[rows], a), f


@pytest.mark.parametrize("n_fleets", [1, 3])
@pytest.mark.parametrize("j", FLEET_WIDTHS)
def test_alloc_kernel_on_fleet_rows(cuda, j, n_fleets):
    """The allocation round over F*O rows: against the plain version (atol
    1e-3) and each fleet bitwise equal to its own launch."""
    o = 5
    args = _alloc_case(n_fleets * o, j, seed=j + n_fleets, dev=cuda)
    got = alloc_ops.fleet_alloc(*args)
    want = alloc_ops.fleet_alloc_ref(*args)[:3]
    for name, g, x in zip(("alloc", "record", "remainder"), got, want):
        torch.testing.assert_close(g, x, rtol=0, atol=1e-3, msg=name)
    for f in range(n_fleets):
        rows = slice(f * o, (f + 1) * o)
        alone = alloc_ops.fleet_alloc(*(x[rows].contiguous() for x in args))
        for g, a in zip(got, alone):
            assert torch.equal(g[rows], a), f


MEGA_MEMBERS = ("aimd", "static", "adaptbf")


def _fleet_mega_round(codes, j, layout, seed, dev):
    """One coded round over len(codes) fleets of O=4 rows, each fleet on
    its own code, with evolved member states; returns the wrapper's
    arguments and the code rows."""
    from repro_torch.storage.tenants import _code_rows
    rng = np.random.default_rng(seed)
    o, w, n_f = 4, 10, len(codes)
    r = n_f * o

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    policy = CodedPolicy(MEGA_MEMBERS)
    cap_tick = t(rng.integers(1, 3, (r,)) * max(j // 2, 2))
    code_col = torch.as_tensor(np.repeat(np.asarray(codes, np.int32), o),
                               device=dev)[:, None]
    ctx = PolicyContext(nodes=t(rng.integers(1, 64, (r, j))),
                        cap_w=cap_tick * w, control_code=code_col)
    alloc = t(np.where(rng.random((r, j)) < 0.3, 0.0,
                       rng.integers(1, 20, (r, j))))
    pstate = (t(1.0 + rng.random((r, j)) * 30.0), (),
              AllocatorState(t(rng.integers(-50, 50, (r, j))),
                             t(rng.random((r, j)) - 0.5),
                             t(rng.integers(0, 30, (r, j)))))
    zeros = torch.zeros((r, j), device=dev)
    args = [policy, ctx, cap_tick, t(rng.choice([16.0, 64.0], (r, j))),
            t(rng.random((r, j)) * 12),
            t(np.where(rng.random((r, j)) < 0.3, np.inf, 150.0)), alloc,
            (zeros, zeros, alloc), pstate,
            _fleet_rates(n_f, o, j, w, layout, seed, dev)]
    return args, _code_rows(codes, o, dev)


def _fleet_slice(args, f, o, code):
    """The wrapper's arguments for fleet f alone, its code a host int."""
    rows = slice(f * o, (f + 1) * o)

    def cut(tree):
        if torch.is_tensor(tree):
            return tree[rows].contiguous()
        if isinstance(tree, tuple):
            return type(tree)(*map(cut, tree)) if hasattr(tree, "_fields") \
                else tuple(map(cut, tree))
        return tree

    ctx = args[1]
    return [args[0], ctx._replace(nodes=cut(ctx.nodes), cap_w=cut(ctx.cap_w),
                                  control_code=code),
            *map(cut, args[2:9]), args[9][f]]


@pytest.mark.parametrize("layout", ["shared", "batched"])
@pytest.mark.parametrize("codes", [(2,), (0, 2, 7)])
@pytest.mark.parametrize("j", FLEET_WIDTHS)
def test_mega_kernel_with_per_fleet_codes(cuda, j, codes, layout):
    """Per-fleet codes (aimd, adaptbf and an out-of-range code that runs
    adaptbf's case and advances nothing): one launch a distinct code,
    against the plain round (atol 1e-3), each fleet bitwise equal to its
    own launch, and the member state of every row a member did not run
    bitwise unchanged."""
    args, code_rows = _fleet_mega_round(codes, j, layout, seed=j, dev=cuda)
    before = mega_ops.launches
    got = mega_ops.mega_window_round(*args, code_rows=code_rows)
    assert mega_ops.launches == before + len(set(codes))
    want = mega_ops.ref.mega_round_ref(*args)
    for i, (g, x) in enumerate(zip(_mega_leaves(got), _mega_leaves(want),
                                   strict=True)):
        assert torch.equal(g.isfinite(), x.isfinite()), i
        fin = x.isfinite()
        torch.testing.assert_close(g[fin], x[fin], rtol=0, atol=1e-3,
                                   msg=f"leaf {i}")
    o = 4
    for f, code in enumerate(codes):
        rows = slice(f * o, (f + 1) * o)
        for m, (new_m, old_m) in enumerate(zip(got[7], args[8])):
            if m != code:    # not this fleet's member: untouched
                for a, b in zip(mega_ops._leaves(new_m),
                                mega_ops._leaves(old_m)):
                    assert torch.equal(a[rows], b[rows]), (f, m)
        alone = mega_ops.mega_window_round(*_fleet_slice(args, f, o, code))
        for i, (g, a) in enumerate(zip(_mega_leaves(got), _mega_leaves(alone),
                                       strict=True)):
            assert torch.equal(g[rows], a), (f, i)


def test_mega_runs_a_plain_subclass_as_its_base(cuda):
    """A subclass of a built-in that overrides no policy method runs its
    base's megakernel case: bitwise the base's round."""
    class Plain(AdapTBFPolicy):
        pass

    args, faults = _mega_round("adaptbf", 300, seed=5, dev=cuda)
    for extra in ((), faults):
        base = mega_ops.mega_window_round(*args, *extra)
        before = mega_ops.launches
        sub = mega_ops.mega_window_round(Plain(), *args[1:], *extra)
        assert mega_ops.launches == before + 1
        for i, (a, b) in enumerate(zip(_mega_leaves(sub), _mega_leaves(base),
                                       strict=True)):
            assert torch.equal(a, b), i


@pytest.mark.parametrize("serve,alloc", [("fused", "pallas"),
                                         ("mega", "pallas")])
@pytest.mark.parametrize("telemetry", ["trajectory", "streaming"])
def test_simulate_tenants_on_the_card_equals_per_fleet_loop(
        cuda, serve, alloc, telemetry):
    """Four fleets (their own scenarios) under per-fleet codes over every
    policy and one out-of-range code, with a batched fault plan: bitwise
    the per-fleet ``simulate_fleet`` runs; B1 and B2 once a window over all
    rows, or B3 once a window for each distinct code."""
    from repro_torch.pytree import leaves_with_paths
    from repro_torch.storage import FaultPlan, faults, simulate_tenants
    codes = [0, 2, 4, 9]
    scns = [random_fleet(10 + i, n_ost=8, n_jobs=300, profile="mixed",
                         duration_s=1.0) for i in range(len(codes))]
    n_windows = scns[0].issue_rate.shape[0] // 10
    plans = [faults.outage(n_windows, 8, 2 + i, 6, osts=[i, 7])
             for i in range(len(codes))]
    plan = FaultPlan(*(np.stack(x) for x in zip(*plans)))
    stack = [np.stack([np.broadcast_to(s.nodes, s.volume.shape)
                       for s in scns])]
    stack += [np.stack([getattr(s, k) for s in scns]) for k in (
        "issue_rate", "volume", "capacity_per_tick", "max_backlog")]
    members = ("adaptbf", "aimd", "nobw", "static", "static_wc")
    cfg = FleetConfig(control="coded", coded_policies=members,
                      serve_backend=serve, alloc_backend=alloc,
                      telemetry=telemetry)
    fw_ops.launches = alloc_ops.launches = mega_ops.launches = 0
    batched = simulate_tenants(cfg, *stack, control_code=codes,
                               fault_plan=plan)
    want = ((0, 0, n_windows * len(set(codes))) if serve == "mega"
            else (n_windows, n_windows, 0))
    assert (fw_ops.launches, alloc_ops.launches, mega_ops.launches) == want
    got = dict(leaves_with_paths(batched))
    for i, code in enumerate(codes):
        one = simulate_fleet(cfg, *(x[i] for x in stack), control_code=code,
                             fault_plan=plans[i])
        for path, x in leaves_with_paths(one):
            if torch.is_tensor(x):
                assert got[path].device.type == "cuda", path
                assert torch.equal(got[path][i], x), (i, path)


# ----------------------------------------------------------- narrow rows
# J <= 32: B1, B2 and B3 run one warp a row, 16 rows a block (33: the first
# one-block width); 17 rows leave the last block part-filled
NARROW_WIDTHS = [1, 7, 8, 31, 32, 33]
NARROW_ROWS = [1, 17, 64, 4096]


@pytest.mark.parametrize("o", NARROW_ROWS)
@pytest.mark.parametrize("j", NARROW_WIDTHS)
def test_narrow_alloc_matches_plain(cuda, j, o):
    """B2 on o random rows: the integer allocation equal to the plain
    round's, record and remainder within 1e-3, one launch a call."""
    args = _alloc_case(o, j, seed=o * 100 + j, dev=cuda)
    before = alloc_ops.launches
    got = alloc_ops.fleet_alloc(*args)
    assert alloc_ops.launches == before + 1
    want = alloc_ops.fleet_alloc_ref(*args)[:3]
    assert torch.equal(got[0], want[0])
    for name, g, w in zip(("record", "remainder"), got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3, msg=name)


@pytest.mark.parametrize("o", NARROW_ROWS)
@pytest.mark.parametrize("j", NARROW_WIDTHS)
@pytest.mark.parametrize("name", MEGA_CASES)
def test_narrow_mega_matches_plain(cuda, name, j, o):
    """B3 for every policy case and coded, one round and then a round with
    lost telemetry and down rows, over o rows: the allocation equal to the
    plain round's, every other leaf within 1e-3."""
    args, faults = _mega_round(name, j, seed=o * 100 + j, dev=cuda, o=o)
    for extra in ((), faults):
        before = mega_ops.launches
        got = mega_ops.mega_window_round(*args, *extra)
        assert mega_ops.launches == before + 1
        want = mega_ops.ref.mega_round_ref(*args, *extra)
        _mega_close(got, want)
        args[4:9] = [want[0], want[1], want[8], tuple(want[4:7]), want[7]]


@pytest.mark.parametrize("j", NARROW_WIDTHS)
def test_narrow_coded_fleets_with_faults(cuda, j):
    """Five fleets of 4 rows under per-fleet codes, one out of range, with
    lost telemetry and down rows: one launch a distinct code, against the
    plain round, each fleet bitwise its own launch."""
    codes = (0, 2, 7, 1, 2)
    args, code_rows = _fleet_mega_round(codes, j, "shared", seed=j, dev=cuda)
    r = 4 * len(codes)
    telem = torch.ones(r, device=cuda)
    up = torch.ones(r, device=cuda)
    telem[::3] = 0.0
    up[1::4] = 0.0
    before = mega_ops.launches
    got = mega_ops.mega_window_round(*args, telem, up, code_rows=code_rows)
    assert mega_ops.launches == before + len(set(codes))
    want = mega_ops.ref.mega_round_ref(*args, telem, up)
    for i, (g, x) in enumerate(zip(_mega_leaves(got), _mega_leaves(want),
                                   strict=True)):
        assert torch.equal(g.isfinite(), x.isfinite()), i
        fin = x.isfinite()
        torch.testing.assert_close(g[fin], x[fin], rtol=0, atol=1e-3,
                                   msg=f"leaf {i}")
    for f, code in enumerate(codes):
        rows = slice(f * 4, (f + 1) * 4)
        alone = mega_ops.mega_window_round(*_fleet_slice(args, f, 4, code),
                                           telem[rows], up[rows])
        for i, (g, a) in enumerate(zip(_mega_leaves(got), _mega_leaves(alone),
                                       strict=True)):
            assert torch.equal(g[rows], a), (f, i)


def _window_by_entry(entry, queue, vol, budget, rates, backlog, cap):
    """B1 launched by its C entry ``entry`` with the arguments its wrapper
    passes, into fresh outputs filled with NaN (so every value compared is
    one the launch wrote)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import check_rates
    r, j = queue.shape
    w, o, fleet_rows = check_rates(rates, r, j)
    outs = tuple(torch.full_like(queue, float("nan")) for _ in range(3))
    err = _build.load(entry, fw_ops._ARGTYPES, lib="fleet_window")(
        *(x.data_ptr() for x in (queue, vol, budget, backlog, rates, cap,
                                 *outs)),
        r, j, w, o, fleet_rows, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return outs


@pytest.mark.parametrize("layout", ["shared", "batched"])
@pytest.mark.parametrize("o", [17, 4096])
@pytest.mark.parametrize("j", [1, 8, 32])
def test_narrow_window_warp_rows_bitwise_one_block(cuda, j, o, layout):
    """B1 on warp rows (fleets of 1 row at 17 rows, the small tenants' 1024
    fleets of 4 at 4096; their rates one shared trace, fleet stride 0, or
    each fleet's own, stride T*O): bitwise its one-block instance
    (``fleet_window_one_block``), within 1e-4 of the plain version with
    equal finite masks; budgets of +inf and 0, backlog caps below the
    queue, capacities that some row-ticks' phase 1 overflows."""
    per_fleet = 1 if o == 17 else 4
    queue, vol, budget, _, backlog, cap = _window_case(o, j, 1, o + j, cuda)
    budget[:, ::7] = 0.0
    backlog[:, ::5] = queue[:, ::5] * 0.5
    rates = _fleet_rates(o // per_fleet, per_fleet, j, 10, layout, seed=j,
                         dev=cuda)
    args = (queue, vol, budget, rates, backlog, cap)
    before, layouts = fw_ops.launches, _layout_launches("fleet_window")
    got = fw_ops.fleet_window_serve(*args)
    assert fw_ops.launches == before + 1
    assert [a - b for a, b in zip(_layout_launches("fleet_window"),
                                  layouts)] == [1, 0, 0]
    for name, g, x in zip(("queue", "vol_left", "served"), got,
                          _window_by_entry("fleet_window_one_block", *args)):
        assert torch.equal(g.view(torch.int32), x.view(torch.int32)), name
    want = fw_ops.fleet_window_ref(*args)
    for name, g, x in zip(("queue", "vol_left", "served"), got, want):
        assert torch.equal(g.isfinite(), x.isfinite()), name
        fin = x.isfinite()
        torch.testing.assert_close(g[fin], x[fin], rtol=0, atol=1e-4,
                                   msg=name)


def test_small_tenants_launch_only_the_warp_rows(cuda):
    """The small tenants (fleets of O=4 OSTs x J=8 jobs, one shared trace)
    under fused/pallas: B1 and B2 once a window, every launch on the warp
    rows by each library's own count; bitwise each fleet's own run."""
    from repro_torch.pytree import leaves_with_paths
    from repro_torch.storage import simulate_tenants
    scn = random_fleet(0, n_ost=4, n_jobs=8, duration_s=0.5)
    n_windows = scn.issue_rate.shape[0] // 10
    rng = np.random.default_rng(3)
    nodes = torch.as_tensor(rng.integers(1, 32, (64, 4, 8)).astype(
        np.float32), device=cuda)
    volume = torch.as_tensor(np.where(rng.random((64, 4, 8)) < 0.2, 500.0,
                                      np.inf).astype(np.float32), device=cuda)
    rates = torch.as_tensor(scn.issue_rate, device=cuda)
    cap = torch.as_tensor(scn.capacity_per_tick, device=cuda)
    cfg = FleetConfig(serve_backend="fused", alloc_backend="pallas",
                      telemetry="streaming")
    libs = ("fleet_window", "adaptbf_alloc")
    before = [_layout_launches(lib) for lib in libs]
    fw_ops.launches = alloc_ops.launches = 0
    batched = simulate_tenants(cfg, nodes, rates, volume, cap)
    assert (fw_ops.launches, alloc_ops.launches) == (n_windows, n_windows)
    moved = [[a - b for a, b in zip(_layout_launches(lib), was)]
             for lib, was in zip(libs, before)]
    assert moved == [[n_windows, 0, 0]] * 2, moved
    got = dict(leaves_with_paths(batched))
    for f in (0, 17, 63):
        one = simulate_fleet(cfg, nodes[f], rates, volume[f], cap)
        for path, x in leaves_with_paths(one):
            if torch.is_tensor(x):
                assert torch.equal(got[path][f], x), (f, path)


def _layout_launches(lib):
    """A fleet library's launches by row layout (warp, block, cluster),
    counted by its C entry where it picks the instance."""
    import ctypes

    from repro_torch.kernels import _build
    fn = _build.load(f"{lib}_layout_launches", [ctypes.c_int], lib=lib)
    return [fn(layout) for layout in (1, 2, 3)]


def test_narrow_rows_launch_the_warp_instances(cuda, monkeypatch):
    """A CUDA tensor at J <= 32 launches B1's, B2's and B3's warp-row
    instances (each library's count of warp-row launches moves once a call,
    every policy case and coded), never the plain versions; J = 33 launches
    the one-block instances."""
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fw_ops.ref, "fleet_window_ref", plain)
    monkeypatch.setattr(alloc_ops.ref, "fleet_alloc_ref", plain)
    monkeypatch.setattr(mega_ops.ref, "mega_round_ref", plain)
    libs = ("fleet_window", "adaptbf_alloc", "window_mega")
    for j in (1, 8, 32, 33):
        calls = [_mega_round(name, j, seed=j, dev=cuda, o=17)[0]
                 for name in MEGA_CASES]
        args = _alloc_case(17, j, seed=j, dev=cuda)
        wargs = _window_case(17, j, 10, seed=j, dev=cuda)
        before = [_layout_launches(lib) for lib in libs]
        fw_ops.fleet_window_serve(*wargs)
        alloc_ops.fleet_alloc(*args)
        for margs in calls:
            mega_ops.mega_window_round(*margs)
        after = [_layout_launches(lib) for lib in libs]
        moved = [[a - b for a, b in zip(x, y)] for x, y in zip(after, before)]
        n = len(MEGA_CASES)
        want = ([[1, 0, 0], [1, 0, 0], [n, 0, 0]] if j <= 32
                else [[0, 1, 0], [0, 1, 0], [0, n, 0]])
        assert moved == want, (j, moved)


# ------------------------------------------------------------ LM kernels

from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [16, 64, 80, 96, 128])
def test_flash_attention_matches_plain(cuda, d, group, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(d + group)
    b, s, hq = 2, 200, 8                      # S ragged against 64-row tiles
    q = _rand(gen, (b, s, hq, d), dtype)
    k = _rand(gen, (b, s, hq // group, d), dtype)
    v = _rand(gen, (b, s, hq // group, d), dtype)
    before = attn_ops.launches["flash_attention"]
    o, lse = attn_ops.attention_lse(q, k, v, causal=causal)
    assert attn_ops.launches["flash_attention"] == before + 1
    wo, wl = attn_ops.ref.mha_lse(q, attn_ops.ref.broadcast_kv(k, hq),
                                  attn_ops.ref.broadcast_kv(v, hq),
                                  causal=causal)
    tol = ATTN_TOL[dtype]
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), wo.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, wl, atol=tol, rtol=tol)


def _attention_case(cuda, b, s, t, hq, hkv, d, causal, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = _rand(gen, (b, s, hq, d), dtype)
    k = _rand(gen, (b, t, hkv, d), dtype)
    v = _rand(gen, (b, t, hkv, d), dtype)
    o, lse = attn_ops.attention_lse(q, k, v, causal=causal)
    wo, wl = attn_ops.ref.mha_lse(q, attn_ops.ref.broadcast_kv(k, hq),
                                  attn_ops.ref.broadcast_kv(v, hq),
                                  causal=causal)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(o.float(), wo.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, wl, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 129, 1000])
def test_flash_attention_tile_edges(cuda, s, group, dtype):
    """Causal S around the 64- and 128-row tiles (rows and keys past S
    arrive as zeros and are masked)."""
    _attention_case(cuda, 2, s, s, 8, 8 // group, 80, True, dtype, s + group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t", [(1, 300), (100, 300), (300, 100), (129, 1)])
def test_flash_attention_s_ne_t(cuda, s, t, dtype):
    _attention_case(cuda, 2, s, t, 8, 2, 64, False, dtype, s * t)


def test_flash_attention_bf16_rejects_what_tma_cannot_read(cuda):
    """The bfloat16 kernel reads by TMA: a view whose head stride is not a
    multiple of 16 bytes raises; the float32 kernel takes the same view."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    wide = _rand(gen, (1, 64, 4, 66), torch.float32)   # heads 66 apart
    q = wide.to(torch.bfloat16)[..., :64]               # 132-byte head stride
    before = attn_ops.launches["flash_attention"]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        attn_ops.attention(q, q, q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        odd = _rand(gen, (64 * 4 * 64 + 1,), torch.bfloat16)[1:]
        attn_ops.attention(odd.view(1, 64, 4, 64), q.contiguous(),
                           q.contiguous())
    assert attn_ops.launches["flash_attention"] == before
    qf = wide[..., :64]                                 # 264-byte head stride
    o = attn_ops.attention(qf, qf, qf)
    assert attn_ops.launches["flash_attention"] == before + 1
    want = attn_ops.ref.mha(qf, qf, qf)
    torch.testing.assert_close(o, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (8, 8)])
def test_flash_decode_split_edges(cuda, hq, hkv, dtype):
    """Lengths around the host plan's split length L (0, 1, L-1, L, L+1,
    T) and one long cache beside very short ones: empty splits and ragged
    splits merge as the whole-sequence softmax."""
    t, d = 4096, 128
    b = 8
    split, n_split = attn_ops.decode_split_plan(
        t, b, hq, hkv, attn_ops._sm_count(cuda.index or 0))
    assert n_split > 1
    lens = [0, 1, split - 1, split, split + 1, t, 2, t - 1]
    gen = torch.Generator(device=cuda).manual_seed(hq * hkv)
    q = _rand(gen, (b, 1, hq, d), dtype)
    kc = _rand(gen, (b, t, hkv * d), dtype).view(b, t, hkv, d)
    vc = _rand(gen, (b, t, hkv * d), dtype).view(b, t, hkv, d)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = attn_ops.decode_attention(q, kc, vc, length)
    want = attn_ops.ref.decode_attention(
        q, attn_ops.ref.broadcast_kv(kc, hq), attn_ops.ref.broadcast_kv(vc, hq),
        length)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_decode_rejects_what_16_byte_copies_cannot_read(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _rand(gen, (2, 1, 4, 64), torch.bfloat16)
    wide = _rand(gen, (2, 32, 4, 68), torch.bfloat16)
    length = torch.full((2,), 32, dtype=torch.int32, device=cuda)
    before = attn_ops.launches["flash_decode"]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        attn_ops.decode_attention(q, wide[..., :64], wide[..., :64], length)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        short = _rand(gen, (2, 32, 4, 4), torch.bfloat16)
        attn_ops.decode_attention(q[..., :4], short, short, length)
    assert attn_ops.launches["flash_decode"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_flash_decode_matches_plain(cuda, d, group, dtype):
    gen = torch.Generator(device=cuda).manual_seed(d * group)
    t, hq = 300, 8
    lens = [300, 1, 37, 0, 299]
    b = len(lens)
    hkv = hq // group
    q = _rand(gen, (b, 1, hq, d), dtype)
    kc = _rand(gen, (b, t, hkv * d), dtype).view(b, t, hkv, d)
    vc = _rand(gen, (b, t, hkv * d), dtype).view(b, t, hkv, d)
    length = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = attn_ops.launches["flash_decode"]
    got = attn_ops.decode_attention(q, kc, vc, length)
    assert attn_ops.launches["flash_decode"] == before + 1
    want = attn_ops.ref.decode_attention(
        q, attn_ops.ref.broadcast_kv(kc, hq), attn_ops.ref.broadcast_kv(vc, hq),
        length)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n", [(16, 16), (64, 64), (32, 96), (64, 128)])
@pytest.mark.parametrize("s", [64, 200])
def test_ssd_scan_matches_plain(cuda, s, p, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s + p + n)
    b, h = 2, 3
    x = _rand(gen, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_rand(gen, (b, s, h), torch.float32)
                                      - 1.0)
    a = -torch.exp(torch.rand(h, generator=gen, device=cuda) * 1.5)
    B = (_rand(gen, (b, s, n), torch.float32) * n ** -0.5).to(dtype)
    C = (_rand(gen, (b, s, n), torch.float32) * n ** -0.5).to(dtype)
    skip = torch.linspace(0.5, 1.5, h, device=cuda)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd(x, dt, a, B, C, d_skip=skip)
    assert ssd_ops.launches == before + 1
    wy, wst = ssd_ops.ref.ssd_chunked(x, dt, a, B, C, d_skip=skip)
    tol = SSD_TOL[dtype]
    assert y.dtype == dtype and st.dtype == torch.float32
    assert tuple(st.shape) == (b, h, p, n)
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, wst.float(), atol=tol, rtol=tol)


def _ssd_case(cuda, b, s, h, p, n, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = _rand(gen, (b, s, h, p), dtype)
    dt = torch.nn.functional.softplus(_rand(gen, (b, s, h), torch.float32)
                                      - 1.0)
    a = -torch.exp(torch.rand(h, generator=gen, device=cuda) * 1.5)
    B = (_rand(gen, (b, s, n), torch.float32) * n ** -0.5).to(dtype)
    C = (_rand(gen, (b, s, n), torch.float32) * n ** -0.5).to(dtype)
    skip = torch.linspace(0.5, 1.5, h, device=cuda)
    return x, dt, a, B, C, skip


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n", [
    (2, 1, 5, 64, 64), (2, 63, 5, 64, 64), (2, 64, 5, 64, 64),
    (2, 65, 5, 64, 64), (2, 129, 5, 64, 64), (2, 2000, 3, 64, 64),
    (1, 300, 4, 64, 128), (1, 300, 4, 32, 64), (1, 300, 4, 64, 16)])
def test_ssd_scan_edges(cuda, b, s, h, p, n, dtype):
    """S at the chunk edges and ragged, N of 16 and 128, P=32, a head
    count (5) that fills no consumer group, a batch of 1."""
    x, dt, a, B, C, skip = _ssd_case(cuda, b, s, h, p, n, dtype, s + n + p)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd(x, dt, a, B, C, d_skip=skip)
    assert ssd_ops.launches == before + 1
    wy, wst = ssd_ops.ref.ssd_chunked(x, dt, a, B, C, d_skip=skip)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, wst.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n", [
    (2, 200, 3, 64, 64), (2, 1, 5, 64, 64), (1, 65, 4, 32, 128),
    (1, 130, 2, 64, 16)])
def test_ssd_scan_warm_start(cuda, b, s, h, p, n, dtype):
    """initial_state [B,H,P,N] (float32, rounded to x's type by the kernel
    as the reference casts it) against the plain warm-started scan."""
    x, dt, a, B, C, skip = _ssd_case(cuda, b, s, h, p, n, dtype, s + 7 * n)
    gen = torch.Generator(device=cuda).manual_seed(b + s + h)
    h0 = _rand(gen, (b, h, p, n), torch.float32)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd(x, dt, a, B, C, d_skip=skip, initial_state=h0)
    assert ssd_ops.launches == before + 1
    wy, wst = ssd_ops.ref.ssd_chunked(x, dt, a, B, C, d_skip=skip,
                                      initial_state=h0)
    tol = SSD_TOL[dtype]
    assert st.dtype == torch.float32 and tuple(st.shape) == (b, h, p, n)
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, wst.float(), atol=tol, rtol=tol)


def test_ssd_scan_float32_rounds_cum_as_the_reference(cuda):
    """dt up to ~25 and a down to -16 (the spread zamba2-2.7b's initial
    weights give) put the running sums cum in the thousands, where the
    decays exp(cum_i - cum_j) carry cum's rounding.  The float32 kernel's y
    and state stay as close to a float64 plain run as the float32 plain
    path does: mean error within 1.25x, max within 2x."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    b, s, h, p, n = 2, 256, 4, 64, 64
    x = _rand(gen, (b, s, h, p), torch.float32) * 10.0
    dt = torch.nn.functional.softplus(
        _rand(gen, (b, s, h), torch.float32) * 6.0)
    a = -torch.exp(torch.rand(h, generator=gen, device=cuda) * 2.77)
    B = _rand(gen, (b, s, n), torch.float32) * 8.0
    C = _rand(gen, (b, s, n), torch.float32) * 8.0
    skip = torch.linspace(0.5, 1.5, h, device=cuda)
    cum = torch.cumsum((dt * a).reshape(b, s // 64, 64, h), dim=2)
    assert float(cum.abs().max()) > 1000.0
    got = ssd_ops.ssd(x, dt, a, B, C, d_skip=skip)
    plain = ssd_ops.ref.ssd_chunked(x, dt, a, B, C, d_skip=skip)
    wide = ssd_ops.ref.ssd_chunked(x.double(), dt.double(), a.double(),
                                   B.double(), C.double(),
                                   d_skip=skip.double())
    for ours, theirs, want in zip(got, plain, wide):
        e_k = (ours.double() - want).abs()
        e_p = (theirs.double() - want).abs()
        assert float(e_k.mean()) <= 1.25 * float(e_p.mean())
        assert float(e_k.max()) <= 2.0 * float(e_p.max())


def test_ssd_bf16_rejects_what_tma_cannot_read(cuda):
    """The bfloat16 scan moves x, B, C and y by TMA: a B or C row of 100
    elements (200-byte stride), an x base off 16 bytes and P=4 (an 8-byte
    head stride of y) raise; the float32 scan takes the same shapes."""
    x, dt, a, B, C, skip = _ssd_case(cuda, 1, 128, 2, 64, 100,
                                     torch.bfloat16, 3)
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ssd_ops.ssd(x, dt, a, B, C, d_skip=skip)
    bc = B[..., :64].contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
        ssd_ops.ssd(flat[1:].view(x.shape), dt, a, bc, bc, d_skip=skip)
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd_ops.ssd(x[..., :8].contiguous().view(1, 128, 2, 8)[..., :4],
                    dt, a, bc, bc, d_skip=skip)
    assert ssd_ops.launches == before
    f32 = [t.float() if t.dtype == torch.bfloat16 else t
           for t in (x, dt, a, B, C)]
    y, _ = ssd_ops.ssd(*f32, d_skip=skip)
    assert ssd_ops.launches == before + 1
    wy, _ = ssd_ops.ref.ssd_chunked(*f32, d_skip=skip)
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)


def test_lm_wrappers_reject_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _rand(gen, (1, 16, 4, 64), torch.float32)
    k = _rand(gen, (1, 16, 2, 64), torch.float32)
    before = dict(attn_ops.launches), ssd_ops.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attn_ops.attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError, match="but q is"):
        attn_ops.attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="multiple"):
        attn_ops.attention(q, k[:, :, :1].expand(1, 16, 3, 64).contiguous(),
                           k[:, :, :1].expand(1, 16, 3, 64).contiguous())
    with pytest.raises(ValueError, match="head dims up to"):
        wide = _rand(gen, (1, 16, 2, 160), torch.float32)
        attn_ops.attention(wide, wide, wide)
    with pytest.raises(ValueError, match="contiguous"):
        attn_ops.attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           k)
    with pytest.raises(ValueError, match="several devices"):
        attn_ops.attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="int32"):
        attn_ops.decode_attention(q[:, :1], k, k,
                                  torch.ones(1, dtype=torch.int64,
                                             device=cuda))
    x = _rand(gen, (1, 64, 2, 16), torch.float32)
    dt = torch.ones((1, 64, 2), device=cuda)
    a = -torch.ones(2, device=cuda)
    bc = _rand(gen, (1, 64, 8), torch.float32)
    with pytest.raises(ValueError, match="initial_state must have shape"):
        ssd_ops.ssd(x, dt, a, bc, bc,
                    initial_state=torch.zeros((1, 2, 8, 16), device=cuda))
    with pytest.raises(ValueError, match="chunks of 64"):
        ssd_ops.ssd(x, dt, a, bc, bc, chunk=32)
    with pytest.raises(TypeError, match="dt must be"):
        ssd_ops.ssd(x, dt.double(), a, bc, bc)
    with pytest.raises(ValueError, match="P <= 64"):
        wide = _rand(gen, (1, 64, 2, 80), torch.float32)
        ssd_ops.ssd(wide, dt, a, bc, bc)
    assert (dict(attn_ops.launches), ssd_ops.launches) == before


# ------------------------------------------------------ training on the card

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,hq,hkv,d,causal", [
    (2, 200, 200, 8, 2, 64, True),        # GQA, S ragged against 64
    (1, 100, 300, 8, 2, 80, False),       # S != T, non-causal
    (2, 65, 65, 4, 4, 128, True),         # D = 128, one row past a tile
    (1, 129, 129, 4, 4, 16, False),
    (1, 1, 1, 2, 2, 96, True),
    (1, 256, 256, 32, 8, 80, True),       # GQA 32/8 at zamba2's head dim
    (1, 1000, 1000, 8, 2, 80, True),      # S = 1000: ragged against 128
    (2, 300, 500, 8, 8, 128, False),      # S < T, D = 128
    (1, 500, 300, 8, 2, 64, True),        # S > T, causal
    (1, 130, 130, 4, 1, 48, True),        # D = 48: three 16-column slabs
])
def test_flash_attention_bwd_matches_plain(cuda, b, s, t, hq, hkv, d, causal,
                                           dtype):
    """The backward kernel against ``ref.gqa_bwd``: float32 within 1e-4 x
    max(1, max |g|); bfloat16 no farther from the float32 plain gradients
    than the bfloat16 plain path (mean within 1.25x, max within 2x).  Two
    calls are bitwise equal (no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = _rand(gen, (b, s, hq, d), dtype)
    k = _rand(gen, (b, t, hkv, d), dtype)
    v = _rand(gen, (b, t, hkv, d), dtype)
    do = _rand(gen, (b, s, hq, d), dtype)
    o, lse = attn_ops.attention_lse(q, k, v, causal=causal)
    before = attn_ops.launches["flash_attention_bwd"]
    got = attn_ops.attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert attn_ops.launches["flash_attention_bwd"] == before + 1
    again = attn_ops.attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    assert all(g.dtype == dtype for g in got)
    want = attn_ops.ref.gqa_bwd(q, k, v, o, lse, do, causal)
    if dtype == torch.float32:
        for g, w in zip(got, want):
            bound = 1e-4 * max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= bound
        return
    f = [x.float() for x in (q, k, v, do)]
    o32, lse32 = attn_ops.ref.mha_lse(
        f[0], attn_ops.ref.broadcast_kv(f[1], hq),
        attn_ops.ref.broadcast_kv(f[2], hq), causal=causal)
    w32 = attn_ops.ref.gqa_bwd(f[0], f[1], f[2], o32, lse32, f[3], causal)
    for g, w, ref32 in zip(got, want, w32):
        ours = (g.double() - ref32.double()).abs()
        theirs = (w.double() - ref32.double()).abs()
        assert float(ours.mean()) <= 1.25 * float(theirs.mean())
        assert float(ours.max()) <= 2 * float(theirs.max())


def test_flash_attention_bwd_finite_differences(cuda):
    """The float32 kernel's gradient against central differences of the
    forward kernel along random directions (gradcheck's test, in float32:
    the kernels take no float64)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, s, hq, hkv, d = 1, 37, 4, 2, 16
    q = _rand(gen, (b, s, hq, d), torch.float32).requires_grad_()
    k = _rand(gen, (b, s, hkv, d), torch.float32).requires_grad_()
    v = _rand(gen, (b, s, hkv, d), torch.float32).requires_grad_()
    w = _rand(gen, (b, s, hq, d), torch.float32)

    def loss(q, k, v):
        return (attn_ops.attention(q, k, v, causal=True) * w).sum()

    before = attn_ops.launches["flash_attention_bwd"]
    grads = torch.autograd.grad(loss(q, k, v), (q, k, v))
    assert attn_ops.launches["flash_attention_bwd"] == before + 1
    eps = 1e-2
    with torch.no_grad():
        for i, g in enumerate(grads):
            for _ in range(3):
                u = _rand(gen, g.shape, torch.float32)
                args = [q, k, v]
                plus = list(args)
                minus = list(args)
                plus[i] = args[i] + eps * u
                minus[i] = args[i] - eps * u
                fd = (loss(*plus) - loss(*minus)) / (2 * eps)
                an = (g * u).sum()
                assert abs(float(fd - an)) <= 1e-2 * max(1.0, abs(float(an)))


def test_flash_attention_bwd_bf16_rejects_what_tma_cannot_read(cuda):
    """The bfloat16 backward reads q, k, v and dO by TMA: an o or dO
    (and q) off a 16-byte base or with a row pitch that is not a multiple
    of 16 bytes raises ``ValueError`` before any launch."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    dt = torch.bfloat16
    q = _rand(gen, (1, 64, 4, 64), dt)
    k = _rand(gen, (1, 64, 2, 64), dt)
    o, lse = attn_ops.attention_lse(q, k, k)
    do = _rand(gen, (1, 64, 4, 64), dt)
    before = attn_ops.launches["flash_attention_bwd"]
    odd = _rand(gen, (1, 64 * 4 * 64 + 1), dt)[:, 1:].view(1, 64, 4, 64)
    for kw in ({"o": odd}, {"do": odd}, {"q": odd}):
        args = dict(q=q, k=k, v=k, o=o, lse=lse, do=do)
        args.update(kw)
        with pytest.raises(ValueError, match="TMA"):
            attn_ops.attention_bwd(**args)
    assert attn_ops.launches["flash_attention_bwd"] == before


def test_flash_attention_bwd_rejects_what_it_cannot_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _rand(gen, (1, 16, 4, 64), torch.float32)
    k = _rand(gen, (1, 16, 2, 64), torch.float32)
    o, lse = attn_ops.attention_lse(q, k, k)
    before = attn_ops.launches["flash_attention_bwd"]
    with pytest.raises(ValueError, match="do must be"):
        attn_ops.attention_bwd(q, k, k, o, lse, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="lse must be"):
        attn_ops.attention_bwd(q, k, k, o, lse[:, :8], q)
    with pytest.raises(ValueError, match="several devices"):
        attn_ops.attention_bwd(q, k, k, o, lse.cpu(), q)
    assert attn_ops.launches["flash_attention_bwd"] == before


SSD_BWD_NAMES = ("x", "dt", "a", "B", "C", "d_skip", "initial_state")


def _ssd_autograd(args, gy, gs):
    """Autograd of ``ref.ssd_chunked`` (the oracle): the gradients of every
    given input (None where an input is None), gy and gs as given."""
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in args]
    y, st = ssd_ops.ref.ssd_chunked(*leaves[:5], d_skip=leaves[5],
                                    initial_state=leaves[6])
    outs = [(o, g.to(o.dtype)) for o, g in ((y, gy), (st, gs))
            if g is not None]
    idx = [i for i, t in enumerate(leaves) if t is not None]
    got = torch.autograd.grad([o for o, _ in outs], [leaves[i] for i in idx],
                              [g for _, g in outs], allow_unused=True)
    out = [None] * 7
    for i, g in zip(idx, got):
        out[i] = torch.zeros_like(leaves[i]) if g is None else g
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,warm,skip,use_gy,use_gs", [
    (2, 200, 3, 64, 64, False, True, True, True),
    (2, 1, 5, 64, 64, True, True, True, True),       # S = 1
    (1, 1000, 4, 64, 64, True, True, True, True),    # ragged, warm start
    (2, 130, 3, 16, 128, True, False, True, True),   # P = 16, N = 128
    (1, 64, 2, 32, 96, False, True, False, True),    # gstate only
    (1, 65, 2, 64, 64, False, True, True, False),    # gy only
    (1, 2048, 3, 64, 64, True, True, True, True),    # 32 chunks of carry
    (2, 193, 9, 64, 64, True, True, True, True),     # S = 64 k + 1, 2 groups
])
def test_ssd_bwd_matches_autograd(cuda, b, s, h, p, n, warm, skip, use_gy,
                                  use_gs, dtype):
    """The SSD backward kernel against autograd of ``ref.ssd_chunked``:
    float32 within 1e-4 x max(1, max |g|) a gradient; bfloat16 no farther
    from the float32 autograd gradients than the bfloat16 plain path's
    autograd (mean within 1.25x, max within 2x).  One launch a call; two
    calls bitwise equal (no atomics)."""
    x, dt, a, B, C, d = _ssd_case(cuda, b, s, h, p, n, dtype, s + p + n)
    gen = torch.Generator(device=cuda).manual_seed(s + 3 * n)
    h0 = _rand(gen, (b, h, p, n), torch.float32) if warm else None
    gy = _rand(gen, (b, s, h, p), dtype) if use_gy else None
    gs = _rand(gen, (b, h, p, n), torch.float32) if use_gs else None
    args = [x, dt, a, B, C, d if skip else None, h0]
    before = ssd_ops.launches_bwd
    got = ssd_ops.ssd_bwd(*args, gy=gy, gstate=gs)
    again = ssd_ops.ssd_bwd(*args, gy=gy, gstate=gs)
    assert ssd_ops.launches_bwd == before + 2
    for name, g, g2, t in zip(SSD_BWD_NAMES, got, again, args):
        assert (g is None) == (t is None), name
        if g is not None:
            assert g.dtype == t.dtype and g.shape == t.shape, name
            assert torch.equal(g, g2), name
    want = _ssd_autograd(args, gy, gs)
    if dtype == torch.float32:
        for name, g, w in zip(SSD_BWD_NAMES, got, want):
            if g is not None:
                bound = 1e-4 * max(1.0, float(w.abs().max()))
                assert float((g - w).abs().max()) <= bound, name
        return
    f32 = [None if t is None else t.float() for t in args]
    if h0 is not None:   # the bfloat16 scan rounds its warm start to bf16
        f32[6] = h0.to(dtype).float()
    w32 = _ssd_autograd(f32, None if gy is None else gy.float(), gs)
    for name, g, w, r in zip(SSD_BWD_NAMES, got, want, w32):
        if g is None:
            continue
        ours = (g.double() - r.double()).abs()
        theirs = (w.double() - r.double()).abs()
        assert float(ours.mean()) <= 1.25 * float(theirs.mean()) + 1e-12, name
        assert float(ours.max()) <= 2 * float(theirs.max()) + 1e-12, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_at_large_cum_is_as_close_as_the_plain_path(cuda, dtype):
    """dt up to ~25 and a down to -16 (zamba2-2.7b's initial weights) put
    cum in the thousands.  float32: every gradient of the kernel as close
    to autograd of a float64 plain scan as the float32 plain path's
    autograd (mean within 1.25x, max within 2x); bfloat16: no farther from
    the float32 autograd gradients than the bfloat16 plain path's (the
    same ratios)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    b, s, h, p, n = 2, 256, 4, 64, 64
    x = (_rand(gen, (b, s, h, p), torch.float32) * 10.0).to(dtype)
    dt = torch.nn.functional.softplus(
        _rand(gen, (b, s, h), torch.float32) * 6.0)
    a = -torch.exp(torch.rand(h, generator=gen, device=cuda) * 2.77)
    B = (_rand(gen, (b, s, n), torch.float32) * 8.0).to(dtype)
    C = (_rand(gen, (b, s, n), torch.float32) * 8.0).to(dtype)
    skip = torch.linspace(0.5, 1.5, h, device=cuda)
    h0 = _rand(gen, (b, h, p, n), torch.float32)
    gy = _rand(gen, (b, s, h, p), dtype)
    gs = _rand(gen, (b, h, p, n), torch.float32)
    cum = torch.cumsum((dt * a).reshape(b, s // 64, 64, h), dim=2)
    assert float(cum.abs().max()) > 1000.0
    args = [x, dt, a, B, C, skip, h0]
    got = ssd_ops.ssd_bwd(*args, gy=gy, gstate=gs)
    plain = _ssd_autograd(args, gy, gs)
    if dtype == torch.float32:
        want = _ssd_autograd([t.double() for t in args], gy.double(),
                             gs.double())
    else:
        f32 = [t.float() for t in args]
        f32[6] = h0.to(dtype).float()
        want = _ssd_autograd(f32, gy.float(), gs)
    for name, g, w, r in zip(SSD_BWD_NAMES, got, plain, want):
        ours = (g.double() - r.double()).abs()
        theirs = (w.double() - r.double()).abs()
        assert bool(g.isfinite().all()), name
        assert float(ours.mean()) <= 1.25 * float(theirs.mean()) + 1e-12, name
        assert float(ours.max()) <= 2 * float(theirs.max()) + 1e-12, name


def test_ssd_bwd_bf16_runs_the_tensor_core_kernels(cuda):
    """A bfloat16 ``ssd_bwd`` launches the walk, the chunk kernel and the
    reduction, and not the float32 SIMT scan; a float32 one the reverse."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, dt, a, B, C, d = _ssd_case(cuda, 1, 130, 3, 64, 64, torch.bfloat16, 4)
    gen = torch.Generator(device=cuda).manual_seed(4)
    gy = _rand(gen, x.shape, torch.bfloat16)
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        conv = [t.to(dtype) if t.dtype == torch.bfloat16 else t
                for t in (x, B, C, gy)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ssd_ops.ssd_bwd(conv[0], dt, a, conv[1], conv[2], d, gy=conv[3])
            torch.cuda.synchronize()
        names[dtype] = " ".join(e.key for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA)
    for kernel in ("ssd_bwd_walk_tc", "ssd_bwd_chunk_tc", "ssd_bwd_reduce"):
        assert kernel in names[torch.bfloat16], (kernel, names)
    assert "ssd_bwd_scan" not in names[torch.bfloat16], names
    assert "ssd_bwd_scan" in names[torch.float32], names
    assert "_tc" not in names[torch.float32], names


def test_ssd_bwd_bf16_rejects_what_tma_cannot_read(cuda):
    """The bfloat16 backward reads x, B and C by TMA under the forward's
    rules: an x base off 16 bytes or P=4 raises, and nothing launches."""
    x, dt, a, B, C, d = _ssd_case(cuda, 1, 128, 2, 64, 64, torch.bfloat16, 6)
    before = ssd_ops.launches_bwd
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_ops.ssd_bwd(odd, dt, a, B, C, d, gy=x)
    narrow = x[..., :8].contiguous()[..., :4]   # 16-byte strides, P = 4
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd_ops.ssd_bwd(narrow, dt, a, B, C, d, gy=narrow)
    assert ssd_ops.launches_bwd == before


def test_ssd_backward_launches_the_kernel(cuda):
    """``ssd``'s backward on the card launches the backward kernel once and
    matches ``ssd_bwd``; no plain recompute."""
    x, dt, a, B, C, d = _ssd_case(cuda, 1, 130, 3, 64, 64, torch.float32, 5)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, B, C, d)]
    y, st = ssd_ops.ssd(*leaves)
    gen = torch.Generator(device=cuda).manual_seed(9)
    gy = _rand(gen, y.shape, torch.float32)
    before = (ssd_ops.launches, ssd_ops.launches_bwd)
    got = torch.autograd.grad(y, leaves, gy)
    assert (ssd_ops.launches, ssd_ops.launches_bwd) == (before[0],
                                                        before[1] + 1)
    want = ssd_ops.ssd_bwd(x, dt, a, B, C, d, gy=gy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_bwd_rejects_what_it_cannot_take(cuda):
    x, dt, a, B, C, d = _ssd_case(cuda, 1, 64, 2, 64, 64, torch.float32, 1)
    before = ssd_ops.launches_bwd
    with pytest.raises(ValueError, match="P <= 64"):
        wide = torch.zeros((1, 64, 2, 80), device=cuda)
        ssd_ops.ssd_bwd(wide, dt, a, B, C, gy=wide)
    with pytest.raises(ValueError, match="chunks of 64"):
        ssd_ops.ssd_bwd(x, dt, a, B, C, gy=x, chunk=32)
    with pytest.raises(ValueError, match="gstate must have shape"):
        ssd_ops.ssd_bwd(x, dt, a, B, C, gstate=torch.zeros((1, 2, 64, 8),
                                                             device=cuda))
    with pytest.raises(ValueError, match="several devices"):
        ssd_ops.ssd_bwd(x, dt, a, B, C, gy=x.cpu())
    assert ssd_ops.launches_bwd == before


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "zamba2-2.7b"])
def test_trainer_restore_is_bitwise_on_the_card(cuda, tmp_path, arch):
    """Crash, restore and continue reproduces the uninterrupted run bit for
    bit on the card with the kernels (phi3-mini-3.8b's and zamba2-2.7b's
    smoke configs): the attention and SSD backwards run no atomics."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.pytree import leaves_with_paths
    from repro_torch.training import Trainer

    cfg = get_smoke_config(arch)
    kw = dict(global_batch=4, seq_len=32, ckpt_every=1000, lr=1e-3,
              device=cuda)
    ref = Trainer(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    before = dict(attn_ops.launches)
    before_ssd = ssd_ops.launches_bwd
    ref_hist = ref.run(6)
    ref.close()
    if cfg.block == "zamba":
        n_attn = cfg.n_layers // cfg.shared_attn_every * 6
        assert ssd_ops.launches_bwd == before_ssd + cfg.n_layers * 6
    else:
        n_attn = cfg.n_layers * 6
    assert attn_ops.launches["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + n_attn
    assert attn_ops.launches["flash_attention"] >= \
        before["flash_attention"] + n_attn
    tr1 = Trainer(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    tr1.run(3)
    tr1.save_now()
    tr1.close()
    del tr1
    tr2 = Trainer(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert tr2.step == 3
    hist2 = tr2.run(3)
    tr2.close()
    assert [h["loss"] for h in hist2] == [h["loss"] for h in ref_hist[3:]]
    for (pa, a), (pb, b) in zip(leaves_with_paths(ref.state),
                                leaves_with_paths(tr2.state)):
        assert pa == pb and a.device.type == "cuda"
        assert torch.equal(a, b), pa


def test_moe_apply_on_the_card_is_repeatable_and_matches_the_cpu(cuda):
    """The MoE block on the card: two calls bitwise equal (no atomics in
    dispatch or combine), the same experts as on the CPU, the output within
    1e-5 x max(1, max |y|) of the CPU's, in float32, with capacity drops
    (a skewed router) and without."""
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    p = models.init_params(cfg, torch.Generator().manual_seed(0))[
        "layers"][0]["moe"]
    for skew in (0.0, 0.5):
        pc = dict(p, router=p["router"].clone())
        pc["router"][:, 1] += skew
        x = torch.randn(3, 24, cfg.d_model,
                        generator=torch.Generator().manual_seed(1)) + skew
        want = L.moe_apply(pc, x, cfg)
        on_card = {k: v.to(cuda) for k, v in pc.items()}
        a = L.moe_apply(on_card, x.to(cuda), cfg)
        b = L.moe_apply(on_card, x.to(cuda), cfg)
        assert torch.equal(a, b)
        assert torch.equal(L.moe_route(on_card, x.to(cuda), cfg)[0].cpu(),
                           L.moe_route(pc, x, cfg)[0])
        bound = 1e-5 * max(1.0, float(want.abs().max()))
        assert float((a.cpu() - want).abs().max()) <= bound


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "hubert-xlarge",
                                  "pixtral-12b"])
def test_moe_and_frontend_models_launch_the_attention_kernel(cuda, arch):
    """The smoke configs' forward on the card: flash attention once a
    layer, float32 logits within 1e-3 x max(1, max |logit|) of the plain
    path's."""
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.attention import ops as attn_ops
    cfg = get_smoke_config(arch)
    params = models.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(2)
    batch = {}
    if cfg.frontend == "audio":
        batch["frames"] = torch.randn(2, 40, cfg.frontend_dim, generator=gen,
                                      device=cuda)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                                        device=cuda)
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn(2, 8, cfg.frontend_dim, generator=gen,
                                       device=cuda)
    before = attn_ops.launches["flash_attention"]
    got = models.forward(params, cfg, batch, dtype=torch.float32)
    assert attn_ops.launches["flash_attention"] == before + cfg.n_layers
    want = models.forward(params, cfg, batch, dtype=torch.float32,
                          kernels=False)
    bound = 1e-3 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= bound
