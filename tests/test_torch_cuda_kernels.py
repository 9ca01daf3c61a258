"""The port's CUDA kernels against their plain PyTorch versions on the card,
at widths that take every lanes-per-thread variant the kernels compile
(J = 1 to the 8192 maximum), plus the wrappers' input checks and the
kernel path of ``simulate_fleet``.

A CUDA kernel has no CPU mode, so every test here needs a GPU and skips
without one.  JAX is not needed (and not installed on a GPU host); run
from the repository root with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
from repro_torch.kernels.dispatch import MAX_JOBS
from repro_torch.kernels.fleet_window import ops as fw_ops
from repro_torch.storage import FleetConfig, random_fleet, simulate_fleet

pytestmark = pytest.mark.requires_cuda

WIDTHS = [1, 100, 513, 2048, 4096, MAX_JOBS]   # LPT 1, 1, 2, 4, 8, 16


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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    args = _alloc_case(2, 64, seed=1, dev=cuda)
    with pytest.raises(TypeError, match="float32"):
        alloc_ops.fleet_alloc(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        alloc_ops.fleet_alloc(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="several devices"):
        alloc_ops.fleet_alloc(args[0].cpu(), *args[1:])
    wide = _window_case(1, MAX_JOBS + 1, 1, seed=2, dev=cuda)
    with pytest.raises(ValueError, match=str(MAX_JOBS)):
        fw_ops.fleet_window_serve(*wide)


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
