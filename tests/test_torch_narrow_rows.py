"""Narrow rows (J <= 32 jobs): the host's layout rule, and the plain models of
the allocation kernel's warp-row searches held bitwise (``integerize_model``
on them: ``tests/test_torch_alloc_search.py``, its ``warp-J`` cases).

On the card B1 (``fleet_window``), B2 (``adaptbf_alloc``) and B3
(``window_mega``) run a row of at most ``dispatch.WARP_JOBS`` jobs on one
warp, a lane a job, several rows a block (``dispatch.row_layout``;
``csrc/common.cuh::row_layout`` is the same rule, and each library's C
entry dispatches on it).  B1's warp row runs the one-block tick loop
unchanged, so its plain model is the window of the kernel's ticks
(``fleet_window/ref.py::fleet_window_model``), held bitwise against the
plain window and against the reference's at J of 1, 7, 8, 31 and 32.  In
B2 the top-k search is a direct rank over warp shuffles and the
excess descent reads each lane's floor by shuffle
(``csrc/alloc_round.cuh``, the ``WarpRed`` overloads).  Their plain models,
``ref.topk_mask_rank`` and ``ref.excess_rounds_warp``, are held bitwise
against the port's ``core/remainder.py`` (sort-based top-k, 25-step bit
descent), the one-block models and the reference's ``repro.core.remainder``
(probe searches) at J of 1, 7, 8, 31 and 32: many exact ties, -0.0 beside
+0.0, -inf keys, all keys -inf, k at 0, 1 and around the count of finite
keys, and excesses of several rounds.  The reference runs on rows padded
to 32 lanes with -inf keys after the real ones, which rank after every
real lane, so eager JAX compiles each primitive once."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_alloc_search import _bit_descent, _counts, _keys, _pad

from repro.core import remainder as jref
from repro_torch.core import remainder as tref
from repro_torch.kernels import dispatch
from repro.kernels.fleet_window import ops as jwindow
from repro_torch.kernels.adaptbf_alloc import ref as model
from repro_torch.kernels.fleet_window import ref as window_model

torch.set_num_threads(1)

NARROW = [1, 7, 8, 31, 32]
PAD = dispatch.WARP_JOBS
ROWS = 6
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
COMMON = CSRC / "common.cuh"
FLEET_LIBS = ["fleet_window", "adaptbf_alloc", "window_mega"]


@pytest.mark.parametrize("j,layout", [
    (1, "warp"), (8, "warp"), (32, "warp"), (33, "block"), (4096, "block"),
    (8192, "block"), (8193, "cluster"), (65536, "cluster")])
def test_row_layout_rule(j, layout):
    assert dispatch.row_layout(j) == layout


def test_row_layout_raises_past_the_limit():
    with pytest.raises(ValueError, match="65536"):
        dispatch.row_layout(dispatch.MAX_JOBS + 1)


def test_row_layout_is_the_kernels_rule():
    """The host's constants are the ones ``common.cuh``'s ``row_layout`` and
    ``cluster_blocks`` read, and the C rule, evaluated from the header's
    own text, gives each J the host's layout."""
    text = COMMON.read_text()
    const = {name: int(value) for name, value in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}
    assert const["WARP_J"] == dispatch.WARP_JOBS
    assert const["THREADS"] * const["MAX_LPT"] == dispatch.BLOCK_JOBS
    assert const["MAX_CLUSTER"] * dispatch.BLOCK_JOBS == dispatch.MAX_JOBS
    body = re.search(r"constexpr int row_layout\(int n_jobs\) \{\s*return "
                     r"(.*?);\s*\}", text, re.S).group(1)
    names = {"ROW_NONE": "none", "ROW_WARP": "warp", "ROW_BLOCK": "block",
             "ROW_CLUSTER": "cluster"}
    # the C conditional chain as a Python one: a ? b : c -> (b if a else c)
    chain = [t.strip() for t in re.split(r"[?:]", body)]
    def c_rule(n):
        env = {"n_jobs": n, "MAX_J": dispatch.BLOCK_JOBS,
               "MAX_ROW_J": dispatch.MAX_JOBS, **const}
        for cond, value in zip(chain[0::2], chain[1::2]):
            if eval(cond, {}, env):
                return names[value]
        return names[chain[-1]]
    for n in (0, 1, 8, 31, 32, 33, 8192, 8193, 65536, 65537):
        want = ("none" if n < 1 or n > dispatch.MAX_JOBS
                else dispatch.row_layout(n))
        assert c_rule(n) == want, n


@pytest.mark.parametrize("lib", FLEET_LIBS)
def test_each_fleet_kernel_dispatches_by_row_layout(lib):
    """Each fleet library (B1, B2, B3) has a warp-row instance
    (``RowWarp<WARP_ROWS>``) that its launch takes at ``row_layout ==
    ROW_WARP``, counts its launches by layout, and exports the one-block
    entry and the rows a block that ``chip_smoke.py`` and the GPU tests
    read."""
    text = (CSRC / f"{lib}.cu").read_text()
    assert re.search(r"row_layout\((p\.)?n_jobs\) == ROW_WARP", text)
    assert "RowWarp<WARP_ROWS>" in text
    for layout in ("ROW_WARP", "ROW_BLOCK", "ROW_CLUSTER"):
        assert re.search(rf"layout_launches\.count\(\s*{layout}", text), layout
    for entry in (lib, f"{lib}_one_block", f"{lib}_layout_launches",
                  f"{lib}_warp_rows", f"{lib}_occupancy"):
        assert re.search(rf'extern "C" int {entry}\(', text), entry


@pytest.mark.parametrize("j", NARROW)
def test_window_model_on_narrow_rows(j):
    """B1's warp row: the window of the kernel's ticks (sum(s1) formed only
    where needed) bitwise the plain window and within 1e-4 of the
    reference's, on rows of j jobs with +inf and 0 budgets, backlog caps
    below the queue and capacities that some row-ticks' phase 1
    overflows."""
    rng = np.random.default_rng(j + 53)
    o, w = 9, 10
    queue = (rng.random((o, j)) * 12).astype(np.float32)
    vol = np.where(rng.random((o, j)) < 0.3, np.inf,
                   rng.integers(0, 200, (o, j))).astype(np.float32)
    budget = np.where(rng.random((o, j)) < 0.5, np.inf,
                      rng.integers(0, 30, (o, j))).astype(np.float32)
    budget[:, ::7] = 0.0
    rates = rng.integers(0, 3, (w, o, j)).astype(np.float32)
    backlog = rng.choice([16.0, 64.0, 256.0], (o, j)).astype(np.float32)
    backlog[:, ::5] = queue[:, ::5] * 0.5
    cap = rng.choice([0.5, 2.0, 40.0], o).astype(np.float32)
    host = (queue, vol, budget, rates, backlog, cap)
    args = [torch.from_numpy(x) for x in host]
    got, formed = window_model.fleet_window_model(*args)
    plain = window_model.fleet_window_ref(*args)
    ref = jwindow.fleet_window_ref(*(jnp.asarray(x) for x in host))
    for name, g, p, r in zip(("queue", "vol_left", "served"), got, plain,
                             ref, strict=True):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32)), name
        r = np.asarray(r)
        np.testing.assert_array_equal(np.isfinite(g.numpy()),
                                      np.isfinite(r), err_msg=name)
        fin = np.isfinite(r)
        np.testing.assert_allclose(g.numpy()[fin], r[fin], atol=1e-4,
                                   err_msg=name)
    assert formed.shape == (w, o)


def _narrow_keys(rng, j):
    """``ROWS`` rows at width j: random eighths with -inf and -0.0 lanes,
    fractional keys with duplicates, all -inf, every key tied, -0.0 beside
    +0.0 alternating, and tied keys in twos with -inf between."""
    key = np.concatenate([_keys(rng, 3, j), np.zeros((3, j), np.float32)])
    key[3] = 0.5
    key[4, ::2] = -0.0
    key[4, 1::2] = 0.0
    key[5] = np.repeat(rng.integers(-2, 3, j // 2 + 1) / 4.0, 2)[:j]
    key[5, 2::5] = -np.inf
    return key


@pytest.mark.parametrize("j", NARROW)
def test_rank_topk_model_bitwise(j):
    """k in {0, 1, count - 1, count, count + 1, j} for every row: the direct
    rank, the radix select on one block, the port's sort and the
    reference's probe search select the same lanes."""
    key = _narrow_keys(np.random.default_rng(j + 41), j)
    padded = jnp.asarray(_pad(key, -np.inf, PAD))
    count = _counts(key)
    for ks in (np.zeros(ROWS), np.ones(ROWS), count - 1, count, count + 1,
               np.full(ROWS, j)):
        k = ks.astype(np.int32)
        got = model.topk_mask_rank(torch.from_numpy(key), torch.from_numpy(k))
        radix = model.topk_mask_radix(torch.from_numpy(key),
                                      torch.from_numpy(k))
        port = tref.topk_mask(torch.from_numpy(key),
                              torch.from_numpy(k)[:, None])
        want = np.asarray(jref.topk_mask(padded, jnp.asarray(k)[:, None]))
        for other, name in ((radix, "radix"), (port, "port")):
            np.testing.assert_array_equal(got.numpy(), other.numpy(),
                                          err_msg=f"{name} j={j} k={k}")
        np.testing.assert_array_equal(got.numpy(), want[:, :j],
                                      err_msg=f"reference j={j} k={k}")


@pytest.mark.parametrize("j", NARROW)
def test_rank_topk_model_every_k_on_tied_rows(j):
    """Every k from -1 to j + 1 on the rows of exact ties and of -0.0
    beside +0.0: the lowest-index lanes win each tie."""
    key = _narrow_keys(np.random.default_rng(j + 43), j)
    for kk in range(-1, j + 2):
        k = np.full(ROWS, kk, np.int32)
        got = model.topk_mask_rank(torch.from_numpy(key), torch.from_numpy(k))
        port = tref.topk_mask(torch.from_numpy(key),
                              torch.from_numpy(k)[:, None])
        np.testing.assert_array_equal(got.numpy(), port.numpy(),
                                      err_msg=f"j={j} k={kk}")
        first = np.arange(j) < kk
        np.testing.assert_array_equal(got[3].numpy(), first)
        np.testing.assert_array_equal(got[4].numpy(), first)


@pytest.mark.parametrize("j", NARROW)
def test_warp_excess_model_matches_bit_descent(j):
    """From no excess to every token held, over floors up to 5000 and up to
    2^25 (the descent's cap), zeros past the last lane included."""
    rng = np.random.default_rng(j + 47)
    floored = np.floor(rng.random((ROWS, j)) * rng.choice(
        [2.0, 40.0, 5000.0], (ROWS, 1)))
    floored[rng.random((ROWS, j)) < 0.3] = 0.0
    floored[0, -1] = 0.0
    floored[1] = 0.0
    floored[5, 0] = 2.0**26
    total = np.minimum(floored, 2.0**25).sum(1)
    d_dn = np.array([0.0, 1.0, total[2] // 3, total[3] - 1, total[4],
                     total[5] - 7], np.float32)
    f32 = torch.from_numpy(floored.astype(np.float32))
    p, g_p = model.excess_rounds_warp(f32, torch.from_numpy(d_dn))
    want_p, want_g = _bit_descent(np.minimum(floored, 2.0**25), d_dn)
    np.testing.assert_array_equal(p.numpy(), want_p)
    np.testing.assert_array_equal(g_p.numpy(), want_g)
    # the block's descent on the same rows (row 1: every candidate fits)
    block_p, block_g = model.excess_rounds(f32, torch.from_numpy(d_dn))
    np.testing.assert_array_equal(p.numpy(), block_p.numpy())
    np.testing.assert_array_equal(g_p.numpy(), block_g.numpy())
