"""The plain models of the allocation kernel's searches
(``repro_torch.kernels.adaptbf_alloc.ref``: the radix ``topk_mask_radix``,
the 32-candidate ``excess_rounds`` and ``integerize_model`` built on them,
written digit by digit as ``csrc/alloc_round.cuh`` runs them) held bitwise
against the port's ``core/remainder.py`` (sort-based top-k, 25-step bit
descent) and the reference's ``repro.core.remainder`` (probe searches), on
seeded numpy rows: many exact ties, -0.0 beside +0.0, -inf keys, all keys
-inf, a zero budget, and k at 0, 1 and around the count of finite keys.
``integerize_model`` runs each row on one block, or (cases ``warp-J``) at
J <= 32 on one warp, the kernels' narrow layout, with the warp row's
searches (``topk_mask_rank``, ``excess_rounds_warp``).

The reference runs on rows padded to J = 8192 with excluded lanes (-inf
keys, unmasked jobs) after the real ones, which rank after every real lane
and take no tokens, so eager JAX compiles each primitive once.  Rows wider
than 8192 (8193, 16384, 32768, 40000, 65536: a cluster of 2, 2, 4, 8 and 8
blocks in the kernels, 40000 in slices of 5000) are padded to 65536 and run
the models with the cluster split, the
row's slices counted block by block; their cases put exact ties and -0.0
beside +0.0 across every slice edge and k on every slice boundary."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_topk_select import random_case

from repro.core import remainder as jref
from repro_torch.core import remainder as tref
from repro_torch.kernels.adaptbf_alloc import ref as model
from repro_torch.kernels.dispatch import MAX_JOBS, WARP_JOBS

torch.set_num_threads(1)

PAD = 8192
WIDTHS = [1, 7, 8, 31, 32, 4095, 4096, 8192]
NARROW = [j for j in WIDTHS if j <= WARP_JOBS]   # rows a warp runs
WIDE_PAD = MAX_JOBS                 # 65536
WIDE = [8193, 16384, 32768, 40000, 65536]  # clusters of 2, 2, 4, 8, 8 blocks
WIDE_ROWS = 4                       # one shape a primitive at WIDE_PAD


def _pad(x, value, pad=PAD):
    out = np.full(x.shape[:-1] + (pad,), value, x.dtype)
    out[..., :x.shape[-1]] = x
    return out


def _edges(j):
    """The lane where each block's slice of a row of j starts (past 0)."""
    return [a for a, _ in model._slices(j)[1:]]


def _keys(rng, rows, j):
    """Rows of keys: eighths (many exact ties) with -inf and -0.0 lanes,
    fractional remainders with duplicated values, and a row all -inf."""
    key = (rng.integers(-8, 9, (rows, j)) / 8.0).astype(np.float32)
    key[rng.random((rows, j)) < 0.3] = -np.inf
    key[rng.random((rows, j)) < 0.2] = -0.0
    key[1] = rng.random(j).astype(np.float32)
    key[1, ::3] = key[1, 0]
    key[2] = -np.inf
    return key


def _counts(key):
    return np.isfinite(key).sum(axis=1)


@pytest.mark.parametrize("j", WIDTHS)
def test_radix_topk_model_bitwise(j):
    """k in {0, 1, count - 1, count, count + 1, j} for every row."""
    rng = np.random.default_rng(j + 11)
    key = _keys(rng, 4, j)
    padded = jnp.asarray(_pad(key, -np.inf))
    count = _counts(key)
    for ks in (np.zeros(4), np.ones(4), count - 1, count, count + 1,
               np.full(4, j)):
        k = ks.astype(np.int32)
        got = model.topk_mask_radix(torch.from_numpy(key), torch.from_numpy(k))
        port = tref.topk_mask(torch.from_numpy(key), torch.from_numpy(k)[:, None])
        want = np.asarray(jref.topk_mask(padded, jnp.asarray(k)[:, None]))[:, :j]
        np.testing.assert_array_equal(got.numpy(), port.numpy(),
                                      err_msg=f"j={j} k={k}")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"j={j} k={k}")


def test_radix_topk_model_ties_at_every_digit():
    """Keys that share their top one, two and three bytes, so the search
    runs all four passes and breaks index ties among exact duplicates."""
    base = np.float32(0.7).view(np.int32)
    offs = np.array([0, 1, 1, 1, 256, 256, 65536, 65536, 2, 0, 0, 3],
                    np.int32)
    key = np.tile((base + offs).view(np.float32), (3, 50))
    key[1, ::7] = -0.0
    key[1, 3::7] = 0.0
    for k in (1, 2, 3, 4, 5, 50, 51, 299, 300, 599, 600):
        kk = np.array([k, k, k], np.int32)
        got = model.topk_mask_radix(torch.from_numpy(key), torch.from_numpy(kk))
        want = np.asarray(jref.topk_mask(jnp.asarray(_pad(key, -np.inf)),
                                         jnp.asarray(kk)[:, None]))[:, :600]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")


@pytest.mark.parametrize("j", [40, 300, 4096])
def test_radix_topk_model_tied_keys_over_many_binades(j):
    """Keys spread over many binades, each value repeated (exact ties),
    with -0.0 beside +0.0 and -inf lanes, bitwise with the port's sort and
    the reference's probe search.  A search ends by the index rank of tied
    keys exactly when the k-th and (k+1)-th largest keys are equal, else by
    the exact-count stop: both endings occur among the cases."""
    rng = np.random.default_rng(j + 29)
    vals = (rng.random(j // 3 + 1) * 2.0 ** rng.integers(-60, 60, j // 3 + 1)
            * rng.choice([-1.0, 1.0], j // 3 + 1)).astype(np.float32)
    key = np.stack([np.repeat(vals, 3)[:j], rng.permutation(np.repeat(vals, 3)[:j])])
    key[1, rng.random(j) < 0.2] = -np.inf
    key[0, ::11] = 0.0
    key[0, 5::11] = -0.0
    padded = jnp.asarray(_pad(key, -np.inf))
    desc = -np.sort(-key, axis=1)
    endings = set()
    for kk in (1, 2, 3, j // 7, j // 2, j - 2):
        k = np.array([kk, kk], np.int32)
        got = model.topk_mask_radix(torch.from_numpy(key), torch.from_numpy(k))
        port = tref.topk_mask(torch.from_numpy(key), torch.from_numpy(k)[:, None])
        want = np.asarray(jref.topk_mask(padded, jnp.asarray(k)[:, None]))[:, :j]
        np.testing.assert_array_equal(got.numpy(), port.numpy(), err_msg=f"k={k}")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
        endings.update(desc[:, kk - 1] == desc[:, kk])
    assert endings == {True, False}


def _wide_keys(rng, j):
    """Four rows at width j: random eighths with -inf and -0.0 lanes and
    runs of one value across each slice edge, -0.0 just before and +0.0
    at the edge; every key tied; fractional keys tied in threes; and keys
    that grow by slice (each slice one value, -0.0 for the second)."""
    key = _keys(rng, WIDE_ROWS, j)
    for e in _edges(j):
        key[0, e - 3:e + 3] = 0.375
        key[0, e - 1], key[0, e] = -0.0, 0.0
    key[1] = 0.5
    key[2] = np.repeat(rng.random(j // 3 + 1).astype(np.float32), 3)[:j]
    for q, (a, b) in enumerate(model._slices(j)):
        key[3, a:b] = -0.0 if q == 1 else np.float32(q)
    return key


@pytest.mark.parametrize("j", WIDE)
def test_radix_topk_model_bitwise_across_slices(j):
    """The model with the row split as the kernels' cluster splits it,
    bitwise with the model on one block, the port's sort and the
    reference's probe search; k at 1, every slice boundary and one each
    side of it, the count of finite keys and j - 1."""
    rng = np.random.default_rng(j + 5)
    key = _wide_keys(rng, j)
    padded = jnp.asarray(_pad(key, -np.inf, WIDE_PAD))
    assert len(model._slices(j)) == {8193: 2, 16384: 2, 32768: 4,
                                     40000: 8, 65536: 8}[j]
    ks = [1, *(e + d for e in _edges(j) for d in (-1, 0, 1)), j - 1]
    for kk in ks:
        k = np.full(WIDE_ROWS, kk, np.int32)
        k[0] = min(int(_counts(key)[0]), kk)
        got = model.topk_mask_radix(torch.from_numpy(key), torch.from_numpy(k))
        one = model.topk_mask_radix(torch.from_numpy(key), torch.from_numpy(k),
                                    blocks=1)
        port = tref.topk_mask(torch.from_numpy(key), torch.from_numpy(k)[:, None])
        want = np.asarray(jref.topk_mask(padded, jnp.asarray(k)[:, None]))[:, :j]
        np.testing.assert_array_equal(got.numpy(), one.numpy(), err_msg=f"k={k}")
        np.testing.assert_array_equal(got.numpy(), port.numpy(), err_msg=f"k={k}")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")
    # every tied row selects its first k lanes: k on a slice edge ends the
    # selection exactly there
    e = _edges(j)[0]
    k = np.full(WIDE_ROWS, e, np.int32)
    got = model.topk_mask_radix(torch.from_numpy(key), torch.from_numpy(k))
    assert got[1, :e].all() and not got[1, e:].any()


def _bit_descent(floored, d_dn):
    """The reference's 25-step descent on exact sums: (p, g(p))."""
    f = floored.astype(np.int64)
    p = np.zeros(len(f), np.int64)
    for bit in range(24, -1, -1):
        cand = p | (1 << bit)
        g = np.minimum(f, cand[:, None]).sum(1).astype(np.float32)
        p = np.where(g <= d_dn, cand, p)
    return p, np.minimum(f, p[:, None]).sum(1).astype(np.float32)


@pytest.mark.parametrize("j", WIDTHS)
def test_excess_model_matches_bit_descent(j):
    """Excess from a token to every token held, over floors up to 5000."""
    rng = np.random.default_rng(j)
    floored = np.floor(rng.random((6, j)) * rng.choice([2.0, 40.0, 5000.0],
                                                         (6, 1)))
    floored[rng.random((6, j)) < 0.3] = 0.0
    total = floored.sum(1)
    d_dn = np.array([0.0, 1.0, total[2] // 3, total[3] - 1, total[4],
                     total[5] + 10], np.float32)
    p, g_p = model.excess_rounds(torch.from_numpy(floored.astype(np.float32)),
                                 torch.from_numpy(d_dn))
    want_p, want_g = _bit_descent(floored, d_dn)
    np.testing.assert_array_equal(p.numpy(), want_p)
    np.testing.assert_array_equal(g_p.numpy(), want_g)


@pytest.mark.parametrize("j", WIDE)
def test_excess_model_across_slices_matches_bit_descent(j):
    """The excess descent with each candidate's sum split by slice, from a
    token to every token held, over floors up to 5000; runs of one floor
    across every slice edge."""
    rng = np.random.default_rng(j + 1)
    floored = np.floor(rng.random((6, j)) * rng.choice([2.0, 40.0, 5000.0],
                                                         (6, 1)))
    floored[rng.random((6, j)) < 0.3] = 0.0
    for e in _edges(j):
        floored[:, e - 2:e + 2] = 7.0
    total = floored.sum(1)
    d_dn = np.array([0.0, 1.0, total[2] // 3, total[3] - 1, total[4],
                     total[5] + 10], np.float32)
    p, g_p = model.excess_rounds(torch.from_numpy(floored.astype(np.float32)),
                                 torch.from_numpy(d_dn))
    want_p, want_g = _bit_descent(floored, d_dn)
    np.testing.assert_array_equal(p.numpy(), want_p)
    np.testing.assert_array_equal(g_p.numpy(), want_g)


def _integerize_all(raw, rem, budget, mask, warp=False):
    """The model (on one warp a row with ``warp``), the port and the
    reference on [R, J] rows: bitwise."""
    j = raw.shape[-1]
    pad = PAD if j <= PAD else WIDE_PAD
    got = model.integerize_model(torch.from_numpy(raw), torch.from_numpy(rem),
                                 torch.from_numpy(budget),
                                 torch.from_numpy(mask), warp=warp)
    port = tref.integerize(torch.from_numpy(raw), torch.from_numpy(rem),
                           torch.from_numpy(budget)[:, None],
                           torch.from_numpy(mask))
    want = jref.integerize(jnp.asarray(_pad(raw, 0.0, pad)),
                           jnp.asarray(_pad(rem, 0.0, pad)),
                           jnp.asarray(budget)[:, None],
                           jnp.asarray(_pad(mask, False, pad)))
    for g, p, w, name in zip(got, port, want, ("alloc", "remainder")):
        np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, :j],
                                      err_msg=name)


@pytest.mark.parametrize("j,warp", [(j, False) for j in WIDTHS]
                         + [(j, True) for j in NARROW],
                         ids=[str(j) for j in WIDTHS]
                         + [f"warp-{j}" for j in NARROW])
def test_integerize_model_bitwise(j, warp):
    """In-contract rows and rows whose budget is off by up to 50 tokens
    (leftover and excess), with negative carried remainders."""
    rng = np.random.default_rng(j * 5 + 3)
    cases = [random_case(rng, j, in_contract) for in_contract in
             (True, True, False, False, False)]
    raw, rem, budget, mask = (np.stack([c[i] for c in cases])
                              for i in range(4))
    _integerize_all(raw, rem, budget.astype(np.float32), mask, warp)


def test_integerize_model_on_stress_rows():
    """Exact remainder ties everywhere, a zero budget, an empty mask, a
    multi-round leftover and a multi-round excess, at J = 4096."""
    rng = np.random.default_rng(7)
    rows, j = 6, 4096
    mask = rng.random((rows, j)) < 0.8
    mask[4] = False                                           # nothing masked
    raw = np.where(mask, 2.5, 0.0).astype(np.float32)        # all tied
    rem = np.zeros((rows, j), np.float32)
    rem[1] = -0.75                                           # negative carry
    floored = np.floor(raw + rem).clip(0).sum(axis=1)
    budget = np.array([floored[0] + 7, floored[1] + 3 * mask[1].sum() + 5,
                       floored[2] - 9, floored[3] - 1.5 * mask[3].sum(),
                       0.0, 0.0], np.float32)
    _integerize_all(raw, rem, budget, mask)


@pytest.mark.parametrize("j", NARROW)
def test_integerize_warp_model_on_stress_rows(j):
    """On one warp a row: (0) every remainder tied with a one-token
    leftover, (1) a leftover of several rounds over a negative carry, (2)
    an excess of a few tokens among ties, (3) an excess of several rounds,
    (4) nothing masked, (5) a zero budget over carried remainders."""
    rng = np.random.default_rng(j + 53)
    mask = rng.random((6, j)) < 0.8
    mask[:, 0] = True
    mask[4] = False
    raw = np.where(mask, 2.5, 0.0).astype(np.float32)
    rem = np.zeros((6, j), np.float32)
    rem[1] = -0.75
    rem[5] = np.where(mask[5], 3.5, 0.0)
    floored = np.floor(np.where(mask, raw + rem, 0.0)).clip(0).sum(axis=1)
    n = mask.sum(axis=1)
    budget = np.array([floored[0] + 1, floored[1] + 3 * n[1] + 5,
                       floored[2] - 2, floored[3] - 1.5 * n[3], 0.0, 0.0],
                      np.float32)
    _integerize_all(raw, rem, budget, mask, warp=True)


def test_integerize_warp_model_takes_at_most_32_jobs():
    row = torch.zeros((1, WARP_JOBS + 1))
    with pytest.raises(ValueError, match="32"):
        model.integerize_model(row, row, torch.zeros(1), row > 0, warp=True)


@pytest.mark.parametrize("j", WIDE)
def test_integerize_model_across_slices_bitwise(j):
    """Rows over a cluster: (0) every remainder tied with a leftover that
    ends on the first slice edge, (1) a random row whose budget is 9 tokens
    short, (2) tied remainders with an excess that ends on a slice edge,
    (3) an in-contract random row."""
    rng = np.random.default_rng(j + 3)
    e = _edges(j)[0]
    mask = np.ones((WIDE_ROWS, j), bool)
    mask[1, rng.random(j) < 0.2] = False
    raw = np.full((WIDE_ROWS, j), 2.5, np.float32)
    raw[1] = (rng.random(j) * 40).astype(np.float32)
    rem = np.zeros((WIDE_ROWS, j), np.float32)
    rem[1] = (rng.random(j) - 0.5).astype(np.float32)
    case = random_case(rng, j, True)
    raw[3], rem[3], mask[3] = case[0], case[1], case[3]
    floored = np.floor(np.where(mask, raw + rem, 0.0)).clip(0).sum(axis=1)
    budget = np.array([floored[0] + e, floored[1] - 9, floored[2] - e,
                       case[2]], np.float32)
    _integerize_all(raw, rem, budget, mask)
