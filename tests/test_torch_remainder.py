"""The port's largest-remainder machinery (``repro_torch.core.remainder``)
against the reference's (``repro.core.remainder``), called eagerly on the
same numpy inputs.  The integer path must be bitwise: every step is an
int32 count or an exact integer-valued float sum, so reduction order cannot
move it (ROADMAP parity contract).

The reference is called on inputs padded to J = 4096 with excluded lanes
(-inf keys, unmasked jobs) after the real ones: such lanes come after every
real lane in (key descending, index ascending) order and take no tokens,
so the real lanes' result is unchanged, and eager JAX compiles its
primitives once instead of once per width.  The port runs unpadded."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_topk_select import random_case

from repro.core import remainder as jref
from repro_torch.core import remainder as tref

torch.set_num_threads(1)

PAD = 4096


def _pad(x, value):
    out = np.full(x.shape[:-1] + (PAD,), value, x.dtype)
    out[..., :x.shape[-1]] = x
    return out


def _topk_keys(rng, j, trial):
    key = (rng.integers(-8, 9, j) / 8.0).astype(np.float32)  # many ties
    key[rng.random(j) < 0.3] = -np.inf
    if trial == 0:
        key[rng.random(j) < 0.2] = -0.0  # must tie with +0.0
    return key


@pytest.mark.parametrize("j", [1, 2, 7, 128, 300, 1024, 4096])
def test_topk_mask_bitwise(j):
    rng = np.random.default_rng(j)
    for trial in range(3):
        key = _topk_keys(rng, j, trial)
        padded = jnp.asarray(_pad(key, -np.inf))
        for k in (0, 1, j // 3, j - 1, j, j + 17):
            want = np.asarray(jref.topk_mask(padded, jnp.int32(k)))[:j]
            got = tref.topk_mask(torch.from_numpy(key), k).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"j={j} k={k}")
    np.testing.assert_array_equal(
        tref.rank_desc(torch.from_numpy(key)).numpy(),
        np.asarray(jref.rank_desc(jnp.asarray(key))))


def test_topk_mask_batched_rows_bitwise():
    rng = np.random.default_rng(0)
    key = rng.random((5, 257)).astype(np.float32)
    key[:, ::3] = key[:, :1]                        # ties within each row
    k = rng.integers(0, 300, (5, 1)).astype(np.int32)
    want = np.asarray(jref.topk_mask(jnp.asarray(_pad(key, -np.inf)),
                                     jnp.asarray(k)))[:, :257]
    got = tref.topk_mask(torch.from_numpy(key), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, want)


def _integerize_both(raw, rem, budget, mask):
    j = raw.shape[-1]
    want = jref.integerize(jnp.asarray(_pad(raw, 0.0)),
                           jnp.asarray(_pad(rem, 0.0)), jnp.asarray(budget),
                           jnp.asarray(_pad(mask, False)))
    got = tref.integerize(torch.from_numpy(raw), torch.from_numpy(rem),
                          torch.as_tensor(budget), torch.from_numpy(mask))
    for g, w, name in zip(got, want, ("alloc", "remainder")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[..., :j],
                                      err_msg=name)
    return got


@pytest.mark.parametrize("j", [1, 3, 16, 128, 1000, 4096])
def test_integerize_bitwise(j):
    """In-contract draws and out-of-contract ones (budget off by up to 50
    tokens: leftover and excess rows), with negative carried remainders."""
    rng = np.random.default_rng(j * 7 + 1)
    for in_contract in (True, False):
        for _ in range(3):
            raw, rem, budget, mask = random_case(rng, j, in_contract)
            _integerize_both(raw, rem, np.float32(budget), mask)


def test_integerize_bitwise_on_ties_and_multi_round_excess():
    """Row-batched: equal remainders everywhere (the index tie-break
    decides), a leftover of several full rounds, and excess rows that need
    several take-one rounds before the partial top-k round."""
    rng = np.random.default_rng(3)
    o, j = 6, 300
    mask = rng.random((o, j)) < 0.8
    raw = np.where(mask, 2.5, 0.0).astype(np.float32)        # all tied
    rem = np.zeros((o, j), np.float32)
    rem[1] = -0.75                                           # negative carry
    floored = np.floor(raw).sum(axis=1)
    budget = np.stack([floored[0] + 7,                       # partial round
                       floored[1] + 3 * mask[1].sum() + 5,   # full rounds
                       floored[2] - 9,                       # partial excess
                       floored[3] - 1.5 * mask[3].sum(),     # multi-round
                       np.zeros(()),                         # take all
                       floored[5]])[:, None].astype(np.float32)
    alloc, _ = _integerize_both(raw, rem, budget, mask)
    assert (alloc.numpy() >= 0).all()
