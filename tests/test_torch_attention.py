"""The port's attention (``repro_torch.kernels.attention``) on the CPU against
the reference package: the plain ``mha``/``decode_attention`` against
``repro.kernels.attention.ref`` and against the Pallas kernels run in
interpret mode (``flash_attention``/``flash_decode``, as
``tests/test_kernel_attention.py`` runs them), and the wrappers' CPU route
(un-broadcast KV) against the plain versions.  The decode kernel's host
split plan and its split-and-merge arithmetic (``ref.decode_attention_split``)
are held against the whole-sequence decode and the reference too.

Inputs are float32 arrays from a seeded numpy generator, rounded to
bfloat16 by each framework alike for the bfloat16 cases.  Tolerances are
the reference's kernel tests': float32 atol/rtol 2e-5, bfloat16 2e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import kernel as jkernel
from repro.kernels.attention import ref as jref
from repro_torch.kernels.attention import ops, ref

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bcast_np(x, hq):
    b, t, hkv, d = x.shape
    return np.repeat(x, hq // hkv, axis=2)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(x, dtype):
    return torch.from_numpy(x).to(_T[dtype])


def _j(x, dtype):
    return jnp.asarray(x, _J[dtype])


_jmha = jax.jit(jref.mha, static_argnames=("causal",))
_jflash = jax.jit(jkernel.flash_attention, static_argnames=("causal",
                                                            "interpret"))


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (1, 128, 4, 4, 64),
    (2, 256, 8, 2, 64),     # GQA 4x
    (2, 96, 4, 4, 80),      # zamba head dim
    (1, 200, 2, 2, 96),     # ragged S
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_mha_matches_reference_and_its_kernel(b, s, hq, hkv, d, causal,
                                                    dtype):
    q, k, v = _arrays(s + d, (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    kb, vb = _bcast_np(k, hq), _bcast_np(v, hq)
    got_plain = ref.mha(_t(q, dtype), _t(kb, dtype), _t(vb, dtype),
                        causal=causal)
    got_op = ops.attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                           causal=causal)
    assert got_plain.dtype == got_op.dtype == _T[dtype]
    assert torch.equal(got_plain, got_op)   # the CPU route is the plain one
    want = _jmha(_j(q, dtype), _j(kb, dtype), _j(vb, dtype), causal=causal)
    _close(got_plain.float(), want, dtype)
    kern = _jflash(_j(q, dtype), _j(k, dtype), _j(v, dtype), causal=causal,
                   interpret=True)
    _close(got_plain.float(), kern, dtype)


def test_lse_matches_the_reference_forward():
    q, k, v = _arrays(5, (2, 130, 4, 80), (2, 130, 4, 80), (2, 130, 4, 80))
    o, lse = ops.attention_lse(*(torch.from_numpy(x) for x in (q, k, v)))
    wo, wl = jax.jit(jref._fwd, static_argnums=(3, 4))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 130)
    _close(o, wo, "float32")
    _close(lse, wl, "float32")
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 130, 4)


_jdecode = jax.jit(jref.decode_attention)
_jflash_decode = jax.jit(jkernel.flash_decode, static_argnames=("interpret",))


@pytest.mark.parametrize("t,lens", [(128, (1, 37, 128, 128)),
                                    (300, (300, 1, 5, 299)),
                                    (96, (96, 2, 1, 50))])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_matches_reference_and_its_kernel(t, lens, hq, hkv, d,
                                                       dtype):
    b = len(lens)
    q, k, v = _arrays(t + hq + d, (b, 1, hq, d), (b, t, hkv, d),
                      (b, t, hkv, d))
    length = np.asarray(lens, np.int32)
    kb, vb = _bcast_np(k, hq), _bcast_np(v, hq)
    got_plain = ref.decode_attention(_t(q, dtype), _t(kb, dtype),
                                     _t(vb, dtype), torch.from_numpy(length))
    got_op = ops.decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                  torch.from_numpy(length))
    assert torch.equal(got_plain, got_op)
    want = _jdecode(_j(q, dtype), _j(kb, dtype), _j(vb, dtype),
                    jnp.asarray(length))
    _close(got_plain.float(), want, dtype)
    kern = _jflash_decode(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                          jnp.asarray(length), interpret=True)
    _close(got_plain.float(), kern, dtype)


def test_decode_of_an_empty_sequence_follows_the_reference_softmax():
    """length 0 masks every key; the reference's softmax over an all-masked
    row weighs every key alike (no NaN)."""
    q, k, v = _arrays(9, (2, 1, 2, 16), (2, 8, 2, 16), (2, 8, 2, 16))
    length = np.asarray([0, 3], np.int32)
    got = ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(length))
    want = _jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(length))
    assert bool(torch.isfinite(got).all())
    _close(got, want, "float32")
    np.testing.assert_allclose(got[0, 0].numpy(), v[0].mean(axis=0),
                               atol=2e-5)


def test_decode_reads_the_fused_cache_by_stride():
    """The layer hands the wrapper a [B,T,Hkv,hd] view of the fused
    [B,T,Hkv*hd] cache; the CPU route takes it as it is."""
    q, cache_k, cache_v = _arrays(3, (2, 1, 4, 16), (2, 10, 32), (2, 10, 32))
    length = torch.tensor([10, 4], dtype=torch.int32)
    kc = torch.from_numpy(cache_k).reshape(2, 10, 2, 16)
    vc = torch.from_numpy(cache_v).reshape(2, 10, 2, 16)
    got = ops.decode_attention(torch.from_numpy(q), kc, vc, length)
    want = ref.decode_attention(torch.from_numpy(q),
                                ref.broadcast_kv(kc, 4),
                                ref.broadcast_kv(vc, 4), length)
    assert torch.equal(got, want)


@pytest.mark.parametrize("t,b,hq,hkv,n_sm", [
    (128, 4, 32, 32, 132),      # the engine: one split
    (32768, 8, 32, 32, 132),    # the long cache
    (4096, 7, 8, 2, 132),
    (1000, 1, 8, 1, 132),       # T not a multiple of 64
    (513, 2, 4, 4, 8),
    (1, 1, 1, 1, 132),
])
def test_decode_split_plan_covers_every_key_once(t, b, hq, hkv, n_sm):
    """Split i holds keys [i * L, min((i + 1) * L, T)): every key below T
    lands in exactly one split, none is empty, and the plan is plain
    integers from shapes alone (the kernel never reads the lengths on the
    host)."""
    split_len, n_split = ops.decode_split_plan(t, b, hq, hkv, n_sm)
    assert type(split_len) is int and type(n_split) is int
    assert split_len % 64 == 0 and n_split >= 1
    covered = np.zeros(t, np.int64)
    for i in range(n_split):
        lo, hi = i * split_len, min((i + 1) * split_len, t)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if t <= ops.DECODE_MIN_SPLIT:
        assert n_split == 1            # short caches: one launch, no scratch
    assert ops.decode_split_plan(t, b, hq, hkv, n_sm) == (split_len, n_split)


@pytest.mark.parametrize("split_len", [1, 7, 16, 33, 64, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_split_decode_matches_reference(split_len, dtype):
    """The kernel's split-and-merge, in plain PyTorch, equals the
    whole-sequence decode and the reference's: lengths 0 (mean of V over
    all T keys), 1, past T, and splits wholly past a length (empty)."""
    t, hq, hkv, d = 96, 4, 2, 16
    lens = (0, 1, 33, 96, 200)
    b = len(lens)
    q, k, v = _arrays(split_len + 7, (b, 1, hq, d), (b, t, hkv, d),
                      (b, t, hkv, d))
    length = np.asarray(lens, np.int32)
    kb, vb = _bcast_np(k, hq), _bcast_np(v, hq)
    got = ref.decode_attention_split(_t(q, dtype), _t(kb, dtype),
                                     _t(vb, dtype), torch.from_numpy(length),
                                     split_len)
    assert got.dtype == _T[dtype] and bool(torch.isfinite(got).all())
    whole = ref.decode_attention(_t(q, dtype), _t(kb, dtype), _t(vb, dtype),
                                 torch.from_numpy(length))
    _close(got.float(), whole.float(), dtype)
    want = _jdecode(_j(q, dtype), _j(kb, dtype), _j(vb, dtype),
                    jnp.asarray(length))
    _close(got.float(), want, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got[0, 0].numpy(), vb[0].mean(axis=0),
                                   atol=2e-5)
