"""The port's training slice on the CPU against the reference package:

* the attention backward: ``ref._bwd_impl`` and the differentiable plain
  ``mha`` (and ``ops.attention``, whose CPU path they are) against
  ``jax.vjp`` of the reference's ``ref.mha`` -- causal, non-causal, GQA by
  broadcast, S not a multiple of ``block_kv`` -- at 1e-5; the port of
  ``test_oracle_grad_matches_dense``;
* the differentiable ``ssd`` against ``jax.grad`` of ``ref.ssd_chunked``;
* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
  reference's, float32, for zamba2-2.7b's and phi3-mini-3.8b's smoke
  configs, chunked and one-chunk cross-entropy: loss 1e-5, gradients
  1e-4 x max(1, max |g|) a leaf (zamba2: 2e-4, see ``GRAD_TOL``), and the
  port's float32 gradients within 1e-4 x max(1, max |g|) of its own float64
  ones; remat leaves them bitwise unchanged;
The train step, the optimizer, the pipeline and the trainer:
``tests/test_torch_optim_data.py``.  Weights come from the reference's ``init_params`` through
``params_from_numpy``; inputs from numpy seeds."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_smoke_config as jconfig
from repro.kernels.attention import ref as jattn
from repro.kernels.ssd import ref as jssd
from repro_torch import models
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import steps
from repro_torch.models.model import _leaf_paths

torch.set_num_threads(1)

BATCH, SEQ = 2, 32
PHI = "phi3-mini-3.8b"      # its smoke config has 2 layers
ZAMBA = "zamba2-2.7b"


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|), elementwise."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    bound = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def _bcast(x, hq):
    b, t, hkv, d = x.shape
    return jnp.broadcast_to(x[:, :, :, None, :],
                            (b, t, hkv, hq // hkv, d)).reshape(b, t, hq, d)


# ---------------------------------------------------------- attention backward

ATTN_CASES = {   # b, s, hq, hkv, d, causal, block_kv
    "causal": (2, 96, 4, 4, 16, True, 32),
    "non_causal": (1, 80, 2, 2, 32, False, 32),
    "gqa": (2, 64, 8, 2, 16, True, 32),
    "ragged": (1, 100, 2, 2, 16, True, 32),    # S not a multiple of block_kv
}


def _attn_inputs(case):
    b, s, hq, hkv, d, causal, block = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in
               ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    do = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    return q, k, v, do, hq, causal, block


@functools.lru_cache(maxsize=None)
def _jattn_grads(case):
    q, k, v, do, hq, causal, block = _attn_inputs(case)

    def f(q, k, v):
        return jattn.mha(q, _bcast(k, hq), _bcast(v, hq), causal=causal,
                         block_kv=block)

    @jax.jit
    def o_and_grads(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return (o,) + vjp(do)

    return tuple(np.asarray(x) for x in
                 o_and_grads(*map(jnp.asarray, (q, k, v, do))))


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("path", ["ref.mha", "ops.attention"])
def test_attention_backward_matches_reference_vjp(case, path):
    q, k, v, do, hq, causal, block = _attn_inputs(case)
    want = _jattn_grads(case)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    if path == "ref.mha":
        o = attn_ref.mha(qt, attn_ref.broadcast_kv(kt, hq),
                         attn_ref.broadcast_kv(vt, hq), causal=causal,
                         block_kv=block)
    else:   # the wrapper's CPU path: block_kv as the model calls it
        o = attn_ops.attention(qt, kt, vt, causal=causal)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.tensor(do))
    for got, ref in zip((o,) + grads, want):
        _close(got, ref, 1e-5)


@pytest.mark.parametrize("case", ["causal", "ragged"])
def test_bwd_impl_matches_reference(case):
    """``_bwd_impl`` on the same o, lse and dO as the reference's."""
    q, k, v, do, hq, causal, block = _attn_inputs(case)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jattn._fwd(jq, jk, jv, causal, block)
    want = jattn._bwd_impl(jq, jk, jv, o, lse, jdo, causal, block)
    got = attn_ref._bwd_impl(*(torch.tensor(np.asarray(x)) for x in
                               (q, k, v, o, lse, do)), causal, block)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_oracle_grad_matches_dense():
    """The recompute backward matches autograd through the naive dense
    softmax attention (port of the reference's test of the same name)."""
    b, s, h, d = 1, 96, 2, 32
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((b, s, h, d)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))

    def naive(q, k, v):
        logits = torch.einsum("bshd,bthd->bsht", q, k) * (d ** -0.5)
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool))
        logits = logits.masked_fill(~mask[None, :, None, :], -1e30)
        return torch.einsum("bsht,bthd->bshd", torch.softmax(logits, -1), v)

    gf = torch.autograd.grad(torch.tanh(attn_ref.mha(
        q, k, v, causal=True, block_kv=32)).sum(), (q, k, v))
    gn = torch.autograd.grad(torch.tanh(naive(q, k, v)).sum(), (q, k, v))
    for a, b_ in zip(gf, gn):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-3)


# ------------------------------------------------------------------- SSD

SSD_CASES = {   # b, s, h, p, n, warm start
    "cold": (2, 40, 3, 8, 4, False),
    "warm_ragged": (1, 37, 2, 4, 8, True),
}


def _ssd_inputs(case):
    b, s, h, p, n, warm = SSD_CASES[case]
    rng = np.random.default_rng(5 + len(case))
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(f)
    a = -np.exp(rng.random(h) * 1.5).astype(f)
    B = (rng.standard_normal((b, s, n)) * n ** -0.5).astype(f)
    C = (rng.standard_normal((b, s, n)) * n ** -0.5).astype(f)
    d_skip = np.linspace(0.5, 1.5, h).astype(f)
    h0 = rng.standard_normal((b, h, p, n)).astype(f) if warm else None
    wy = rng.standard_normal((b, s, h, p)).astype(f)
    ws = rng.standard_normal((b, h, p, n)).astype(f)
    return [x, dt, a, B, C, d_skip, h0], wy, ws


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_gradient_matches_reference(case):
    args, wy, ws = _ssd_inputs(case)
    live = [i for i, x in enumerate(args) if x is not None]

    def jloss(*xs):
        full = list(args)
        for i, x in zip(live, xs):
            full[i] = x
        y, st = jssd.ssd_chunked(*full[:5], d_skip=full[5],
                                 initial_state=full[6], chunk=16)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    want = jax.grad(jloss, argnums=tuple(range(len(live))))(
        *(jnp.asarray(args[i]) for i in live))
    ts = [None if x is None else torch.tensor(x, requires_grad=True)
          for x in args]
    y, st = ssd_ops.ssd(*ts[:5], d_skip=ts[5], initial_state=ts[6],
                        chunk=16)
    loss = (y * torch.tensor(wy)).sum() + (st * torch.tensor(ws)).sum()
    got = torch.autograd.grad(loss, [ts[i] for i in live])
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


# --------------------------------------------------------------- loss_fn


def _jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _stacked(cfg, tree):
    """The port's parameter tree keyed by the reference's path strings,
    per-block leaves stacked."""
    out = {}
    for key, path in _leaf_paths(models.model_defs(cfg)):
        if None in path:
            rows = []
            for block in tree["layers"]:
                node = block
                for k in path[2:]:
                    node = node[k]
                rows.append(_np(node))
            out[key] = np.stack(rows)
        else:
            node = tree
            for k in path:
                node = node[k]
            out[key] = _np(node)
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = jconfig(arch)
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return cfg, jparams, batch


def _port_params(arch):
    cfg, jparams, _ = _setup(arch)
    return models.params_from_numpy(get_smoke_config(arch),
                                    _jleaves(jparams), device="cpu")


def _tbatch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jloss(arch, ce_chunk):
    cfg, jparams, batch = _setup(arch)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, cfg, b, dtype=jnp.float32,
                                ce_chunk=ce_chunk)))
    loss, grads = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), _jleaves(grads)


def _port_loss(cfg, params, batch, ce_chunk=512):
    return steps._value_and_grad(
        lambda p, b: models.loss_fn(p, cfg, b, dtype=torch.float32,
                                    ce_chunk=ce_chunk), params,
        _tbatch(batch))


#: gradient tolerance a leaf, x max(1, max |g|).  zamba2's SSM gradients:
#: on this input the reference's own float32 gradients lie up to 1.01e-4 x
#: max |g| from a float64 evaluation of the same function (conv_x; the
#: port's float32 ones 1.6e-5), and the two packages differ by up to 1.07e-4
#: x max |g| there, so the port is held at 2e-4 and, below, to its own
#: float64 gradients at 1e-4.
GRAD_TOL = {ZAMBA: 2e-4, PHI: 1e-4}


@pytest.mark.parametrize("ce_chunk", [8, 512], ids=["chunked", "one_chunk"])
@pytest.mark.parametrize("arch", [ZAMBA, PHI])
def test_loss_fn_and_grads_match_reference(arch, ce_chunk):
    cfg = get_smoke_config(arch)
    want_loss, want = _jloss(arch, ce_chunk)
    loss, grads = _port_loss(cfg, _port_params(arch), _setup(arch)[2],
                             ce_chunk)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = _stacked(cfg, grads)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], GRAD_TOL[arch])


@pytest.mark.parametrize("arch", [ZAMBA, PHI])
def test_loss_fn_float32_rounding(arch):
    """The port's float32 loss and gradients against its own float64 ones:
    the rounding the float32 path adds (1e-5 and 1e-4 x max(1, max |g|))."""
    cfg = get_smoke_config(arch)
    params, batch = _port_params(arch), _tbatch(_setup(arch)[2])
    out = {}
    for dtype in (torch.float32, torch.float64):
        p = models.cast_params(params, dtype)
        out[dtype] = steps._value_and_grad(
            lambda p_, b: models.loss_fn(p_, cfg, b, dtype=dtype, ce_chunk=8),
            p, batch)
    np.testing.assert_allclose(float(out[torch.float32][0]),
                               float(out[torch.float64][0]), rtol=1e-5)
    got, want = (_stacked(cfg, out[d][1]) for d in out)
    for key in want:
        _close(got[key], want[key], 1e-4)


@pytest.mark.parametrize("remat", [dict(remat="none"), dict(remat_group=1),
                                   dict(remat_group=2),
                                   dict(remat="none", remat_group=2)],
                         ids=["none", "group1", "group2", "none_group2"])
def test_remat_is_exact(remat):
    """Recomputation changes memory, not numbers: loss and gradients are
    bitwise those of ``remat="full"`` (port of ``test_sqrt_remat_is_exact``,
    on the dense family)."""
    base = get_smoke_config(PHI)
    assert base.remat == "full" and base.remat_group == 0
    params, batch = _port_params(PHI), _setup(PHI)[2]
    loss0, g0 = _port_loss(base, params, batch, ce_chunk=8)
    loss1, g1 = _port_loss(dataclasses.replace(base, **remat), params, batch,
                           ce_chunk=8)
    assert torch.equal(loss0, loss1)
    a, b = _stacked(base, g0), _stacked(base, g1)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
