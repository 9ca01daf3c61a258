"""The port's MoE block (``layers.moe_apply``) and the MoE models on the CPU
against the reference package, on the reference's own weights
(``repro.models.init_params`` carried over by ``params_from_numpy``), for
the smoke configs of moonshot-v1-16b-a3b (8 experts, top-2) and
phi3.5-moe-42b-a6.6b (4 experts, top-2, GQA 4/2):

* ``moe_apply`` alone, float32, |got - want| <= 1e-5 x max(1, max |want|):
  groups of 24 tokens (capacity 8 and 15), a skewed router that sends every
  token to the same two experts (most entries dropped: which ones, and the
  capacity rule, must be the reference's), and groups of 1, 3 and 4 tokens
  (dropless: capacity = S, the decode and short-prompt case).  Every
  fixture's router logits hold no near tie at the top-k boundary (gap >
  1e-6), so a last-ulp difference between the frameworks cannot flip an
  expert choice;
* ``forward`` logits: float32 atol/rtol 1e-4; bfloat16 held to the
  reference's own bfloat16 error (``tests/test_torch_lm.py``'s rule: mean
  within 1.25x, max within 2x);
* ``decode_step`` over 8 steps with a per-slot ``pos`` vector (a group of
  one token: capacity 1): logits and every cache leaf, float32 atol/rtol
  1e-4;
* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
  reference's, float32: loss 1e-5 relative, gradients 1e-4 x max(1,
  max |g|) a leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_smoke_config as jconfig
from repro.models import layers as jL
from repro_torch import models
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models.model import _leaf_paths

torch.set_num_threads(1)

ARCHES = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
BATCH, SEQ = 2, 24


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|), elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = jconfig(arch)
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    params = models.params_from_numpy(get_smoke_config(arch),
                                      _leaves(jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab,
                                               (BATCH, SEQ + 1))
    return cfg, jparams, params, tokens


def _moe_case(arch, s, skewed):
    """(reference block-0 MoE leaves, port leaves, x [3, s, D]) from a seed;
    the skewed router adds 0.5 and 0.4 to two experts' router columns and
    the input a mean of 1, so every token picks those two experts."""
    cfg, jparams, params, _ = _setup(arch)
    jp = jax.tree.map(lambda a: np.array(a[0]), jparams["layers"]["moe"])
    rng = np.random.default_rng(100 + s)
    x = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)
    if skewed:
        jp["router"][:, 1] += 0.5
        jp["router"][:, 2] += 0.4
        x += 1.0
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    return cfg, jp, tp, x


def _top_k_gap(x, router, k):
    """The smallest gap between the k-th and (k+1)-th router logit of any
    token (float64)."""
    logits = np.sort(x.astype(np.float64) @ router.astype(np.float64), -1)
    return float((logits[..., -k] - logits[..., -k - 1]).min())


@functools.lru_cache(maxsize=None)
def _jmoe(cfg):
    return jax.jit(lambda p, x: jL.moe_apply(p, x, cfg))


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("s,skewed", [(24, False), (24, True), (1, False),
                                      (3, False), (4, False)],
                         ids=["s24", "s24-skewed", "s1", "s3", "s4"])
def test_moe_apply_matches_reference(arch, s, skewed):
    cfg, jp, tp, x = _moe_case(arch, s, skewed)
    tcfg = get_smoke_config(arch)
    assert _top_k_gap(x, jp["router"], cfg.top_k) > 1e-6
    cap = L.moe_capacity(s, tcfg)
    assert cap == max(min(int(s * cfg.top_k / cfg.n_experts
                              * cfg.capacity_factor + 0.5), s), min(s, 4), 1)
    if s <= 4:
        assert cap == s            # dropless
    # how many entries the capacity drops (the reference's routing, numpy)
    idx = np.argsort(-(x @ jp["router"]), -1, kind="stable")[..., :cfg.top_k]
    per_expert = np.stack([np.bincount(g.ravel(), minlength=cfg.n_experts)
                           for g in idx])
    dropped = int(np.maximum(per_expert - cap, 0).sum())
    if skewed:
        assert dropped >= 3 * 2 * (s - cap)
    got = L.moe_apply(tp, torch.from_numpy(x), tcfg)
    want = np.asarray(_jmoe(cfg)(jp, jnp.asarray(x)))
    assert got.shape == want.shape
    _close(got.numpy(), want, 1e-5)
    ours, theirs = _routing(tp, x, tcfg)
    assert torch.equal(ours, theirs)


def _routing(tp, x, tcfg):
    """The port's expert choices against ``torch.topk``'s set, sorted."""
    idx, gates = L.moe_route(tp, torch.from_numpy(x), tcfg)
    logits = torch.from_numpy(x) @ tp["router"]
    ref = torch.topk(logits, tcfg.top_k, dim=-1).indices
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    return idx.sort(-1).values, ref.sort(-1).values


@pytest.mark.parametrize("arch", ARCHES)
def test_moe_apply_is_deterministic_and_gathers_only(arch):
    """Two calls are bitwise equal, and the block calls no scatter-add
    (``index_add_`` and its kin are CUDA atomics: the float order of a
    token's k contributions would change from run to run)."""
    _, _, tp, x = _moe_case(arch, 24, True)
    tcfg = get_smoke_config(arch)
    a = L.moe_apply(tp, torch.from_numpy(x), tcfg)
    b = L.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(a, b)
    names = set(L.moe_apply.__code__.co_names)
    assert not names & {"index_add", "index_add_", "scatter_add",
                        "scatter_add_", "index_put_", "put_"}, names


@functools.lru_cache(maxsize=None)
def _jforward(arch, dtype):
    cfg, jparams, _, tokens = _setup(arch)
    fn = jax.jit(lambda p, t: jm.forward(p, cfg, {"tokens": t},
                                         dtype=jnp.dtype(dtype)))
    return np.asarray(fn(jparams, jnp.asarray(tokens[:, :SEQ])), np.float32)


def _forward(arch, dtype):
    _, _, params, tokens = _setup(arch)
    return models.forward(params, get_smoke_config(arch),
                          {"tokens": torch.from_numpy(tokens[:, :SEQ])},
                          dtype=dtype)


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_matches_reference_f32(arch):
    got = _forward(arch, torch.float32)
    assert tuple(got.shape) == (BATCH, SEQ, jconfig(arch).vocab)
    np.testing.assert_allclose(got.numpy(), _jforward(arch, "float32"),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_bf16_is_as_close_as_the_references(arch):
    got = _forward(arch, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want32, want16 = _jforward(arch, "float32"), _jforward(arch, "bfloat16")
    assert np.isfinite(got).all()
    ours, theirs = np.abs(got - want32), np.abs(want16 - want32)
    assert ours.mean() <= 1.25 * theirs.mean(), (ours.mean(), theirs.mean())
    assert ours.max() <= 2.0 * theirs.max(), (ours.max(), theirs.max())


def _flat_cache(cache, prefix=""):
    if isinstance(cache, dict):
        out = {}
        for k, v in cache.items():
            out.update(_flat_cache(v, f"{prefix}['{k}']"))
        return out
    return {prefix: cache}


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_steps_match_reference_with_per_slot_positions(arch):
    """Eight steps of continuous-batching decode (slot 0 from 0, slot 1 from
    5); each step's MoE runs one-token groups, capacity 1."""
    cfg, jparams, params, tokens = _setup(arch)
    tcfg = get_smoke_config(arch)
    cache = models.init_cache(tcfg, BATCH, SEQ, dtype=torch.float32,
                              device="cpu")
    jcache = jm.init_cache(cfg, BATCH, SEQ, dtype=jnp.float32)
    jstep = jax.jit(lambda p, c, t, pos: jm.decode_step(
        p, c, cfg, t, pos, dtype=jnp.float32))
    pos = np.array([0, 5], np.int32)
    for t in range(8):
        tok = tokens[:, t: t + 1]
        logits, cache = models.decode_step(
            params, cache, tcfg, torch.from_numpy(tok), torch.from_numpy(pos),
            dtype=torch.float32)
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok),
                                jnp.asarray(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {t}")
        pos = pos + 1
    want = _leaves(jcache)
    got = _flat_cache(cache)
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want[key], atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def _stacked(cfg, tree):
    """The port's parameter tree keyed by the reference's path strings,
    per-block leaves stacked."""
    out = {}
    for key, path in _leaf_paths(models.model_defs(cfg)):
        node = tree
        if None in path:
            rows = []
            for block in tree["layers"]:
                node = block
                for k in path[2:]:
                    node = node[k]
                rows.append(node.detach().numpy())
            out[key] = np.stack(rows)
            continue
        for k in path:
            node = node[k]
        out[key] = node.detach().numpy()
    return out


@pytest.mark.parametrize("arch", ARCHES)
def test_loss_fn_and_grads_match_reference(arch):
    cfg, jparams, params, tokens = _setup(arch)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, cfg, b, dtype=jnp.float32, ce_chunk=8)))
    want_loss, want = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want = _leaves(want)
    tcfg = get_smoke_config(arch)
    loss, grads = steps._value_and_grad(
        lambda p, b: models.loss_fn(p, tcfg, b, dtype=torch.float32,
                                    ce_chunk=8), params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got = _stacked(tcfg, grads)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], 1e-4)
