"""The port's audio and vision frontends (``models.model._embed_inputs``) on
the CPU against the reference package, on the reference's own weights
(``repro.models.init_params`` carried over by ``params_from_numpy``), for
the smoke configs of hubert-xlarge (an encoder: audio frames replace the
token embedding, non-causal attention, ungated GELU FFN, masked-unit
cross-entropy) and pixtral-12b (8 patch embeddings overwrite the first 8
token positions; an explicit head dim, 16 with d_model / n_heads = 16 in
the smoke config, 128 against 160 in the full one):

* ``forward`` logits: float32 atol/rtol 1e-4; bfloat16 held to the
  reference's own bfloat16 error (``tests/test_torch_lm.py``'s rule: mean
  within 1.25x, max within 2x);
* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
  reference's, float32: loss 1e-5 relative, gradients 1e-4 x max(1,
  max |g|) a leaf (``frontend.proj`` among them);
* a batch without patches runs pixtral on tokens alone, as the reference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_smoke_config as jconfig
from repro_torch import models
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import steps
from repro_torch.models.model import _leaf_paths

torch.set_num_threads(1)

ARCHES = ["hubert-xlarge", "pixtral-12b"]
BATCH, SEQ, PATCHES = 2, 24, 8


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
    """(reference config, reference weights, port weights, batch as numpy:
    frames or tokens plus patches, and labels)."""
    cfg = jconfig(arch)
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    params = models.params_from_numpy(get_smoke_config(arch),
                                      _leaves(jparams), device="cpu")
    rng = np.random.default_rng(3)
    batch = {"labels": rng.integers(0, cfg.vocab, (BATCH, SEQ))}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (BATCH, SEQ, cfg.frontend_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (BATCH, SEQ))
        batch["patches"] = rng.standard_normal(
            (BATCH, PATCHES, cfg.frontend_dim)).astype(np.float32)
    return cfg, jparams, params, batch


def _inputs(batch, drop=()):
    return {k: v for k, v in batch.items() if k != "labels" and k not in drop}


@functools.lru_cache(maxsize=None)
def _jforward(arch, dtype, drop=()):
    cfg, jparams, _, batch = _setup(arch)
    fn = jax.jit(lambda p, b: jm.forward(p, cfg, b, dtype=jnp.dtype(dtype)))
    return np.asarray(fn(jparams, {k: jnp.asarray(v) for k, v in
                                   _inputs(batch, drop).items()}), np.float32)


def _forward(arch, dtype, drop=()):
    _, _, params, batch = _setup(arch)
    return models.forward(params, get_smoke_config(arch),
                          {k: torch.from_numpy(v) for k, v in
                           _inputs(batch, drop).items()}, dtype=dtype)


def test_the_configs_exercise_what_the_frontends_change():
    hubert, pixtral = (get_config(a) for a in ARCHES)
    assert not hubert.causal and hubert.frontend == "audio"
    assert hubert.hd == 80
    assert pixtral.frontend == "vision"
    assert pixtral.hd == 128 != pixtral.d_model // pixtral.n_heads
    shapes = models.param_shapes(pixtral)
    assert tuple(shapes["layers"][0]["attn"]["wq"].shape) == (5120, 32 * 128)
    assert tuple(shapes["frontend"]["proj"].shape) == (1024, 5120)


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_matches_reference_f32(arch):
    got = _forward(arch, torch.float32)
    assert tuple(got.shape) == (BATCH, SEQ, jconfig(arch).vocab)
    np.testing.assert_allclose(got.numpy(), _jforward(arch, "float32"),
                               atol=1e-4, rtol=1e-4)


def test_pixtral_without_patches_is_the_token_model():
    got = _forward("pixtral-12b", torch.float32, drop=("patches",))
    want = _jforward("pixtral-12b", "float32", drop=("patches",))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    with_patches = _forward("pixtral-12b", torch.float32)
    # the patches change the first positions, and through attention the rest
    assert not torch.allclose(got[:, :PATCHES], with_patches[:, :PATCHES])


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
    cfg, jparams, params, batch = _setup(arch)
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
    assert "['frontend']['proj']" in got
    for key in want:
        _close(got[key], want[key], 1e-4)
