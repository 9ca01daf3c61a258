"""The port's LM stack (``repro_torch.models``, ``repro_torch.launch.steps``)
on the CPU against the reference package, on the reference's own weights
(``repro.models.init_params`` carried over by ``params_from_numpy``), for
the smoke configs of zamba2-2.7b (hybrid), mamba2-1.3b (SSM) and
phi3-mini-3.8b (dense):

* ``forward`` logits: float32 atol/rtol 1e-4.  In bfloat16 both frameworks
  round at every op, and the reference's own bfloat16 logits differ from
  its float32 logits by up to 0.4-0.7 (0.01-0.04 on average) at these
  random-weight smoke sizes, so a fixed bfloat16 tolerance cannot hold
  between the two frameworks.  The port's bfloat16 logits are held to be
  as close to the reference's float32 logits as the reference's bfloat16
  logits are: the mean error within 1.25x the reference's, the largest
  within 2x (the largest is one draw of the rounding noise);
* the prefill step (``make_prefill_step``) against the reference's;
* ``decode_step`` over 8 steps with a per-slot ``pos`` vector: logits and
  every cache leaf, float32 atol/rtol 1e-4;
* the port's own decode against its forward, teacher-forced, as
  ``tests/test_arch_smoke.py`` checks the reference.

The MoE models and the audio and vision frontends:
``tests/test_torch_moe.py`` and ``tests/test_torch_frontends.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_smoke_config as jconfig
from repro.launch import steps as jsteps
from repro_torch import models
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import steps

torch.set_num_threads(1)

ARCHES = ["zamba2-2.7b", "mamba2-1.3b", "phi3-mini-3.8b"]
BATCH, SEQ = 2, 24


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = jconfig(arch)
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    params = models.params_from_numpy(get_smoke_config(arch),
                                      _leaves(jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (BATCH, SEQ))
    return cfg, jparams, params, tokens


@functools.lru_cache(maxsize=None)
def _jforward(arch, dtype):
    cfg, jparams, _, tokens = _setup(arch)
    fn = jax.jit(lambda p, t: jm.forward(p, cfg, {"tokens": t},
                                         dtype=jnp.dtype(dtype)))
    return np.asarray(fn(jparams, jnp.asarray(tokens)), np.float32)


def test_config_registry_is_the_references():
    from repro.configs import ARCHS as JARCHS
    from repro.configs import get_config as jget
    assert ARCHS == JARCHS
    for arch in ARCHS:
        for ours, theirs in ((get_config(arch), jget(arch)),
                             (get_smoke_config(arch), jconfig(arch))):
            import dataclasses
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
            assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("arch", ARCHES)
def test_params_from_numpy_consumes_every_leaf_once(arch):
    cfg, jparams, params, _ = _setup(arch)
    leaves = _leaves(jparams)
    n_port = 0

    def count(tree):
        nonlocal n_port
        if isinstance(tree, dict):
            for v in tree.values():
                count(v)
        elif isinstance(tree, list):
            for v in tree:
                count(v)
        else:
            n_port += tree.numel()
    count(params)
    assert n_port == sum(v.size for v in leaves.values())
    stacked = leaves["['layers']['ln']['scale']"
                     if "['layers']['ln']['scale']" in leaves
                     else "['layers']['ln1']['scale']"]
    key = "ln" if "ln" in params["layers"][0] else "ln1"
    for i, block in enumerate(params["layers"]):
        np.testing.assert_array_equal(block[key]["scale"].numpy(),
                                      stacked[i])
    tcfg = get_smoke_config(arch)
    some = next(iter(leaves))
    with pytest.raises(ValueError, match="missing"):
        models.params_from_numpy(
            tcfg, {k: v for k, v in leaves.items() if k != some}, "cpu")
    with pytest.raises(ValueError, match="unexpected"):
        models.params_from_numpy(tcfg, {**leaves, "['extra']": 0}, "cpu")
    with pytest.raises(ValueError, match="shape"):
        models.params_from_numpy(
            tcfg, {**leaves, some: np.zeros(leaves[some].shape + (1,),
                                            np.float32)}, "cpu")


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_matches_reference_f32(arch):
    cfg, _, params, tokens = _setup(arch)
    got = models.forward(params, get_smoke_config(arch),
                         {"tokens": torch.from_numpy(tokens)},
                         dtype=torch.float32)
    assert tuple(got.shape) == (BATCH, SEQ, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _jforward(arch, "float32"),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_bf16_is_as_close_as_the_references(arch):
    _, _, params, tokens = _setup(arch)
    got = models.forward(params, get_smoke_config(arch),
                         {"tokens": torch.from_numpy(tokens)},
                         dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want32, want16 = _jforward(arch, "float32"), _jforward(arch, "bfloat16")
    assert np.isfinite(got).all()
    ours, theirs = np.abs(got - want32), np.abs(want16 - want32)
    assert ours.mean() <= 1.25 * theirs.mean(), (ours.mean(), theirs.mean())
    assert ours.max() <= 2.0 * theirs.max(), (ours.max(), theirs.max())


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_step_matches_reference(arch):
    cfg, jparams, params, tokens = _setup(arch)
    tcfg = get_smoke_config(arch)
    got = steps.make_prefill_step(tcfg, compute_dtype=torch.float32)(
        models.cast_params(params, torch.float32),
        {"tokens": torch.from_numpy(tokens)})
    want = jax.jit(jsteps.make_prefill_step(cfg, compute_dtype=jnp.float32))(
        jparams, {"tokens": jnp.asarray(tokens)})
    assert tuple(got.shape) == (BATCH, 1, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    plain = steps.make_prefill_step(tcfg, compute_dtype=torch.float32,
                                    kernels=False)(
        params, {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(plain, got)    # on the CPU both take the plain path


def _flat_cache(cache, prefix=""):
    if isinstance(cache, dict):
        out = {}
        for k, v in cache.items():
            out.update(_flat_cache(v, f"{prefix}['{k}']"))
        return out
    return {prefix: cache}


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_steps_match_reference_with_per_slot_positions(arch):
    """Eight steps of continuous-batching decode: slot 0 starts at 0, slot 1
    at 5 (an earlier request's cache rows stay behind, as in the engine)."""
    cfg, jparams, params, tokens = _setup(arch)
    tcfg = get_smoke_config(arch)
    max_len = SEQ
    cache = models.init_cache(tcfg, BATCH, max_len, dtype=torch.float32,
                              device="cpu")
    jcache = jm.init_cache(cfg, BATCH, max_len, dtype=jnp.float32)
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


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_matches_forward_teacher_forced(arch):
    """Decoding token by token from an empty cache matches the full forward
    pass (the reference's own check, ``tests/test_arch_smoke.py``)."""
    _, _, params, tokens = _setup(arch)
    tcfg = get_smoke_config(arch)
    full = models.forward(params, tcfg, {"tokens": torch.from_numpy(tokens)},
                          dtype=torch.float32)
    cache = models.init_cache(tcfg, BATCH, SEQ, dtype=torch.float32,
                              device="cpu")
    serve = steps.make_serve_step(tcfg, compute_dtype=torch.float32)
    outs = []
    for t in range(8):
        nxt, logits, cache = serve(params, cache,
                                   torch.from_numpy(tokens[:, t: t + 1]), t)
        assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).int())
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full[:, :8], rtol=2e-2,
                               atol=2e-2)


def test_init_params_is_seeded_and_shaped():
    cfg = get_smoke_config("zamba2-2.7b")
    a = models.init_params(cfg, torch.Generator().manual_seed(0))
    b = models.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(a["layers"][3]["mamba"]["in_x"],
                       b["layers"][3]["mamba"]["in_x"])
    assert not torch.equal(a["layers"][2]["mamba"]["in_x"],
                           a["layers"][3]["mamba"]["in_x"])
    ours = models.params_from_numpy(
        cfg, _leaves(jm.init_params(jconfig("zamba2-2.7b"),
                                    jax.random.PRNGKey(0))), "cpu")
    shapes = []
    models.common.map_tree(lambda x: shapes.append(tuple(x.shape)), a)
    want = []
    models.common.map_tree(lambda x: want.append(tuple(x.shape)), ours)
    assert shapes == want
    a_log = torch.stack([blk["mamba"]["a_log"] for blk in a["layers"]])
    assert bool(((a_log >= 0) & (a_log < np.log(16.0) + 1e-6)).all())
