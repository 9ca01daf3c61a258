"""The port's shape helpers against the reference package, for every
architecture:

* ``models.param_shapes`` and ``models.cache_shapes`` against
  ``jax.eval_shape`` of the reference's ``init_params`` and ``init_cache``
  (nothing allocated on either side): every leaf's shape and dtype, the
  reference's stacked ``[n_layers, ...]`` leaves split into the port's
  per-block dictionaries as ``params_from_numpy`` splits them; every port
  leaf a ``device="meta"`` tensor;
* ``configs.shapes``: the same cells, and the same skip reasons for every
  architecture;
* ``params_from_numpy`` round-trips the reference's weights of the four
  MoE and frontend configs bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jget
from repro.configs import get_smoke_config as jsmoke
from repro.configs import shapes as jshapes
from repro_torch import models
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs import shapes
from repro_torch.models.model import _leaf_paths

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
NEW = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "hubert-xlarge",
       "pixtral-12b"]


def _jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): v for p, v in flat}


def _port_leaves(tree, prefix=""):
    """Path string -> leaf; a list level (the per-block dictionaries) adds
    an index to the path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{prefix}#{i}"))
        return out
    return {prefix: tree}


def _same_tree(got, want, n_layers):
    """``got``: the port's meta tree; ``want``: the reference's
    ShapeDtypeStructs, its ``['layers']`` leaves stacked."""
    got, want = _port_leaves(got), _jleaves(want)
    expect = {}
    for key, leaf in want.items():
        dtype = DTYPES[jnp.dtype(leaf.dtype).type]
        if key.startswith("['layers']"):
            for i in range(n_layers):
                rest = key[len("['layers']"):]
                expect[f"['layers']#{i}{rest}"] = (leaf.shape[1:], dtype)
        else:
            expect[key] = (leaf.shape, dtype)
    assert sorted(got) == sorted(expect)
    for key, t in got.items():
        assert t.device.type == "meta", key
        assert (tuple(t.shape), t.dtype) == expect[key], key


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_shapes_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    want = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
    _same_tree(models.param_shapes(cfg), want, cfg.n_layers)
    want16 = jax.eval_shape(lambda: jm.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    _same_tree(models.param_shapes(cfg, torch.bfloat16), want16, cfg.n_layers)
    if cfg.is_encoder:
        return
    want = jax.eval_shape(lambda: jm.init_cache(jcfg, 4, 128))
    got = models.cache_shapes(cfg, 4, 128)
    # the stacked cache keeps the reference's layout: no per-block split
    _same_tree(got, want, 0)
    want32 = jax.eval_shape(lambda: jm.init_cache(jcfg, 2, 64, jnp.float32))
    _same_tree(models.cache_shapes(cfg, 2, 64, torch.float32), want32, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_skip_reasons_are_the_references(arch):
    assert {k: tuple(v) for k, v in shapes.SHAPES.items()} == {
        k: tuple(v) for k, v in jshapes.SHAPES.items()}
    for cfg, jcfg in ((get_config(arch), jget(arch)),
                      (get_smoke_config(arch), jsmoke(arch))):
        ours, theirs = shapes.cells(cfg), jshapes.cells(jcfg)
        assert [(tuple(c), r) for c, r in ours] == [
            (tuple(c), r) for c, r in theirs]
        for cell in shapes.SHAPES.values():
            assert shapes.skip_reason(cfg, cell) == jshapes.skip_reason(
                jcfg, jshapes.ShapeCell(*cell))


@pytest.mark.parametrize("arch", NEW)
def test_params_from_numpy_round_trips(arch):
    cfg = get_smoke_config(arch)
    leaves = {k: np.asarray(v) for k, v in _jleaves(
        jm.init_params(jsmoke(arch), jax.random.PRNGKey(0))).items()}
    params = models.params_from_numpy(cfg, leaves, device="cpu")
    back = {}
    for key, path in _leaf_paths(models.model_defs(cfg)):
        if None in path:
            rows = []
            for block in params["layers"]:
                node = block
                for k in path[2:]:
                    node = node[k]
                rows.append(node.numpy())
            back[key] = np.stack(rows)
        else:
            node = params
            for k in path:
                node = node[k]
            back[key] = node.numpy()
    assert sorted(back) == sorted(leaves)
    for key in leaves:
        np.testing.assert_array_equal(back[key], leaves[key], err_msg=key)
    if cfg.block == "moe":
        assert {"['layers']['moe']['router']", "['layers']['moe']['wi']",
                "['layers']['moe']['wo']"} <= set(leaves)
        assert params["layers"][0]["moe"]["wi"].shape == (
            cfg.n_experts, cfg.d_model, 2 * cfg.d_ff)
    else:
        assert "['frontend']['proj']" in leaves
