"""``init_params`` draws every leaf at the reference's scale.

The reference stacks a block's ``ParamDef``s on a leading ``[n_layers]``
axis and its ``materialize`` takes ``shape[0]`` as the fan-in of any leaf of
rank > 1, so a stacked ``"normal"`` leaf without an explicit scale is drawn
at ``n_layers ** -0.5``; the port keeps the blocks as a list and sets that
scale on each block leaf (``models.model._stacked_scale``).  Compared leaf by
leaf on the definitions of all ten configs at full size, and by the sampled
std of drawn weights at smoke size."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import get_smoke_config as jsmoke
from repro.models import model as jmodel
from repro.models.common import ParamDef as JParamDef
from repro_torch import models
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models.common import ParamDef


def _scale(d, shape):
    """(init, the std a leaf is drawn at before truncation) of a def."""
    if d.init != "normal":
        return d.init, None
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    return d.init, d.scale if d.scale is not None else fan_in ** -0.5


def _ref_scales(cfg):
    leaves = jax.tree_util.tree_flatten_with_path(
        jmodel.model_defs(cfg), is_leaf=lambda x: isinstance(x, JParamDef))[0]
    return {jax.tree_util.keystr(p): _scale(d, d.shape) for p, d in leaves}


def _port_scales(cfg):
    out = {}
    for ref_path, port_path in models.model._leaf_paths(
            models.model_defs(cfg)):
        d = models.model_defs(cfg)
        for k in port_path:
            d = d[0 if k is None else k]
        out[ref_path] = _scale(d, d.shape)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_has_the_reference_init_scale(arch):
    want, got = _ref_scales(jget(arch)), _port_scales(get_config(arch))
    assert set(got) == set(want)
    for path in want:
        assert got[path][0] == want[path][0], path
        if want[path][1] is not None:
            assert got[path][1] == pytest.approx(want[path][1], rel=1e-12), \
                path


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jmodel.init_params(jsmoke(arch), jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch,leaf", [
    ("phi3-mini-3.8b", ("attn", "wq")),
    ("zamba2-2.7b", ("mamba", "in_x")),
    ("zamba2-2.7b", ("mamba", "out")),
    ("mamba2-1.3b", ("mamba", "in_z"))])
def test_drawn_block_leaf_std_matches_the_reference(arch, leaf):
    """The sampled std over all layers of a drawn block leaf is within 5%
    of the reference's drawn at the same smoke config."""
    want = np.asarray(_ref_params(arch)["layers"][leaf[0]][leaf[1]]).std()
    params = models.init_params(get_smoke_config(arch),
                                torch.Generator().manual_seed(0))
    got = torch.stack([blk[leaf[0]][leaf[1]] for blk in params["layers"]])
    assert float(got.std()) == pytest.approx(float(want), rel=0.05)


def test_unstacked_leaves_keep_their_rule():
    defs = models.model_defs(get_config("zamba2-2.7b"))
    assert defs["head"].scale is None
    assert defs["embed"].scale == 1.0
    assert defs["shared"]["attn"]["wq"].scale is None
    conv = defs["layers"][0]["mamba"]["conv_x"]
    assert conv.scale == conv.shape[0] ** -0.5
    assert isinstance(defs["layers"][0]["mamba"]["a_log"], ParamDef)
    assert defs["layers"][0]["mamba"]["a_log"].init == "ssm_a"
