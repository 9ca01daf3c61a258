"""The port's logical axes and layouts (``models.param_specs``,
``models.cache_specs``, ``launch/specs.py``) against the reference's
``PartitionSpec``s, entry for entry, for the ten full configs on five
meshes: the production mesh (16x16), the multipod mesh (2x16x16) and the
(data, model) meshes 2x1, 1x2 and 2x2.  The reference's side runs on
``jax.sharding.AbstractMesh``es (no devices); the port's on ``Mesh``es
that name the same axes.

The port keeps a model's blocks as a list of per-block dicts where the
reference stacks them on a leading ``"layers"`` axis, which it never
shards: a block leaf's layout is the reference's without that first
entry (checked to be ``None``).

``Mesh.block`` takes tuple entries row-major, as ``PartitionSpec`` reads
them.
"""
import itertools

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import models as jmodels
from repro.configs import ARCHS, get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, skip_reason
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import is_layout
from repro_torch.pytree import leaves_with_paths

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _entries(spec, n):
    """A ``PartitionSpec`` (or a port layout) as ``n`` plain entries."""
    out = tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                for e in tuple(spec))
    return out + (None,) * (n - len(out))


def _ref_leaves(tree, leaf):
    return {jtu.keystr(p): x for p, x in
            jtu.tree_flatten_with_path(tree, is_leaf=leaf)[0]}


def _port_leaves(tree):
    return dict(leaves_with_paths(tree, is_leaf=is_layout))


def _unstacked(path: str, port: dict) -> list:
    """The port's leaves that stand for the reference's stacked ``path``
    (``['layers'][...]``): one a block."""
    rest = path[len("['layers']"):]
    return [v for k, v in port.items()
            if k.startswith("['layers'][") and k.split("]", 2)[2] == rest]


def _assert_same(ref: dict, port: dict, read, n_of, lead, tag):
    """Every reference leaf's entries equal the port's (its blocks', after
    the stacked axis's entry ``lead``; ``lead=False``: nothing stacked)."""
    seen = 0
    for path, r in ref.items():
        want = _entries(read(r), n_of(r))
        if lead is not False and path.startswith("['layers']"):
            assert want[0] == lead, (tag, path)
            blocks = _unstacked(path, port)
            assert blocks, (tag, path)
            for got in blocks:
                assert _entries(got, len(want) - 1) == want[1:], (tag, path)
            seen += len(blocks)
        else:
            assert _entries(port[path], len(want)) == want, (tag, path)
            seen += 1
    assert seen == len(port), tag


@pytest.mark.parametrize("name", MESHES)
def test_layouts_equal_the_reference_partition_specs(name):
    shape, axes = MESHES[name]
    jmesh = AbstractMesh(shape, axes)
    mesh = Mesh(dict(zip(axes, shape)), None, None)
    named = lambda x: isinstance(x, jax.sharding.NamedSharding)  # noqa: E731
    spec_of = lambda s: s.spec  # noqa: E731
    for arch in ARCHS:
        jcfg, cfg = jget_config(arch), get_config(arch)
        ref, ours = (jspecs.train_state_shardings(jcfg, jmesh),
                     specs.train_state_shardings(cfg, mesh))
        for part in ("params", "m", "v"):
            r = ref.params if part == "params" else getattr(ref.opt, part)
            o = ours.params if part == "params" else getattr(ours.opt, part)
            _assert_same(_ref_leaves(r, named), _port_leaves(o), spec_of,
                         lambda s: len(s.spec), None, (name, arch, part))
        assert _entries(ref.opt.step.spec, 0) == ours.opt.step == ()
        jshapes, jsh = jspecs.param_cell(jcfg, jmesh)
        shapes, sh = specs.param_cell(cfg, mesh)
        _assert_same(_ref_leaves(jsh, named), _port_leaves(sh), spec_of,
                     lambda s: len(s.spec), None, (name, arch, "param_cell"))
        for leaf in jtu.tree_leaves(jshapes):
            assert leaf.dtype == jnp.bfloat16
        for _, leaf in leaves_with_paths(shapes):
            assert leaf.dtype == torch.bfloat16 and leaf.is_meta
        for cell in SHAPES.values():
            got = specs.input_shardings(cfg, cell, mesh)
            want = jspecs.input_shardings(jcfg, JSHAPES[cell.name], jmesh)
            assert sorted(got) == sorted(want), (name, arch, cell.name)
            for k, w in want.items():
                assert _entries(got[k], len(w.spec)) == _entries(
                    w.spec, len(w.spec)), (name, arch, cell.name, k)
            if cell.kind != "decode" or skip_reason(cfg, cell):
                continue
            jshapes, jsh = jspecs.cache_cell(jcfg, JSHAPES[cell.name], jmesh)
            shapes, sh = specs.cache_cell(cfg, cell, mesh)
            _assert_same(_ref_leaves(jsh, named), _port_leaves(sh), spec_of,
                         lambda s: len(s.spec), False,
                         (name, arch, cell.name))
            want = {k: tuple(v.shape) for k, v in
                    _ref_leaves(jshapes, None).items()}
            assert {k: tuple(v.shape) for k, v in
                    leaves_with_paths(shapes)} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_equal_the_reference(arch):
    """``param_specs`` leaf for leaf (a block's without the stacked axis)
    and ``cache_specs`` as they are; ``input_specs`` the reference's shapes
    and dtypes, on ``meta``."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    _assert_same(_ref_leaves(jmodels.param_specs(jcfg), is_layout),
                 _port_leaves(models.param_specs(cfg)), lambda lg: lg, len,
                 "layers", arch)
    cell = SHAPES["decode_32k"]
    _assert_same(_ref_leaves(jmodels.cache_specs(jcfg, cell.global_batch,
                                                 cell.seq_len), is_layout),
                 _port_leaves(models.cache_specs(cfg, cell.global_batch,
                                                 cell.seq_len)),
                 lambda lg: lg, len, False, arch)
    for cell in SHAPES.values():
        want = jspecs.input_specs(jcfg, JSHAPES[cell.name])
        got = specs.input_specs(cfg, cell)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].is_meta and tuple(got[k].shape) == w.shape
            assert str(got[k].dtype).split(".")[1] == str(w.dtype)
    state = specs.train_state_shapes(cfg)
    assert all(x.is_meta for _, x in leaves_with_paths(state))
    assert state.opt.step.dtype == torch.int32


def test_block_takes_tuple_entries_row_major():
    """A tuple entry splits its dimension over the product of its axes,
    the first the slowest, as ``PartitionSpec(("pod", "data"))`` does;
    ranks run row-major over the mesh's axes."""
    shape = {"pod": 2, "data": 2, "model": 2}
    x = torch.arange(64).reshape(8, 8)
    for p, d, m in itertools.product(range(2), repeat=3):
        mesh = Mesh(shape, {"pod": p, "data": d, "model": m}, None)
        assert mesh.rank_of(mesh.coords) == 4 * p + 2 * d + m
        r = 2 * p + d
        assert torch.equal(mesh.block(x, (("pod", "data"), "model")),
                           x[2 * r:2 * r + 2, 4 * m:4 * m + 4])
