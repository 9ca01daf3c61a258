"""Shape stand-ins and layouts for every (arch x shape) cell.

The counterpart of the reference's ``launch/specs.py``.  ``input_specs``
gives ``device="meta"`` tensors (the shape and dtype, no storage: what a
``ShapeDtypeStruct`` is to the reference); the rest give layouts on a mesh
of ranks (``launch/mesh.py``), one entry a dimension, where the reference
gives ``NamedSharding``s.  Every layout passes the reference's ``_fit``
rule: a mesh axis is dropped from a dimension it does not divide (e.g.
hubert's vocab of 504 on a 16-way axis stays whole).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import models
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import steps
from repro_torch.launch.mesh import data_axis_size
from repro_torch.models.common import ModelConfig, logical_to_mesh, map_tree
from repro_torch.optim import OptState


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _fit(mesh, layout: tuple, shape) -> tuple:
    """``layout`` padded to ``shape``'s rank, without the axes of a
    dimension they do not divide."""
    entries = tuple(layout) + (None,) * (len(shape) - len(layout))
    return tuple(entry if dim % mesh.extent(entry) == 0 else None
                 for dim, entry in zip(shape, entries))


def _layouts(specs, mesh, shapes):
    """A tree of logical axes and one of shapes as a tree of fitted
    layouts."""
    leaves = []
    map_tree(leaves.append, shapes)
    it = iter(leaves)
    return map_tree(
        lambda lg: _fit(mesh, logical_to_mesh(lg, mesh), next(it).shape),
        specs)


def batch_layout(mesh, shape) -> tuple:
    """The layout of a batch leaf of ``shape``: its leading dimension over
    the data axes, where they divide it."""
    logical = ("batch",) + (None,) * (len(shape) - 1)
    return _fit(mesh, logical_to_mesh(logical, mesh), shape)


# ------------------------------------------------------------- model inputs


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, Any]:
    """``device="meta"`` stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    batch: Dict[str, Any] = {}
    if cfg.frontend == "audio":
        batch["frames"] = _meta((b, s, cfg.frontend_dim), torch.bfloat16)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
        if cfg.frontend == "vision":
            batch["patches"] = _meta((b, 256, cfg.frontend_dim),
                                     torch.bfloat16)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), torch.int32)
    return batch


def input_shardings(cfg: ModelConfig, shape: ShapeCell, mesh
                    ) -> Dict[str, Any]:
    """Each input's layout: the batch over the data axes, ``pos`` whole."""
    return {k: () if k == "pos" else batch_layout(mesh, x.shape)
            for k, x in input_specs(cfg, shape).items()}


# ------------------------------------------------------------- train state


def train_state_shapes(cfg: ModelConfig, dtype=torch.float32):
    """The train state as ``device="meta"`` tensors."""
    p = models.param_shapes(cfg, dtype)
    return steps.TrainState(params=p, opt=OptState(
        m=map_tree(lambda x: x, p), v=map_tree(lambda x: x, p),
        step=_meta((), torch.int32)))


def train_state_shardings(cfg: ModelConfig, mesh):
    """The train state's layouts: every parameter by its logical axes
    (``models.param_specs``), its moments alike, the step whole."""
    sh = _layouts(models.param_specs(cfg), mesh, models.param_shapes(cfg))
    return steps.TrainState(params=sh, opt=OptState(m=sh, v=sh, step=()))


# ------------------------------------------------------------- decode state


def cache_cell(cfg: ModelConfig, shape: ShapeCell, mesh,
               dtype=torch.bfloat16):
    """(shapes, layouts) of the decode cache of this cell.  When the batch
    is smaller than the data axes (long_500k: batch=1), the KV sequence
    dimension is split over them instead (context parallel); with
    ``cfg.seq_shard_decode_cache`` it is split over the model axis in
    place of the fused head dimension, as in the reference."""
    b, s = shape.global_batch, shape.seq_len
    shapes = models.cache_shapes(cfg, b, s, dtype)
    specs = models.cache_specs(cfg, b, s)
    if b < data_axis_size(mesh):
        def flip(lg):
            if "kv_seq" in lg:
                return tuple("batch" if a == "kv_seq"
                             else (None if a == "batch" else a) for a in lg)
            return tuple(None if a == "batch" else a for a in lg)

        specs = map_tree(flip, specs)
    elif cfg.seq_shard_decode_cache:
        def seq_tp(lg):
            if "kv_seq" in lg:
                return tuple("tp" if a == "kv_seq"
                             else (None if a == "tp" else a) for a in lg)
            return lg

        specs = map_tree(seq_tp, specs)
    return shapes, _layouts(specs, mesh, shapes)


def param_cell(cfg: ModelConfig, mesh, dtype=torch.bfloat16):
    """(shapes, layouts) of serving parameters (bf16)."""
    shapes = models.param_shapes(cfg, dtype)
    return shapes, _layouts(models.param_specs(cfg), mesh, shapes)
