"""The train step on a mesh of ranks (``launch/mesh.py``): what the
reference's launcher gets by jitting ``steps.make_train_step`` with
``specs.train_state_shardings``.

Each rank holds its block of every leaf of the train state
(``shard_train_state``), gathers the parameters whole, takes the loss and
gradients on its block of the batch (split over the data axes),
all-reduces them over the data axes and divides by their size, clips by
the whole gradient's norm and runs AdamW on its blocks.  Ranks along the
``model`` axis hold their blocks of the weights but compute the same
values: the axis shards memory, not arithmetic.  On a ``1x1`` mesh every
block is the whole leaf and no collective runs: the step is
``steps.make_train_step``'s, bitwise.
"""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.launch import specs
from repro_torch.launch.mesh import all_reduce_sum, data_axis_size
from repro_torch.launch.steps import TrainState, loss_and_grads
from repro_torch.models.common import is_layout
from repro_torch.optim import adamw_init, adamw_update, global_norm
from repro_torch.pytree import leaves_with_paths, unflatten


def _per_leaf(fn, tree, layouts):
    """``fn(leaf, layout)`` over the leaves of ``tree``, with ``layouts`` a
    tree of layouts of its structure."""
    specs_ = [x for _, x in leaves_with_paths(layouts, is_leaf=is_layout)]
    return unflatten(tree, [fn(x, spec) for (_, x), spec in
                            zip(leaves_with_paths(tree), specs_)])


def _owned_block(mesh):
    """This rank's block of a leaf, a tensor of its own (so the global
    leaf can be dropped)."""
    return lambda x, spec: mesh.block(x, spec).clone(
        memory_format=torch.contiguous_format)


def shard_train_state(cfg, state: TrainState, mesh) -> TrainState:
    """This rank's blocks of the global ``state`` under
    ``specs.train_state_shardings``."""
    return _per_leaf(_owned_block(mesh), state,
                     specs.train_state_shardings(cfg, mesh))


def init_sharded_train_state(cfg, generator: torch.Generator, mesh,
                             dtype=torch.float32) -> TrainState:
    """This rank's blocks of ``steps.init_train_state(cfg, generator)``:
    the parameters drawn whole (the same on every rank from the same
    seed), cut into blocks, and zero moments of the blocks' shapes, so a
    rank never holds the whole moments."""
    blocks = _per_leaf(_owned_block(mesh),
                       models.init_params(cfg, generator, dtype),
                       specs.train_state_shardings(cfg, mesh).params)
    return TrainState(params=blocks, opt=adamw_init(blocks))


def gather_train_state(cfg, state: TrainState, mesh) -> TrainState:
    """The global train state on every rank's device, from each rank's
    blocks (every rank of the mesh calls it): what a checkpoint holds."""
    return _per_leaf(mesh.all_gather, state,
                     specs.train_state_shardings(cfg, mesh))


def sharded_value_and_grad(cfg, mesh, params, batch, *, microbatches: int = 1,
                           compute_dtype=torch.bfloat16):
    """(loss, gradients) of the global ``batch`` at the parameters whose
    blocks this rank holds (``params``, by ``train_state_shardings``): the
    parameters gathered whole, the loss and gradients taken on this rank's
    block of the batch (in ``microbatches`` splits), then summed over the
    data axes and divided by their size.  Every rank of the mesh calls it;
    each returns the whole gradient."""
    whole = _per_leaf(mesh.all_gather, params,
                      specs.train_state_shardings(cfg, mesh).params)
    mine = {k: mesh.block(v, specs.batch_layout(mesh, v.shape))
            for k, v in batch.items()}
    loss, grads = loss_and_grads(cfg, whole, mine, microbatches,
                                  compute_dtype)
    del whole
    n = data_axis_size(mesh)
    if n > 1:
        axes = tuple(a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1)
        group = mesh.groups[axes if len(axes) > 1 else axes[0]]
        for x in [loss] + [g for _, g in leaves_with_paths(grads)]:
            all_reduce_sum(x, group).div_(n)
    return loss, grads


def make_sharded_train_step(cfg, mesh, *, microbatches: int = 1,
                            compute_dtype=torch.bfloat16, **hyper):
    """The train step on ``mesh``: ``state`` is this rank's blocks
    (``shard_train_state``), ``batch`` the global batch (every rank the
    same; each takes its block).  The gradient is clipped by its whole
    norm, formed from the whole all-reduced gradient before it is cut into
    blocks, and AdamW runs on the blocks in place (``hyper``:
    ``adamw_update``'s keywords).  The metrics' ``loss`` and ``grad_norm``
    are the global batch's, as the unsharded step's."""
    layouts = specs.train_state_shardings(cfg, mesh).params

    def train_step(state: TrainState, batch):
        loss, grads = sharded_value_and_grad(
            cfg, mesh, state.params, batch, microbatches=microbatches,
            compute_dtype=compute_dtype)
        new_params, opt, metrics = adamw_update(
            _per_leaf(mesh.block, grads, layouts), state.opt, state.params,
            gnorm=global_norm(grads), **hyper)
        metrics["loss"] = loss
        return TrainState(new_params, opt), metrics

    return train_step
