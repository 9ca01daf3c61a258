"""Path flattening of the port's containers, under the reference's names.

The reference keys a checkpoint's leaves by ``jax.tree_util.keystr`` path
strings (``.queue``, ``.policy_state.record``, ``.stats.comp.served_sum``,
``['a']['b']``) in ``tree_flatten`` order.  The port's state lives in the
same kinds of containers (``NamedTuple``s, tuples, lists, dicts), so the
same rules give the same strings in the same order, and a checkpoint
written by either package restores in the other:

* a ``NamedTuple`` field is ``.name``, its fields in declaration order;
* a tuple or list item is ``[i]``; an empty one has no leaves;
* a dict entry is ``[repr(key)]``, keys in sorted order;
* ``None`` has no leaves;
* anything else is a leaf: a tensor, a numpy array or a Python scalar.
"""
from __future__ import annotations

from typing import Any, Iterable, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: str = "", is_leaf=None
                      ) -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the reference's flatten order;
    ``is_leaf(x)`` true makes ``x`` a leaf (a layout is a tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if tree is None:
        return []
    if _is_namedtuple(tree):
        out = []
        for name, child in zip(tree._fields, tree):
            out += leaves_with_paths(child, f"{prefix}.{name}", is_leaf)
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, child in enumerate(tree):
            out += leaves_with_paths(child, f"{prefix}[{i}]", is_leaf)
        return out
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaves_with_paths(tree[key], f"{prefix}[{key!r}]",
                                     is_leaf)
        return out
    return [(prefix, tree)]


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array.  A Python int (the carry's window
    counter) becomes int32, the type of the reference's counter."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure, leaf by leaf in
    flatten order; a tree of ``tree``'s structure."""
    others = [[x for _, x in leaves_with_paths(t)] for t in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others)) for i, (_, x)
                            in enumerate(leaves_with_paths(tree))])


def unflatten(like, leaves: Iterable):
    """A tree of ``like``'s structure holding ``leaves`` (in flatten order)."""
    it = iter(leaves)
    tree = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return tree


def _rebuild(like, it):
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(child, it) for child in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(child, it) for child in like)
    if isinstance(like, dict):
        return {key: _rebuild(like[key], it) for key in sorted(like)}
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the structure holds") from None
