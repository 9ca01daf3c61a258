"""Meshes of ranks on ``torch.distributed``: the sharded fleet engine's and
the LM train step's.

The counterpart of the reference's ``launch/mesh.py``.  A JAX mesh is a
grid of devices seen by one program; here it is a grid of ranks, one
process and one shard each.  The caller starts the ranks (``torchrun``,
``torch.multiprocessing.spawn``) and initialises the default process
group; every rank then calls the same entry point with the same global
inputs:

    torch.distributed.init_process_group("nccl", init_method=...,
                                         rank=rank, world_size=n)
    res = simulate_fleet(FleetConfig(partition="ost_shard"), nodes, rates,
                         volume)      # every rank: the whole FleetResult

A ``Mesh`` names its axes by ``shape`` (``{"ost": n}``, ``{"fleet": f,
"ost": o}``, ``{"data": d, "model": m}`` or ``{"pod": 2, "data": 16,
"model": 16}``; ranks row-major over them) and this rank's ``coords`` on
each.  ``ost_group`` is the fleet meshes' ``ost`` group: the one
reduction of the window loop (the streaming busy-OST count) runs over it.
The LM meshes (``make_mesh``, ``make_production_mesh``) carry ``groups``,
the process group of this rank's line of ranks along every axis: the
train step all-reduces gradients over the data axes and gathers each
weight over the axes its layout splits.

A layout is a tuple with one entry a dimension, as a ``PartitionSpec``
reads: an axis name where that dimension is split over the axis, a tuple
of axis names where it is split over their product (row-major: the first
the slowest), ``None`` where it is whole (``models/common.py``).
``Mesh.block`` takes this rank's block of a global array;
``Mesh.all_gather`` joins the blocks of one leaf on the ranks' devices;
``Mesh.gather`` joins every rank's blocks into the global arrays in host
memory on every rank (a sharded fleet run's result may not fit on one
card; its inputs were on the host too).

Transport: the backend is the caller's: NCCL across cards, gloo on the
CPU and for several ranks sharing one card.  Both collectives, the
``all_reduce`` and the broadcasts the gathers are made of, go to the
backend as they are, on the rank's device: gloo takes CUDA tensors and
copies them through host memory itself, so nothing is staged here.
``collectives`` counts each kind's calls, host seconds and bytes (each
rank's operand, and what a ring moves: ``launch/roofline.py``).
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.dispatch import resolve_device

#: per collective: calls, host seconds, operand bytes and ring bytes (a
#: rank's)
collectives: Dict[str, Dict[str, float]] = {}

#: process groups of sub-grids, by ranks, with the default group they
#: were made under (a new default group makes them stale)
_GROUPS: Dict[tuple, tuple] = {}


def reset_collectives() -> None:
    collectives.clear()


def _axes(entry) -> tuple:
    """The axis names of one layout entry."""
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


class Mesh(NamedTuple):
    """A grid of ranks.  ``coords`` is None on a rank outside the grid;
    ``ost_group`` (the fleet meshes') is None when the ``ost`` axis has
    one rank (nothing to reduce) or this rank is outside the grid;
    ``groups`` (the LM meshes') maps each axis to its group, None where
    the axis has one rank."""

    shape: Dict[str, int]
    coords: Optional[Dict[str, int]]
    ost_group: Any
    groups: Optional[Dict[str, Any]] = None

    @property
    def size(self) -> int:
        n = 1
        for extent in self.shape.values():
            n *= extent
        return n

    def extent(self, entry) -> int:
        """How many blocks a layout entry splits its dimension into."""
        n = 1
        for axis in _axes(entry):
            n *= self.shape[axis]
        return n

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The rank at ``coords`` (ranks run row-major over the axes)."""
        r = 0
        for axis, extent in self.shape.items():
            r = r * extent + coords[axis]
        return r

    def block(self, x: torch.Tensor, spec: Sequence[Any]) -> torch.Tensor:
        """This rank's block of the global ``x`` under ``spec`` (a view)."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                index = 0
                for axis in _axes(entry):
                    index = index * self.shape[axis] + self.coords[axis]
                size = x.shape[dim] // self.extent(entry)
                x = x.narrow(dim, index * size, size)
        return x

    def all_gather(self, x: torch.Tensor, spec: Sequence[Any]
                   ) -> torch.Tensor:
        """The global tensor whose block under ``spec`` is ``x`` on each
        rank, on ``x``'s device, on every rank of the grid: one dimension
        and one axis at a time (an entry's minor axis first), each block
        of the axis's line of ranks broadcast over ``groups[axis]`` into
        its place.  ``x`` itself when ``spec`` splits nothing."""
        for dim, entry in enumerate(spec):
            for axis in reversed(_axes(entry)):
                if self.shape[axis] > 1:
                    x = self._gather_axis(x, dim, axis)
        return x

    def _gather_axis(self, x: torch.Tensor, dim: int, axis: str
                     ) -> torch.Tensor:
        t0 = time.perf_counter()
        n, size = self.shape[axis], x.shape[dim]
        whole = torch.empty(x.shape[:dim] + (n * size,) + x.shape[dim + 1:],
                            dtype=x.dtype, device=x.device)
        for c in range(n):
            into = whole.narrow(dim, c * size, size)
            buf = into if into.is_contiguous() else torch.empty_like(
                x, memory_format=torch.contiguous_format)
            if c == self.coords[axis]:
                buf.copy_(x)
            _broadcast(buf, self.rank_of({**self.coords, axis: c}),
                       self.groups[axis])
            if buf is not into:
                into.copy_(buf)
        block = x.numel() * x.element_size()
        _count("all_gather", t0, block, block * (n - 1))
        return whole

    def gather(self, leaves: Sequence[torch.Tensor],
               specs: Sequence[Sequence[Optional[str]]]
               ) -> List[torch.Tensor]:
        """Every rank's blocks of ``leaves`` joined along the dimensions
        their ``specs`` split, in host memory, on every rank (the grid
        must cover the default group).  Leaf by leaf, each rank's block is
        broadcast from its rank and copied straight into its place, so a
        device holds no more than its own leaves and one block beside
        them: the result may be larger than a card."""
        t0 = time.perf_counter()
        out, operand, ring = [], 0, 0.0
        for x, spec in zip(leaves, specs):
            whole = torch.empty(
                [n * self.extent(entry) for n, entry in zip(x.shape, spec)],
                dtype=x.dtype)
            # ranks run row-major over the axes, as the product does
            for rank, index in enumerate(itertools.product(
                    *map(range, self.shape.values()))):
                coords = dict(zip(self.shape, index))
                buf = (x.contiguous() if coords == self.coords
                       else torch.empty(x.shape, dtype=x.dtype,
                                        device=x.device))
                _broadcast(buf, rank)
                Mesh(self.shape, coords, None).block(whole, spec).copy_(buf)
            out.append(whole)
            block = x.numel() * x.element_size()
            operand += block
            ring += block * (whole.numel() // max(x.numel(), 1) - 1)
        _count("gather", t0, operand, ring)
        return out


def require_world(who: str) -> int:
    """The default group's size; raises ``ValueError`` naming
    ``torch.distributed.init_process_group`` when there is none."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{who} runs one shard a rank and needs the default process "
            "group: call torch.distributed.init_process_group on every "
            "rank first (one rank per shard)")
    return dist.get_world_size()


def _group(ranks: tuple):
    """The process group of ``ranks``: the default group when they are the
    whole world, None for one rank; every rank must call this for every
    sub-grid, in the same order (``new_group`` is collective)."""
    if len(ranks) == 1:
        return None
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    made = _GROUPS.get(ranks)
    if made is None or made[0] is not dist.group.WORLD:
        made = (dist.group.WORLD, dist.new_group(list(ranks)))
        _GROUPS[ranks] = made
    return made[1]


def ost_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the ``ost`` axis for the sharded window engine
    (``FleetConfig(partition="ost_shard")``).

    The engine calls this bare (every rank of the default group).
    ``n_devices`` restricts the mesh to the first ranks, for callers
    building their own programs over the same axis."""
    world = require_world("ost_mesh")
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"ost_mesh: asked for {n} devices, have {world}")
    if n < 1:
        raise ValueError(f"ost_mesh: asked for {n} devices")
    rank = dist.get_rank()
    group = _group(tuple(range(n)))
    if rank >= n:
        return Mesh({"ost": n}, None, None)
    return Mesh({"ost": n}, {"ost": rank}, group)


def fleet_ost_mesh(shape: Optional[tuple] = None) -> Mesh:
    """2-D ``(fleet, ost)`` mesh for the tenant-batched window engine
    (``storage/tenants.simulate_tenants`` with ``partition="fleet_shard"``).

    Axis 0 (``fleet``) splits independent tenant control loops: no
    communication ever crosses it.  Axis 1 (``ost``) splits each fleet's
    OST rows like the 1-D ``ost_mesh`` and carries the one per-window
    busy-OST sum, which therefore stays inside each fleet row of the grid.

    ``shape`` is ``(n_fleet_ranks, n_ost_ranks)``; its product may be a
    prefix of the ranks.  The default puts every rank on the fleet axis:
    tenant counts dwarf per-fleet OST counts.  Every rank makes the
    process group of every fleet row, in row order; the ``fleet`` axis
    has none (no collective crosses it)."""
    world = require_world("fleet_ost_mesh")
    if shape is None:
        shape = (world, 1)
    n_fleet, n_ost = shape
    if n_fleet < 1 or n_ost < 1:
        raise ValueError(f"fleet_ost_mesh: axes must be >= 1, got {shape}")
    if n_fleet * n_ost > world:
        raise ValueError(
            f"fleet_ost_mesh: shape {shape} needs {n_fleet * n_ost} "
            f"devices, have {world}")
    rank, group = dist.get_rank(), None
    for f in range(n_fleet):
        row = tuple(range(f * n_ost, (f + 1) * n_ost))
        made = _group(row)
        if rank in row:
            group = made
    axes = {"fleet": n_fleet, "ost": n_ost}
    if rank >= n_fleet * n_ost:
        return Mesh(axes, None, None)
    return Mesh(axes, {"fleet": rank // n_ost, "ost": rank % n_ost}, group)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ranks of any ``shape`` over ``axes`` (e.g. ``(2, 1)``,
    ``("data", "model")``), covering the default group: a scaled-down or
    scaled-up deployment (checkpoints are the global state, so a restore
    reshards across mesh changes).  Every rank makes the process group of
    every line of ranks along every axis, axis by axis, and along the data
    axes together (``groups[("pod", "data")]``).  A mesh of one rank
    needs no process group; a larger one raises ``ValueError`` without
    one, and whenever the default group is not the mesh's size."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes) or \
            min(shape, default=0) < 1:
        raise ValueError(f"make_mesh: shape {shape} over axes {axes}")
    dims = dict(zip(axes, shape))
    n = Mesh(dims, None, None).size
    name = "x".join(map(str, shape))
    if n == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh(dims, {a: 0 for a in axes}, None,
                    {a: None for a in axes})
    world = require_world(f"a {name} mesh")
    if world != n:
        raise ValueError(
            f"a {name} mesh over {axes} needs a world of {n} ranks; the "
            f"default group has {world}")
    rank = dist.get_rank()
    coords, r = {}, rank
    for axis in reversed(axes):
        coords[axis], r = r % dims[axis], r // dims[axis]
    mesh = Mesh(dims, {a: coords[a] for a in axes}, None)
    groups = {}
    # each axis, and the data axes together (the batch's entry)
    keys = [(a,) for a in axes] + (
        [("pod", "data")] if {"pod", "data"} <= set(axes) else [])
    for key in keys:
        others = [a for a in axes if a not in key]
        for index in itertools.product(*(range(dims[a]) for a in others)):
            at = dict(zip(others, index))
            line = tuple(mesh.rank_of({**at, **dict(zip(key, c))})
                         for c in itertools.product(
                             *(range(dims[a]) for a in key)))
            made = _group(line)
            if rank in line:
                groups[key if len(key) > 1 else key[0]] = made
    return mesh._replace(groups=groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as ranks: ``(data=16, model=16)``,
    or ``(pod=2, data=16, model=16)`` with ``multi_pod``; the ``pod`` axis
    extends data parallelism.  Raises ``ValueError`` naming the world of
    256 (512) ranks it needs when the default group differs."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def data_axis_size(mesh: Mesh) -> int:
    """Ranks along the data axes (``data`` times ``pod``)."""
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def rank_device(device=None) -> torch.device:
    """A rank's device: ``None`` means ``cuda:(rank % device_count)``, so
    ranks sharing one card all get ``cuda:0`` (rank 0 without a default
    group); raises without a GPU, as every entry point does.  Anything
    else as ``resolve_device`` reads it."""
    dev = resolve_device(device)
    if device is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def check_covers_world(mesh: Mesh, who: str) -> None:
    """The engines run one shard on every rank and hand every rank the
    whole result, so their grid covers the default group."""
    world = dist.get_world_size()
    if mesh.size != world:
        raise ValueError(
            f"{who} runs one shard on every rank: the mesh "
            f"{mesh.shape} covers {mesh.size} of the {world} ranks")


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (None: one rank, ``x`` itself)."""
    if group is None:
        return x
    t0 = time.perf_counter()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    n, size = x.numel() * x.element_size(), dist.get_world_size(group)
    _count("all_reduce", t0, n, 2 * n * (size - 1) / size)
    return x


def _broadcast(buf: torch.Tensor, src: int, group=None) -> None:
    """``buf`` from rank ``src`` (of the default group) over ``group``
    (None: the default group), in place."""
    dist.broadcast(buf, src=src, group=group)


def _count(name: str, t0: float, operand: int, ring: float) -> None:
    """One more call of ``name``: the host seconds since ``t0``, this
    rank's operand bytes and the bytes a ring moves for it."""
    stat = collectives.setdefault(name, {"calls": 0, "seconds": 0.0,
                                         "bytes": 0, "ring_bytes": 0.0})
    stat["calls"] += 1
    stat["seconds"] += time.perf_counter() - t0
    stat["bytes"] += operand
    stat["ring_bytes"] += ring
