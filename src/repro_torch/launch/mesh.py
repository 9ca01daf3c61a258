"""Meshes of ranks for the sharded fleet engine, on ``torch.distributed``.

The counterpart of the reference's ``launch/mesh.py`` ``ost_mesh`` and
``fleet_ost_mesh``.  A JAX mesh is a grid of devices seen by one program;
here it is a grid of ranks, one process and one shard each.  The caller
starts the ranks (``torchrun``, ``torch.multiprocessing.spawn``) and
initialises the default process group; every rank then calls the same
entry point with the same global inputs:

    torch.distributed.init_process_group("nccl", init_method=...,
                                         rank=rank, world_size=n)
    res = simulate_fleet(FleetConfig(partition="ost_shard"), nodes, rates,
                         volume)      # every rank: the whole FleetResult

A ``Mesh`` names its axes by ``shape`` (``{"ost": n}`` or ``{"fleet": f,
"ost": o}``, ranks row-major over them), this rank's ``coords`` on each,
and ``ost_group``, the process group of this rank's ``ost`` axis: the one
reduction of the window loop (the streaming busy-OST count) runs over it.
A layout is a tuple with one entry a dimension, an axis name where that
dimension is split over the axis and ``None`` where it is whole, as a
``PartitionSpec`` reads: ``Mesh.block`` takes this rank's block of a global
array, ``Mesh.gather`` joins every rank's blocks into the global array in
host memory on every rank (a sharded run's result may not fit on one
card; its inputs were on the host too).

Transport: the backend is the caller's: NCCL across cards, gloo on the
CPU and for several ranks sharing one card.  Both collectives, the
busy-count ``all_reduce`` and the gather's broadcasts, go to the backend
as they are, on the rank's device: gloo takes CUDA tensors and copies
them through host memory itself, so nothing is staged here.
``collectives`` counts the ``all_reduce``'s and the gathers' calls and
host seconds.

The reference's LM meshes (``make_production_mesh``, ``make_mesh``,
``data_axis_size``) are TPU-mesh code and wait for ROADMAP.md queue A,
item A.5.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.dispatch import resolve_device

#: per collective: calls and host seconds
collectives: Dict[str, Dict[str, float]] = {}

#: process groups of sub-grids, by ranks, with the default group they
#: were made under (a new default group makes them stale)
_GROUPS: Dict[tuple, tuple] = {}


def reset_collectives() -> None:
    collectives.clear()


class Mesh(NamedTuple):
    """A grid of ranks.  ``coords`` is None on a rank outside the grid;
    ``ost_group`` is None when the ``ost`` axis has one rank (nothing to
    reduce) or this rank is outside the grid."""

    shape: Dict[str, int]
    coords: Optional[Dict[str, int]]
    ost_group: Any

    @property
    def size(self) -> int:
        n = 1
        for extent in self.shape.values():
            n *= extent
        return n

    def block(self, x: torch.Tensor, spec: Sequence[Optional[str]]
              ) -> torch.Tensor:
        """This rank's block of the global ``x`` under ``spec`` (a view)."""
        for dim, axis in enumerate(spec):
            if axis is not None:
                size = x.shape[dim] // self.shape[axis]
                x = x.narrow(dim, self.coords[axis] * size, size)
        return x

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
        out = []
        for x, spec in zip(leaves, specs):
            whole = torch.empty(
                [n * self.shape[axis] if axis is not None else n
                 for n, axis in zip(x.shape, spec)], dtype=x.dtype)
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
        _count("gather", t0)
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
    process group of every fleet row, in row order."""
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


def rank_device(device=None) -> torch.device:
    """A rank's device: ``None`` means ``cuda:(rank % device_count)``, so
    ranks sharing one card all get ``cuda:0``; raises without a GPU, as
    every entry point does.  Anything else as ``resolve_device`` reads it."""
    dev = resolve_device(device)
    if device is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
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
    _count("all_reduce", t0)
    return x


def _broadcast(buf: torch.Tensor, src: int) -> None:
    """``buf`` from rank ``src`` of the default group, in place."""
    dist.broadcast(buf, src=src)


def _count(name: str, t0: float) -> None:
    """One more call of ``name``, and the host seconds since ``t0``."""
    stat = collectives.setdefault(name, {"calls": 0, "seconds": 0.0})
    stat["calls"] += 1
    stat["seconds"] += time.perf_counter() - t0
