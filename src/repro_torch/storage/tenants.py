"""Tenant axis: F independent fleets in one run of the window engine.

A storage provider runs many independent AdapTBF control loops, one per
tenant fleet, and a policy sweep (16 seeds x 5 policies) or a population of
thousands of small tenants is the same program over many fleets.
``simulate_tenants`` takes every argument of ``simulate_fleet`` either
*shared* (its usual rank, one copy read by every fleet) or *batched* (a
leading ``[F]`` fleet axis), by rank, as the reference's does:

* ``issue_rate`` is ``[T, O, J]`` or ``[F, T, O, J]``; ``nodes`` ``[J]`` /
  ``[O, J]`` or ``[F, O, J]``; ``volume`` and ``max_backlog`` ``[O, J]`` or
  ``[F, O, J]``; ``capacity_per_tick`` ``[O]`` or ``[F, O]``;
  ``control_code`` a scalar or ``[F]`` (a policy sweep is one run); the
  ``FaultPlan`` leaves uniformly ``[W, O]`` or uniformly ``[F, W, O]``.

No loop over fleets runs on the host.  The fleets go through the engine's
one window loop (``simulator._run_windows`` with a ``FleetAxis``) as
``[F*O, J]`` rows, which is exact because no engine or policy op mixes
rows (the paper's decentralization).  On the card the window-service and
allocation kernels launch once a window over all ``F*O`` rows, and the
window megakernel once a window for each distinct control code present,
over that code's rows.  A shared rate trace stays one ``[T, O, J]`` tensor:
the kernels read it through a fleet stride of 0.  The streaming fold keeps
one window counter and one busy flag per fleet.

The result is bitwise a stack of per-fleet ``simulate_fleet`` runs, for
every policy, both telemetry modes and fault plans (``tests/
test_torch_tenants.py``; on the card, ``chip_smoke.py``'s tenant phase).
A ``FleetResult`` has ``[F, W, O, J]`` trajectories and ``[F, O, J]``
queues; a ``StreamResult``'s every ``StreamStats`` leaf carries the leading
``[F]`` (``windows`` and ``busy_windows`` become ``[F]`` int32), which the
``streaming_*`` finalizers of ``storage/metrics.py`` read per fleet.

``partition="fleet_shard"`` runs the batch on a 2-D ``(fleet, ost)`` grid
of ``torch.distributed`` ranks (``launch/mesh.fleet_ost_mesh(mesh_shape)``,
the reference's layout): whole fleets split over the ``fleet`` axis, with
no communication across it, and each fleet's OST rows over ``ost``, whose
group sums each fleet's streaming busy-OST count.  Every rank passes the
same global arguments, moves only its own block of each to its device, and
receives the whole result in host memory, in one gather at the end,
bitwise the unsharded batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.mesh import (
    check_covers_world,
    fleet_ost_mesh,
    rank_device,
    require_world,
)
from repro_torch.storage.faults import FaultPlan
from repro_torch.storage.simulator import (
    FleetAxis,
    FleetConfig,
    FleetResult,
    StreamResult,
    _filled,
    _resolve_policy,
    _run_on_mesh,
    _tensor,
    _WHOLE,
)

def _infer_fleets(batched_extents, n_fleets: Optional[int]) -> int:
    """The fleet-axis extent, from the batched arguments' leading axes
    (which must agree) or the explicit ``n_fleets``."""
    extents = {int(e) for e in batched_extents}
    if n_fleets is not None:
        extents.add(int(n_fleets))
    if not extents:
        raise ValueError(
            "simulate_tenants: no argument carries a leading fleet axis; "
            "batch at least one argument or pass n_fleets= explicitly")
    if len(extents) > 1:
        raise ValueError(
            "simulate_tenants: inconsistent fleet-axis extents "
            f"{sorted(extents)} across the batched arguments"
            + ("/n_fleets" if n_fleets is not None else ""))
    return extents.pop()


def _code_rows(codes, rows_per_fleet: int, device) -> tuple:
    """``FleetAxis.code_rows`` for per-fleet codes: for each distinct code,
    (code, int32 rows of its fleets), on ``device``."""
    per_row = np.repeat(np.asarray(codes), rows_per_fleet)
    return tuple(
        (int(c),
         torch.as_tensor(np.flatnonzero(per_row == c).astype(np.int32),
                         device=device))
        for c in np.unique(per_row))


def simulate_tenants(
    cfg: FleetConfig,
    nodes,
    issue_rate,
    volume,
    capacity_per_tick=None,
    max_backlog=None,
    control_code=None,
    n_windows: Optional[int] = None,
    fault_plan: Optional[FaultPlan] = None,
    n_fleets: Optional[int] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    *,
    device=None,
):
    """Simulate ``F`` independent fleets in one run.

    Every argument of ``simulate_fleet`` is accepted either shared (its
    usual rank, one copy read by every fleet) or batched (a leading
    ``[F]`` axis):

      nodes:             [J] | [O, J] shared; [F, O, J] batched.
      issue_rate:        [T, O, J] shared; [F, T, O, J] batched.
      volume:            [O, J] shared; [F, O, J] batched.
      capacity_per_tick: None | [O] shared; [F, O] batched.
      max_backlog:       None | [O, J] shared; [F, O, J] batched.
      control_code:      None | integer scalar shared; [F] batched (each
                         fleet's member of ``cfg.coded_policies`` under
                         ``control="coded"``).
      fault_plan:        None, or [W, O] leaves shared / [F, W, O]
                         batched.

    ``n_fleets`` is required only when every argument is shared; otherwise
    it is inferred from the batched leading axes (which must agree).

    ``cfg.partition``: "none" runs the batch on one device;
    "fleet_shard" on a ``mesh_shape = (fleet ranks, ost ranks)`` grid of
    every rank of ``torch.distributed``'s default group (default: every
    rank on the fleet axis), which must divide ``F`` and ``O``; "ost_shard"
    is the single-fleet engine's layout and raises ``ValueError``, as in
    the reference.

    ``device``: None (CUDA; raises without a GPU; a rank's is
    ``cuda:(rank % device_count)``) or "cpu".

    Returns a ``FleetResult`` with [F, W, O, J] trajectories and [F, O, J]
    queues, or a ``StreamResult`` whose ``StreamStats`` leaves all carry the
    leading [F] (``windows``/``busy_windows`` [F] int32), bitwise the stack
    of the per-fleet ``simulate_fleet`` results.
    """
    issue_rate = _tensor(issue_rate)
    if issue_rate.ndim not in (3, 4):
        raise ValueError(
            "simulate_tenants: issue_rate must be [T, O, J] (shared) or "
            f"[F, T, O, J] (batched); got shape {tuple(issue_rate.shape)}")
    n_ost, n_jobs = issue_rate.shape[-2:]

    batched_extents = []

    def classify(x, shared_rank: int, name: str) -> bool:
        """Whether ``x`` carries the leading fleet axis (rank decides)."""
        if x.ndim == shared_rank:
            return False
        if x.ndim == shared_rank + 1:
            batched_extents.append(x.shape[0])
            return True
        raise ValueError(
            f"simulate_tenants: {name} must have rank {shared_rank} "
            f"(shared) or {shared_rank + 1} (leading fleet axis); got "
            f"shape {tuple(x.shape)}")

    rates_batched = classify(issue_rate, 3, "issue_rate")
    nodes = _tensor(nodes)
    if nodes.ndim == 1:
        nodes = nodes.expand(n_ost, n_jobs)
    args = {"nodes": nodes, "volume": _tensor(volume)}
    args["capacity_per_tick"] = (
        _filled((n_ost,), cfg.capacity_per_tick)
        if capacity_per_tick is None else _tensor(capacity_per_tick))
    args["max_backlog"] = (
        _filled((n_ost, n_jobs), cfg.max_backlog)
        if max_backlog is None else _tensor(max_backlog))
    batched = {name: classify(x, 1 if name == "capacity_per_tick" else 2,
                              name)
               for name, x in args.items()}

    codes = None
    if control_code is not None:
        codes = torch.as_tensor(control_code).cpu()
        if codes.is_floating_point() or codes.is_complex():
            raise ValueError("simulate_tenants: control_code must be "
                             f"integer; got {codes.dtype}")
        classify(codes, 0, "control_code")
    policy = _resolve_policy(cfg._replace(partition="none"), control_code)

    plan_batched = None
    if fault_plan is not None:
        fault_plan = FaultPlan(*map(_tensor, fault_plan))
        plan_axes = {classify(leaf, 2, f"fault_plan.{name}")
                     for name, leaf in zip(FaultPlan._fields, fault_plan)}
        if len(plan_axes) != 1:
            raise ValueError(
                "simulate_tenants: fault_plan leaves must be uniformly "
                "shared [W, O] or uniformly batched [F, W, O]")
        plan_batched = plan_axes.pop()

    n_f = _infer_fleets(batched_extents, n_fleets)

    mesh = _WHOLE
    if cfg.partition == "fleet_shard":
        require_world('partition="fleet_shard"')
        mesh = fleet_ost_mesh(mesh_shape)
        check_covers_world(mesh, 'partition="fleet_shard"')
        f_dev, o_dev = mesh.shape["fleet"], mesh.shape["ost"]
        if n_f % f_dev:
            raise ValueError(
                f'partition="fleet_shard" needs n_fleets ({n_f}) divisible '
                f"by the mesh fleet axis ({f_dev} devices)")
        if n_ost % o_dev:
            raise ValueError(
                f'partition="fleet_shard" needs n_ost ({n_ost}) divisible '
                f"by the mesh ost axis ({o_dev} devices)")
        dev = rank_device(device)
    elif cfg.partition == "none":
        dev = resolve_device(device)
    else:
        raise ValueError(
            f"simulate_tenants: unknown partition {cfg.partition!r} "
            '(use "none" or "fleet_shard"; the 1-D "ost_shard" layout is '
            'the single-fleet engine\'s -- fleet_shard with '
            "mesh_shape=(1, n_devices) shards the ost axis only)")

    for name, x in args.items():
        if x.shape[int(batched[name]):][:1] != (n_ost,):
            raise ValueError(
                f"simulate_tenants: {name} of shape {tuple(x.shape)} does not "
                f"have the rates' {n_ost} OST rows a fleet")
    if fault_plan is not None:
        for name, leaf in zip(FaultPlan._fields, fault_plan):
            if leaf.shape[-1] != n_ost:
                raise ValueError(
                    f"fault_plan.{name} must be [n_windows, n_ost={n_ost}] "
                    f"for each fleet; got {tuple(leaf.shape)}")

    # this rank's fleets and rows
    n_fl, n_ol = n_f // mesh.shape["fleet"], n_ost // mesh.shape["ost"]
    code_arg, code_rows = None, ()
    if codes is not None:
        if codes.ndim == 1:
            codes = mesh.block(codes, ("fleet",))
        values = codes.reshape(-1).tolist()
        if codes.ndim == 0 or len(set(values)) == 1:
            code_arg = values[0]      # one code for all: one host int
        else:
            code_arg = torch.as_tensor(
                np.repeat(np.asarray(values, np.int32), n_ol),
                device=dev)[:, None]
            code_rows = _code_rows(values, n_ol, dev)
    fleets = FleetAxis(n_fleets=n_fl, rows_per_fleet=n_ol,
                       code_rows=code_rows)

    queue, outs = _run_on_mesh(
        mesh, cfg, policy, dev, dict(args, issue_rate=issue_rate), code_arg,
        n_windows, fault_plan=fault_plan,
        batched=frozenset(name for name, b in (
            *batched.items(), ("issue_rate", rates_batched),
            ("fault_plan", plan_batched)) if b),
        fleets=fleets)
    window_seconds = cfg.window_ticks * cfg.tick_seconds
    if cfg.telemetry == "streaming":
        return StreamResult(stats=outs, queue_final=queue,
                            window_seconds=window_seconds)
    return FleetResult(*outs, queue_final=queue,
                       window_seconds=window_seconds)
