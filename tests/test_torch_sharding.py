"""The port's sharded layouts on ``torch.distributed`` (gloo, on the CPU).

``FleetConfig(partition="ost_shard")`` runs the window loop one shard of
OST rows a rank (``repro_torch.launch.mesh``).  Every rank receives the
whole result, which must be bitwise the port's unsharded run:

* at 2 ranks, every registered fleet scenario x the five built-in policies
  x both telemetry modes (tolerance 0, every leaf, every rank's copy);
* at 4 ranks, a subset over the three backend pairs, a fault plan over a
  tiled horizon and coded dispatch;
* the mesh functions (``ost_mesh``, ``fleet_ost_mesh``) and the errors:
  no process group, ``n_ost`` not divisible, oversubscription;
* against the reference: the 2-rank run of a closed loop that does not
  fork (static, ``fleet_churn``) against the reference's own
  ``partition="ost_shard"`` run on its one-device mesh, under the parity
  contract: the integer allocations and records exact, service and demand
  within atol 1e-3 (row sums reduce in another order).

Each world size is one group of processes for the whole module, spawned
by a module-scoped fixture with a file rendezvous under a temporary
directory: the ranks work through a list of jobs in the background (the
sharded runs) while the tests compute the unsharded runs here.
``run_jobs`` is the ranks' program, shared with ``test_torch_tenants.py``
and the GPU test; this module imports JAX only inside the test that runs
the reference, so a rank never loads it.
"""
import hashlib
import os
import pickle
import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.mesh import fleet_ost_mesh, ost_mesh
from repro_torch.pytree import leaves_with_paths, to_numpy
from repro_torch.storage import (
    FLEET_CONTROL_CODES,
    FleetConfig,
    faults,
    get_scenario,
    list_fleet_scenarios,
    simulate_fleet,
    simulate_tenants,
)

#: the five built-in policies, named rather than read from the registry:
#: other test files register policies of their own in the same process
POLICIES = ("adaptbf", "aimd", "nobw", "static", "static_wc")
TELEMETRY = ("trajectory", "streaming")
BACKENDS = {"scan/core": ("scan", "core"), "fused/pallas": ("fused", "pallas"),
            "mega/pallas": ("mega", "pallas")}
DURATION_S = 1.0          # 10 windows of the registry's 8-OST fleets
RANKS_TIMEOUT_S = 600


# ------------------------------------------------------------ the ranks


def _mesh_view(mesh):
    """A mesh as plain ints (-1 where there is nothing)."""
    coords = mesh.coords or {}
    return {"shape": tuple(mesh.shape.items()),
            "coords": tuple(coords.items()),
            "ost_group": (-1 if mesh.ost_group is None
                          else dist.get_world_size(mesh.ost_group))}


def _run_entry(entry, cfg, args, kw, device):
    if entry == "fleet":
        return simulate_fleet(FleetConfig(**cfg), *args, **kw, device=device)
    if entry == "tenants":
        return simulate_tenants(FleetConfig(**cfg), *args, **kw,
                                device=device)
    if entry == "ost_mesh":
        return _mesh_view(ost_mesh(*args))
    if entry == "fleet_ost_mesh":
        return _mesh_view(fleet_ost_mesh(*args))
    raise KeyError(entry)


def _leaves(result):
    """A result as ``{path: numpy leaf}`` (a mesh view as it is)."""
    if isinstance(result, dict):
        return result
    return {path: to_numpy(x) for path, x in leaves_with_paths(result)
            if isinstance(x, torch.Tensor)}


def _digest(leaves) -> str:
    h = hashlib.sha256()
    for path, x in sorted(leaves.items()):
        h.update(path.encode())
        h.update(np.ascontiguousarray(x).tobytes() if isinstance(x, np.ndarray)
                 else repr(x).encode())
    return h.hexdigest()


def run_jobs(rank, world, init_file, job_file, out_file, device="cpu",
             backend="gloo"):
    """One rank: join the group, run every job of ``job_file`` (``(key,
    entry, cfg fields, args, kwargs)``), and on rank 0 write ``{key:
    ("ok", leaves, every rank's copy the same, every rank's fleet-kernel
    launches) | ("error", type, message)}`` to ``out_file``.  A
    ``ValueError`` is recorded (every rank raises it alike, before any
    collective); anything else fails the rank."""
    from repro_torch.kernels.adaptbf_alloc import ops as alloc_ops
    from repro_torch.kernels.fleet_window import ops as fw_ops
    from repro_torch.kernels.window_mega import ops as mega_ops
    kernels = {"fleet_window": fw_ops, "adaptbf_alloc": alloc_ops,
               "window_mega": mega_ops}
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        with open(job_file, "rb") as f:
            jobs = pickle.load(f)
        out = {}
        for key, entry, cfg, args, kw in jobs:
            for mod in kernels.values():
                mod.launches = 0
            try:
                leaves = _leaves(_run_entry(entry, cfg, args, kw, device))
            except ValueError as e:
                out[key] = ("error", type(e).__name__, str(e))
                continue
            every = [None] * world
            dist.all_gather_object(every, (_digest(leaves), {
                name: mod.launches for name, mod in kernels.items()}))
            out[key] = ("ok", leaves if rank == 0 else None,
                        len({d for d, _ in every}) == 1,
                        [n for _, n in every])
        if rank == 0:
            with open(out_file + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(out_file + ".tmp", out_file)
        dist.barrier()         # no rank leaves the group while one works
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` ranks working through ``jobs`` in the background."""

    def __init__(self, world, jobs, tmp, device="cpu", backend="gloo"):
        job_file, self.out_file = str(tmp / "jobs.pkl"), str(tmp / "out.pkl")
        with open(job_file, "wb") as f:
            pickle.dump(jobs, f)
        self.ctx = mp.start_processes(
            run_jobs, args=(world, str(tmp / "rendezvous"), job_file,
                            self.out_file, device, backend),
            nprocs=world, join=False, start_method="spawn")
        self._out = self._failed = None

    def results(self):
        """Every job's outcome, once every rank has exited cleanly; a
        rank's failure (or the time limit) fails every caller alike."""
        if self._failed is not None:
            raise self._failed
        if self._out is None:
            deadline = time.monotonic() + RANKS_TIMEOUT_S
            try:
                while not self.ctx.join(timeout=1):
                    if time.monotonic() > deadline:
                        raise TimeoutError("the ranks did not finish in "
                                           f"{RANKS_TIMEOUT_S} s")
            except Exception as e:
                self._failed = e
                raise
            finally:
                self.stop()
            with open(self.out_file, "rb") as f:
                self._out = pickle.load(f)
        return self._out

    def result(self, key):
        """The rank 0 leaves of job ``key``, checked ok and the same on
        every rank."""
        got = self.results()[key]
        assert got[0] == "ok", got
        assert got[2], f"{key}: the ranks' results differ"
        return got[1]

    def launches(self, key):
        """Each rank's fleet-kernel launches in job ``key``."""
        return self.results()[key][3]

    def stop(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()


def assert_bitwise(leaves, want, tag):
    """Every leaf of ``want`` (a result) byte for byte in ``leaves``."""
    want = _leaves(want)
    assert sorted(leaves) == sorted(want), tag
    for path, w in want.items():
        g = leaves[path]
        assert g.dtype == w.dtype and g.shape == w.shape, f"{tag}{path}"
        assert g.tobytes() == np.ascontiguousarray(w).tobytes(), (
            f"{tag}{path}: not bitwise")


# ------------------------------------------------------------ the jobs


def _fleet_args(name):
    scn = get_scenario(name, duration_s=DURATION_S)
    return (scn.nodes, scn.issue_rate, scn.volume, scn.capacity_per_tick,
            scn.max_backlog)


def _cfg(control="adaptbf", telemetry="trajectory", backend="scan/core",
         **kw):
    serve, alloc = BACKENDS[backend]
    return dict(control=control, telemetry=telemetry, serve_backend=serve,
                alloc_backend=alloc, **kw)


GRID = [(name, control, telemetry) for name in list_fleet_scenarios()
        for control in POLICIES for telemetry in TELEMETRY]


def _grid_jobs():
    return [(f"{name}/{control}/{telemetry}", "fleet",
             _cfg(control, telemetry, partition="ost_shard"),
             _fleet_args(name), {}) for name, control, telemetry in GRID]


#: at 4 ranks (two OST rows a rank)
SUBSET = [(name, backend, telemetry)
          for name in ("fleet_churn", "fleet_gen_mixed")
          for backend in BACKENDS for telemetry in TELEMETRY]
FAULT_WINDOWS = 25        # the 10-window trace tiled, the plan covering it
FAULTED = [(backend, telemetry) for backend in ("fused/pallas", "mega/pallas")
           for telemetry in TELEMETRY]
CODED = [(mode, backend) for mode in FLEET_CONTROL_CODES
         for backend in ("scan/core", "mega/pallas")]


def _fault_plan():
    return faults.random_fault_plan(7, FAULT_WINDOWS, 8, mtbf_windows=10.0,
                                    mttr_windows=4.0, loss_p=0.2)


def _mesh_jobs():
    return [
        ("ost_mesh()", "ost_mesh", None, (), {}),
        ("ost_mesh(2)", "ost_mesh", None, (2,), {}),
        ("ost_mesh(5)", "ost_mesh", None, (5,), {}),
        ("fleet_ost_mesh()", "fleet_ost_mesh", None, (), {}),
        ("fleet_ost_mesh((2, 2))", "fleet_ost_mesh", None, ((2, 2),), {}),
        ("fleet_ost_mesh((1, 4))", "fleet_ost_mesh", None, ((1, 4),), {}),
        ("fleet_ost_mesh((1, 2))", "fleet_ost_mesh", None, ((1, 2),), {}),
        ("fleet_ost_mesh((3, 2))", "fleet_ost_mesh", None, ((3, 2),), {}),
        ("fleet_ost_mesh((0, 1))", "fleet_ost_mesh", None, ((0, 1),), {}),
    ]


def _four_rank_jobs():
    jobs = [(f"{name}/{backend}/{telemetry}", "fleet",
             _cfg(telemetry=telemetry, backend=backend,
                  partition="ost_shard"), _fleet_args(name), {})
            for name, backend, telemetry in SUBSET]
    jobs += [(f"faulted/{backend}/{telemetry}", "fleet",
              _cfg(telemetry=telemetry, backend=backend,
                   partition="ost_shard"), _fleet_args("fleet_noisy_neighbor"),
              dict(n_windows=FAULT_WINDOWS, fault_plan=_fault_plan()))
             for backend, telemetry in FAULTED]
    jobs += [(f"coded/{mode}/{backend}", "fleet",
              _cfg("coded", "streaming", backend, partition="ost_shard"),
              _fleet_args("fleet_ost_imbalance"),
              dict(control_code=FLEET_CONTROL_CODES[mode]))
             for mode, backend in CODED]
    nodes, rates, volume, cap, backlog = _fleet_args("fleet_churn")
    jobs.append(("six OSTs", "fleet", _cfg(partition="ost_shard"),
                 (nodes, rates[:, :6], volume[:6], cap[:6], backlog[:6]),
                 {}))
    return jobs + _mesh_jobs()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    ranks = Ranks(2, _grid_jobs(), tmp_path_factory.mktemp("two_ranks"))
    yield ranks
    ranks.stop()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    ranks = Ranks(4, _four_rank_jobs(), tmp_path_factory.mktemp("four_ranks"))
    yield ranks
    ranks.stop()


# ------------------------------------------------------------ the tests


@pytest.mark.parametrize("name,control,telemetry", GRID)
def test_ost_shard_at_two_ranks_is_bitwise_unsharded(two_ranks, name,
                                                     control, telemetry):
    want = simulate_fleet(FleetConfig(**_cfg(control, telemetry)),
                          *_fleet_args(name), device="cpu")
    assert_bitwise(two_ranks.result(f"{name}/{control}/{telemetry}"), want,
                   f"{name}/{control}/{telemetry}")


@pytest.mark.parametrize("name,backend,telemetry", SUBSET)
def test_ost_shard_at_four_ranks_is_bitwise_unsharded(four_ranks, name,
                                                      backend, telemetry):
    want = simulate_fleet(
        FleetConfig(**_cfg(telemetry=telemetry, backend=backend)),
        *_fleet_args(name), device="cpu")
    assert_bitwise(four_ranks.result(f"{name}/{backend}/{telemetry}"), want,
                   f"{name}/{backend}/{telemetry}")


@pytest.mark.parametrize("backend,telemetry", FAULTED)
def test_faulted_ost_shard_is_bitwise_unsharded(four_ranks, backend,
                                                telemetry):
    """A fault plan shards by OST column: outages, droop and lost
    telemetry over a horizon that tiles the trace 2.5 times."""
    plan = _fault_plan()
    assert plan.up.min() == 0 and plan.telem_ok.min() == 0
    want = simulate_fleet(
        FleetConfig(**_cfg(telemetry=telemetry, backend=backend)),
        *_fleet_args("fleet_noisy_neighbor"), n_windows=FAULT_WINDOWS,
        fault_plan=plan, device="cpu")
    assert_bitwise(four_ranks.result(f"faulted/{backend}/{telemetry}"), want,
                   f"faulted/{backend}/{telemetry}")


@pytest.mark.parametrize("mode,backend", CODED)
def test_coded_ost_shard_is_bitwise_unsharded(four_ranks, mode, backend):
    want = simulate_fleet(FleetConfig(**_cfg("coded", "streaming", backend)),
                          *_fleet_args("fleet_ost_imbalance"),
                          control_code=FLEET_CONTROL_CODES[mode],
                          device="cpu")
    assert_bitwise(four_ranks.result(f"coded/{mode}/{backend}"), want,
                   f"coded/{mode}/{backend}")


def test_ost_shard_needs_a_process_group():
    """No silent single-device run: without ``init_process_group`` the
    sharded layouts raise, naming it."""
    assert not dist.is_initialized()
    for call in (
            lambda: simulate_fleet(FleetConfig(partition="ost_shard"),
                                   *_fleet_args("fleet_churn"), device="cpu"),
            lambda: ost_mesh(), lambda: fleet_ost_mesh((1, 1))):
        with pytest.raises(ValueError,
                           match="torch.distributed.init_process_group"):
            call()


def test_n_ost_not_divisible_by_the_mesh(four_ranks):
    got = four_ranks.results()["six OSTs"]
    assert got[:2] == ("error", "ValueError"), got
    assert got[2].startswith('partition="ost_shard" needs n_ost (6) '
                             "divisible by the mesh size (4 devices)"), got


@pytest.mark.parametrize("key,want", [
    ("ost_mesh()", {"shape": (("ost", 4),), "coords": (("ost", 0),),
                    "ost_group": 4}),
    ("ost_mesh(2)", {"shape": (("ost", 2),), "coords": (("ost", 0),),
                     "ost_group": 2}),
    ("fleet_ost_mesh()", {"shape": (("fleet", 4), ("ost", 1)),
                          "coords": (("fleet", 0), ("ost", 0)),
                          "ost_group": -1}),
    ("fleet_ost_mesh((2, 2))", {"shape": (("fleet", 2), ("ost", 2)),
                                "coords": (("fleet", 0), ("ost", 0)),
                                "ost_group": 2}),
    ("fleet_ost_mesh((1, 4))", {"shape": (("fleet", 1), ("ost", 4)),
                                "coords": (("fleet", 0), ("ost", 0)),
                                "ost_group": 4}),
    ("fleet_ost_mesh((1, 2))", {"shape": (("fleet", 1), ("ost", 2)),
                                "coords": (("fleet", 0), ("ost", 0)),
                                "ost_group": 2}),
])
def test_mesh_shapes_and_groups(four_ranks, key, want):
    """Rank 0's view of each mesh of 4 ranks (every rank's the same
    digest is not expected: coordinates differ, so only rank 0's is
    read); an ``ost`` axis of one rank has no group."""
    got = four_ranks.results()[key]
    assert got[0] == "ok", got
    assert got[1] == want


@pytest.mark.parametrize("key,match", [
    ("ost_mesh(5)", "ost_mesh: asked for 5 devices, have 4"),
    ("fleet_ost_mesh((3, 2))",
     r"fleet_ost_mesh: shape \(3, 2\) needs 6 devices, have 4"),
    ("fleet_ost_mesh((0, 1))", r"fleet_ost_mesh: axes must be >= 1, got "
                               r"\(0, 1\)"),
])
def test_meshes_reject_what_the_world_cannot_hold(four_ranks, key, match):
    got = four_ranks.results()[key]
    assert got[:2] == ("error", "ValueError"), got
    assert re.fullmatch(match, got[2]), got


def test_two_rank_run_holds_to_the_reference(two_ranks):
    """The port's 2-rank ``ost_shard`` run against the reference's
    ``partition="ost_shard"`` run (its ambient one-device mesh): the
    parity contract of the unsharded engines."""
    import jax.numpy as jnp

    from repro.storage import FleetConfig as JConfig
    from repro.storage import get_scenario as jget_scenario
    from repro.storage import simulate_fleet as jsimulate_fleet
    scn = jget_scenario("fleet_churn", duration_s=DURATION_S)
    want = jsimulate_fleet(
        JConfig(control="static", partition="ost_shard"),
        *(jnp.asarray(x) for x in (scn.nodes, scn.issue_rate, scn.volume,
                                   scn.capacity_per_tick, scn.max_backlog)))
    got = two_ranks.result("fleet_churn/static/trajectory")
    for f in ("alloc", "record"):           # integer token state: exact
        np.testing.assert_array_equal(got[f".{f}"],
                                      np.asarray(getattr(want, f)))
    for f in ("served", "demand", "queue_final"):
        g, w = got[f".{f}"], np.asarray(getattr(want, f))
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-3,
                                   err_msg=f)


@pytest.mark.parametrize("lead", [None, "fleet"])
def test_stats_pspecs_read_as_the_references(lead):
    """The carry's layout, leaf by leaf, is the reference's
    ``PartitionSpec``s as tuples."""
    from repro.storage import telemetry as jtel
    from repro_torch.storage import telemetry as tel
    want = jtel.stats_pspecs("ost", lead=lead)
    got = tel.stats_pspecs("ost", lead=lead)
    pairs = tel.stats_layout(got, want)
    assert len(pairs) == len(leaves_with_paths(tel.init_stats(1, 1)))
    for spec, ref_spec in pairs:
        assert spec == tuple(ref_spec)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 1)])
def test_mesh_blocks_rejoin_a_tenant_carry(monkeypatch, shape):
    """``Mesh.block`` under ``stats_pspecs`` cuts a batched streaming
    carry into each rank's block, and ``Mesh.gather`` (its broadcasts
    played by the blocks themselves, leaf by leaf and rank by rank) joins
    them back bitwise, in host memory."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.storage import telemetry as tel
    nodes, rates, volume, cap, backlog = _fleet_args("fleet_churn")
    stats = simulate_tenants(FleetConfig(telemetry="streaming"), nodes,
                             rates, volume, cap, backlog, n_fleets=4,
                             device="cpu").stats
    pairs = tel.stats_layout(stats, tel.stats_pspecs("ost", lead="fleet"))
    specs = [spec for _, spec in pairs]
    axes = {"fleet": shape[0], "ost": shape[1]}
    meshes = [mesh_mod.Mesh(axes, {"fleet": r // shape[1],
                                   "ost": r % shape[1]}, None)
              for r in range(shape[0] * shape[1])]
    blocks = [[m.block(x, spec) for x, spec in pairs] for m in meshes]
    sent = iter([(leaf, rank) for leaf in range(len(pairs))
                 for rank in range(len(meshes))])

    def broadcast(buf, src):
        leaf, rank = next(sent)
        assert src == rank
        buf.copy_(blocks[rank][leaf])

    monkeypatch.setattr(mesh_mod, "_broadcast", broadcast)
    joined = meshes[1].gather(blocks[1], specs)
    assert next(sent, None) is None
    for (x, spec), y in zip(pairs, joined):
        assert y.device.type == "cpu", spec
        assert y.dtype == x.dtype and torch.equal(y, x), spec


def test_one_rank_ost_shard_reduces_nothing(tmp_path):
    """A one-rank ``ost`` axis has no group: a streaming ``ost_shard`` run
    in a world of one calls no ``all_reduce`` and is bitwise unsharded."""
    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        assert ost_mesh().ost_group is None
        assert fleet_ost_mesh((1, 1)).ost_group is None
        mesh_mod.reset_collectives()
        got = simulate_fleet(FleetConfig(**_cfg(telemetry="streaming",
                                                partition="ost_shard")),
                             *_fleet_args("fleet_churn"), device="cpu")
        assert "all_reduce" not in mesh_mod.collectives
        assert mesh_mod.collectives["gather"]["calls"] == 1
    finally:
        dist.destroy_process_group()
    want = simulate_fleet(FleetConfig(**_cfg(telemetry="streaming")),
                          *_fleet_args("fleet_churn"), device="cpu")
    assert_bitwise(_leaves(got), want, "one rank")
