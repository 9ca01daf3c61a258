"""The port's train step on meshes of ranks (``launch/sharded.py``,
``make_sharded_train_step``) across two gloo ranks on the CPU, against the
port's unsharded step (``tests/test_torch_train.py`` holds that one against
the reference's), for the smoke configs of zamba2-2.7b and phi3-mini-3.8b,
float32 compute:

* ``1x2`` (the model axis): bitwise the unsharded state after two steps,
  and the same metrics;
* ``2x1`` (the data axis): the loss within 1e-5 relative, the all-reduced
  gradients within 1e-4 x max(1, max |g|) a leaf, and two steps' losses
  and gradient norms as close; bitwise the unsharded step's gradients over
  the same split of the batch (two microbatches);
* a checkpoint of the ``2x1`` state restores bitwise at ``1x1`` (the
  whole state, what a mesh of one rank holds) and at ``1x2``;
* ``launch.train.main(["--mesh", "2x1", ...])`` runs on both ranks, and
  ``--mesh production`` on a world of 2 raises ``ValueError`` naming 256.

``tests/test_torch_train_launcher.py`` runs the launcher at ``1x1``, in
one process with no group; ``tests/test_torch_specs.py`` checks the
layouts and ``Mesh.block``.

The two ranks are one group of processes for the module, spawned by a
module-scoped fixture with a file rendezvous, as in
``tests/test_torch_sharding.py``: they compute the unsharded runs too, with
one thread each, so both sides run the same CPU kernels.
"""
import hashlib
import os
import pickle
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("zamba2-2.7b", "phi3-mini-3.8b")
BATCH, SEQ, STEPS = 2, 8, 2
RANKS_TIMEOUT_S = 300


def _digest(x: torch.Tensor) -> str:
    a = x.detach().cpu().contiguous().numpy()
    return f"{a.dtype}{a.shape}" + hashlib.sha256(a.tobytes()).hexdigest()


def _digests(state) -> dict:
    from repro_torch.pytree import leaves_with_paths
    return {p: _digest(x) for p, x in leaves_with_paths(state)}


def _run(cfg, state, step_fn, pipe):
    metrics = []
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v) for k, v in pipe.batch(i).items()}
        state, m = step_fn(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state, metrics


def _arch_jobs(arch, tmp):
    """Every check of one config on this rank: plain data for rank 0's
    report."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import sharded, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import save_train_state
    from repro_torch.pytree import leaves_with_paths
    from repro_torch.training.trainer import restore_train_state
    cfg = get_smoke_config(arch)
    pipe = TokenPipeline(cfg.vocab, SEQ, BATCH)
    f32 = dict(compute_dtype=torch.float32)

    def fresh():
        return steps.init_train_state(cfg, torch.Generator().manual_seed(0))

    out = {}
    # the unsharded step, and its gradients at the initial state
    batch0 = {k: torch.as_tensor(v) for k, v in pipe.batch(0).items()}
    loss0, g0 = steps.loss_and_grads(cfg, fresh().params, batch0, 1,
                                      torch.float32)
    whole, out["metrics"] = _run(cfg, fresh(),
                                 steps.make_train_step(cfg, **f32), pipe)
    want = _digests(whole)

    # 1x2: the model axis
    mesh = make_mesh((1, 2), ("data", "model"))
    state, out["metrics 1x2"] = _run(
        cfg, sharded.shard_train_state(cfg, fresh(), mesh),
        sharded.make_sharded_train_step(cfg, mesh, **f32), pipe)
    out["1x2 bitwise"] = _digests(
        sharded.gather_train_state(cfg, state, mesh)) == want

    # 2x1: the data axis, from blocks drawn as the launcher draws them
    mesh = make_mesh((2, 1), ("data", "model"))
    blocks = sharded.init_sharded_train_state(
        cfg, torch.Generator().manual_seed(0), mesh)
    out["2x1 init"] = _digests(sharded.shard_train_state(
        cfg, fresh(), mesh)) == _digests(blocks)
    loss, g = sharded.sharded_value_and_grad(cfg, mesh, blocks.params, batch0,
                                           **f32)
    out["2x1 loss rel"] = abs(float(loss) - float(loss0)) / abs(float(loss0))
    out["2x1 grad err"] = max(
        float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        for (_, a), (_, b) in zip(leaves_with_paths(g),
                                  leaves_with_paths(g0)))
    loss2, g2 = steps.loss_and_grads(cfg, fresh().params, batch0, 2,
                                      torch.float32)
    out["2x1 bitwise the split batch"] = float(loss) == float(loss2) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(leaves_with_paths(g),
                                                    leaves_with_paths(g2)))
    state, out["metrics 2x1"] = _run(
        cfg, blocks, sharded.make_sharded_train_step(cfg, mesh, **f32), pipe)

    # a 2x1 checkpoint, restored at 1x1 and at 1x2
    ckpt = os.path.join(tmp, f"ckpt-{arch}")
    save_train_state(ckpt, cfg, state, mesh, STEPS)
    saved = _digests(sharded.gather_train_state(cfg, state, mesh))
    restored, at = restore_train_state(ckpt, fresh(), cfg)
    out["restore 1x1"] = (at, _digests(restored) == saved)
    mesh = make_mesh((1, 2), ("data", "model"))
    blocks = sharded.shard_train_state(cfg, restored, mesh)
    out["restore 1x2"] = _digests(
        sharded.gather_train_state(cfg, blocks, mesh)) == saved
    return out


def run_ranks(rank, world, init_file, out_file, tmp):
    """One rank: join the group, run every check, and on rank 0 write what
    it saw (every rank's own view of the bitwise checks) to ``out_file``."""
    from repro_torch.launch import train
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = {arch: _arch_jobs(arch, tmp) for arch in ARCHS}
        ckpt = os.path.join(tmp, "launcher")
        train.main(["--arch", "zamba2-2.7b", "--mesh", "2x1", "--smoke",
                    "--device", "cpu", "--steps", "1",
                    "--global-batch", str(BATCH), "--seq", str(SEQ),
                    "--ckpt-dir", ckpt, "--ckpt-every", "1"])
        out["launcher"] = sorted(os.listdir(ckpt))
        try:
            train.main(["--arch", "zamba2-2.7b", "--mesh", "production",
                        "--smoke", "--device", "cpu"])
            out["production"] = None
        except ValueError as e:
            out["production"] = str(e)
        every = [None] * world
        dist.all_gather_object(every, out)
        if rank == 0:
            with open(out_file + ".tmp", "wb") as f:
                pickle.dump(every, f)
            os.replace(out_file + ".tmp", out_file)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    out_file = str(tmp / "out.pkl")
    ctx = mp.start_processes(
        run_ranks, args=(2, str(tmp / "rendezvous"), out_file, str(tmp)),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish in "
                                   f"{RANKS_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with open(out_file, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_is_bitwise_the_unsharded_step(ranks, arch):
    for rank in ranks:
        got = rank[arch]
        assert got["1x2 bitwise"], arch
        assert got["metrics 1x2"] == got["metrics"]


@pytest.mark.parametrize("arch", ARCHS)
def test_data_axis_meets_the_tolerances(ranks, arch):
    for rank in ranks:
        got = rank[arch]
        assert got["2x1 init"]
        assert got["2x1 loss rel"] <= 1e-5
        assert got["2x1 grad err"] <= 1e-4
        assert got["2x1 bitwise the split batch"]
        for (l2, n2), (l1, n1) in zip(got["metrics 2x1"], got["metrics"]):
            assert abs(l2 - l1) <= 1e-5 * abs(l1)
            assert abs(n2 - n1) <= 1e-4 * max(1.0, n1)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_across_meshes(ranks, arch):
    for rank in ranks:
        got = rank[arch]
        assert got["restore 1x1"] == (STEPS, True)
        assert got["restore 1x2"]


def test_launcher_runs_on_a_mesh_and_names_the_world_it_needs(ranks):
    for rank in ranks:
        assert rank["launcher"] == [f"step_{1:08d}"]
        assert "256" in rank["production"]
