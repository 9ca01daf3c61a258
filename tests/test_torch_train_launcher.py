"""The train launcher at ``1x1`` and the LM meshes, in one process with no
process group: ``launch.train.main(["--mesh", "1x1", ...])`` runs
``launch/sharded.py``'s step on a mesh of one rank, bitwise
``steps.make_train_step``'s, through a checkpoint and a resume; a mesh of
more than one rank raises without the default group.  The meshes of
several ranks are ``tests/test_torch_sharded_train.py``'s.
"""
import hashlib

import pytest
import torch
import torch.distributed as dist

BATCH, SEQ = 2, 8


def _digests(state) -> dict:
    from repro_torch.pytree import leaves_with_paths
    out = {}
    for path, x in leaves_with_paths(state):
        a = x.detach().cpu().contiguous().numpy()
        out[path] = f"{a.dtype}{a.shape}" + hashlib.sha256(
            a.tobytes()).hexdigest()
    return out


def test_launcher_at_1x1_is_bitwise_the_unsharded_step(tmp_path):
    """``--mesh 1x1`` (the default) runs the sharded step on a mesh of one
    rank, with no process group: one step, its checkpoint, and one more
    step resumed from it are bitwise two of ``steps.make_train_step``'s."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps, train
    if dist.is_initialized():
        pytest.skip("this process has a default group")
    arch = "phi3-mini-3.8b"
    cfg = get_smoke_config(arch)
    args = ["--arch", arch, "--smoke", "--device", "cpu",
            "--global-batch", str(BATCH), "--seq", str(SEQ)]
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0))
    step, pipe = steps.make_train_step(cfg), TokenPipeline(cfg.vocab, SEQ,
                                                           BATCH)
    for i in range(2):
        state, _ = step(state, {k: torch.as_tensor(v)
                                for k, v in pipe.batch(i).items()})
    ckpt = str(tmp_path / "ckpt")
    train.main(args + ["--steps", "1", "--ckpt-dir", ckpt,
                       "--ckpt-every", "1"])
    resumed = train.main(args + ["--steps", "1", "--ckpt-dir", ckpt])
    assert _digests(resumed) == _digests(state)


def test_a_mesh_of_ranks_needs_the_default_group():
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    if dist.is_initialized():
        pytest.skip("this process has a default group")
    with pytest.raises(ValueError, match="init_process_group"):
        make_mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="init_process_group"):
        make_production_mesh()
    one = make_mesh((1, 1), ("data", "model"))
    assert one.coords == {"data": 0, "model": 0} and one.size == 1
    x = torch.arange(6.0).reshape(2, 3)
    assert one.all_gather(x, ("data", "model")) is x
