"""The port's optimizer, token pipeline, train step and trainer on the CPU
against the reference package:

* ``adamw_update``, ``schedule`` and ``global_norm`` at 1e-6;
* ``TokenPipeline.batch`` bitwise the reference's for several steps,
  hosts and seeds, with the bytes it asks its controller for; the prefetch
  thread; the port's ``AdapTBFController`` metering the reads;
* ``stochastic_round_bf16`` unbiased (port of
  ``test_grad_compression_unbiased``);
* the elastic restore onto named devices (port of
  ``test_elastic_restore_with_shardings``, onto the CPU);
* one ``make_train_step`` step, and one of two microbatches, against the
  reference's at 1e-5 (phi3-mini-3.8b's smoke config, float32);
* the trainer: loss decreases, crash/restore is bitwise, gradient
  compression still learns (ports of ``tests/test_integration.py``), and a
  reference ``Trainer`` checkpoint continues in the port to within 1e-5 of
  the reference's own run."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jconfig
from repro.data import TokenPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro_torch import models
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import steps
from repro_torch.models.common import map_tree
from repro_torch.optim import adamw
from repro_torch.storage import AdapTBFController
from repro_torch.training import Trainer, compress_grads, stochastic_round_bf16
from test_torch_train import (PHI, _close, _jleaves, _np, _port_params,
                              _setup, _stacked, _tbatch)

torch.set_num_threads(1)


# ---------------------------------------------------------------- AdamW


def _tree(rng, scale=1.0):
    """A parameter-shaped tree: dicts and a list of per-block dicts."""
    f = np.float32
    return {"embed": (rng.standard_normal((6, 4)) * scale).astype(f),
            "layers": [{"w": (rng.standard_normal((4, 3)) * scale).astype(f),
                        "b": (rng.standard_normal(3) * scale).astype(f)}
                       for _ in range(2)]}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return map_tree(torch.tensor, tree)


def _same(got, want, tol):
    for a, b in zip(jax.tree.leaves(jax.tree.map(_np, got)),
                    jax.tree.leaves(want)):
        _close(a, np.asarray(b), tol)


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(0))
    np.testing.assert_allclose(float(adamw.global_norm(_ttree(tree))),
                               float(jadamw.global_norm(_jtree(tree))),
                               rtol=1e-6)


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 100, 10000),
                                             (1e-2, 5, 30), (1e-3, 0, 10)])
def test_schedule_matches_reference(lr, warmup, total):
    for step in (0, 1, 3, 5, 17, 100, 101, 5000, 10000, 12000):
        got = adamw.schedule(torch.tensor(step, dtype=torch.int32), lr,
                             warmup, total)
        want = jadamw.schedule(jnp.asarray(step, jnp.int32), lr, warmup,
                               total)
        assert got.dtype == torch.float32
        _close(got, np.asarray(want), 1e-6)


@pytest.mark.parametrize("hyper", [
    {}, dict(clip_norm=0.05), dict(lr=1e-2, warmup=3, weight_decay=0.0,
                                   b2=0.999)],
    ids=["defaults", "clipped", "no_decay"])
def test_adamw_update_matches_reference(hyper):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng, 0.1)
    m, v = _tree(rng, 0.01), map_tree(np.abs, _tree(rng, 0.001))
    jstate = jadamw.OptState(_jtree(m), _jtree(v), jnp.asarray(6, jnp.int32))
    want = jadamw.adamw_update(_jtree(grads), jstate, _jtree(params), **hyper)
    state = adamw.OptState(_ttree(m), _ttree(v),
                           torch.tensor(6, dtype=torch.int32))
    got = adamw.adamw_update(_ttree(grads), state, _ttree(params), **hyper)
    _same(got[0], want[0], 1e-6)
    _same(got[1].m, want[1].m, 1e-6)
    _same(got[1].v, want[1].v, 1e-6)
    assert int(got[1].step) == 7 and got[1].step.dtype == torch.int32
    for k in ("grad_norm", "lr"):
        _close(got[2][k], np.asarray(want[2][k]), 1e-6)


def test_adamw_init_mirrors_the_params():
    params = _ttree(_tree(np.random.default_rng(2)))
    st = adamw.adamw_init(params)
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    assert st.m["layers"][1]["w"].shape == (4, 3)
    assert not any(bool(x.any()) for x in jax.tree.leaves(
        jax.tree.map(_np, (st.m, st.v))))


# ------------------------------------------------------------- the pipeline


class _Recorder:
    def __init__(self):
        self.calls = []

    def register_job(self, job, nodes):
        self.calls.append(("register", job, nodes))

    def request(self, job, nbytes):
        self.calls.append(("request", job, int(nbytes)))


@pytest.mark.parametrize("vocab,seq,gb,hosts,host,seed", [
    (256, 32, 4, 1, 0, 0), (32000, 64, 8, 2, 1, 3), (1000, 17, 6, 3, 2, 7)])
def test_pipeline_batches_are_the_references(vocab, seq, gb, hosts, host,
                                             seed):
    ours, theirs = _Recorder(), _Recorder()
    a = TokenPipeline(vocab, seq, gb, n_hosts=hosts, host_id=host, seed=seed,
                      controller=ours)
    b = JPipeline(vocab, seq, gb, n_hosts=hosts, host_id=host, seed=seed,
                  controller=theirs)
    for step in (0, 1, 2, 9, 1000):
        x, y = a.batch(step), b.batch(step)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])
    assert ours.calls == theirs.calls and len(ours.calls) == 6


def test_pipeline_prefetch_and_controller():
    """The prefetch thread yields batch(from_step), batch(from_step + 1),
    ...; without it ``next`` walks the cursor.  Reads are metered by the
    port's ``AdapTBFController`` (a virtual clock)."""
    clock = [0.0]
    ctl = AdapTBFController(n_targets=2, capacity_rpc_per_s=1000,
                            time_fn=lambda: clock[0],
                            sleep_fn=lambda dt: clock.__setitem__(
                                0, clock[0] + dt), device="cpu")
    pipe = TokenPipeline(512, 2048, 64, controller=ctl, prefetch=2)
    pipe.start(from_step=3)
    got = [pipe.next() for _ in range(3)]
    pipe.stop()
    for i, b in enumerate(got):
        np.testing.assert_array_equal(b["tokens"], pipe.batch(3 + i)["tokens"])
    plain = TokenPipeline(512, 16, 2)
    np.testing.assert_array_equal(plain.next()["labels"],
                                  plain.batch(0)["labels"])
    np.testing.assert_array_equal(plain.next()["labels"],
                                  plain.batch(1)["labels"])
    assert float(ctl.observed_demand("data").sum()) > 0 or ctl.windows_run > 0


def test_stochastic_round_is_unbiased():
    """Port of ``test_grad_compression_unbiased``."""
    x = torch.full((200_000,), 1.00390625 / 3)   # not representable in bf16
    y = stochastic_round_bf16(x, torch.Generator().manual_seed(0))
    assert y.dtype == torch.bfloat16
    assert abs(float(y.float().mean()) - float(x[0])) < 2e-5


def test_elastic_restore_with_shardings(tmp_path):
    """Checkpoints are device-agnostic: restore with explicit devices (port
    of the reference's test, onto the CPU); a device or ``None`` in place
    of a subtree covers it; a tree of another structure raises."""
    cfg = get_smoke_config(PHI)
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "e"), {"params": params}, step=7)
    sh = map_tree(lambda _: torch.device("cpu"), params)
    for shardings in ({"params": sh}, {"params": "cpu"}, None,
                      {"params": {**sh, "layers": None}}):
        restored, step = restore_checkpoint(str(tmp_path / "e"),
                                            {"params": params},
                                            shardings=shardings)
        assert step == 7
        for a, b in zip(_stacked(cfg, params).values(),
                        _stacked(cfg, restored["params"]).values()):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path / "e"), {"params": params},
                           shardings={"params": {"embed": "cpu"}})


# ----------------------------------------------------------- the train step


@functools.lru_cache(maxsize=None)
def _jstep(arch, microbatches):
    cfg, jparams, batch = _setup(arch)
    state = jsteps.TrainState(jparams, jsteps.adamw_init(jparams))
    step = jax.jit(jsteps.make_train_step(cfg, microbatches=microbatches,
                                          compute_dtype=jnp.float32))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return _jleaves(new), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    cfg = get_smoke_config(PHI)
    want, want_metrics = _jstep(PHI, microbatches)
    params = _port_params(PHI)
    state = steps.TrainState(params, steps.adamw_init(params))
    step = steps.make_train_step(cfg, microbatches=microbatches,
                                 compute_dtype=torch.float32)
    new, metrics = step(state, _tbatch(_setup(PHI)[2]))
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5)
    got = {}
    for prefix, tree in ((".params", new.params), (".opt.m", new.opt.m),
                         (".opt.v", new.opt.v)):
        got.update({prefix + k: v for k, v in _stacked(cfg, tree).items()})
    got[".opt.step"] = _np(new.opt.step)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], 1e-5)


def test_init_train_state_and_state_from_numpy():
    cfg = get_smoke_config(PHI)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0))
    assert int(state.opt.step) == 0 and state.opt.step.dtype == torch.int32
    leaves = _jleaves(jsteps.TrainState(_setup(PHI)[1],
                                        jsteps.adamw_init(_setup(PHI)[1])))
    got = models.train_state_from_numpy(cfg, leaves, device="cpu")
    assert type(got).__name__ == "TrainState" and int(got.opt.step) == 0
    for bad in ({**leaves, ".opt.extra": np.zeros(())},
                {k: v for k, v in leaves.items() if k != ".opt.step"},
                {k: v for k, v in leaves.items()
                 if k != ".opt.m['embed']"},
                {**leaves, ".opt.v['embed']": np.zeros((3, 3), np.float32)}):
        with pytest.raises(ValueError):
            models.train_state_from_numpy(cfg, bad, device="cpu")


# ------------------------------------------------------------- the trainer

CFG = get_smoke_config(PHI)


def _trainer(path, **kw):
    base = dict(global_batch=4, seq_len=32, ckpt_every=1000, device="cpu")
    return Trainer(CFG, ckpt_dir=str(path), **{**base, **kw})


@pytest.mark.parametrize("compression", ["none", "bf16_sr"])
def test_train_loss_decreases(tmp_path, compression):
    """Ports of ``test_train_loss_decreases`` and
    ``test_grad_compression_still_learns``.  The run starts from the
    reference's initial state (its ``init_train_state(PRNGKey(0))``, saved
    by its ``save_checkpoint`` at step 0 and restored by the port's
    ``Trainer``), so the port is held to the reference's learning curve:
    the port's own ``torch.Generator(0)`` weights are other draws, whose
    30-step drop on this tiny task differs by seed."""
    from repro.checkpoint import save_checkpoint as jsave
    jsave(str(tmp_path / "c"), jsteps.init_train_state(
        jconfig(PHI), jax.random.PRNGKey(0)), 0)
    tr = _trainer(tmp_path / "c", lr=1e-2, warmup=5,
                  grad_compression=compression)
    assert tr.step == 0
    hist = tr.run(30)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)
    tr.close()


def test_checkpoint_restart_is_bitwise(tmp_path):
    """Crash/restore reproduces the uninterrupted run exactly."""
    kw = dict(lr=1e-3)
    ref = _trainer(tmp_path / "a", **kw)
    ref_hist = ref.run(10)
    ref.close()

    tr1 = _trainer(tmp_path / "b", **kw)
    tr1.run(5)
    tr1.save_now()     # synchronous save at step 5
    tr1.close()
    del tr1            # "crash"

    tr2 = _trainer(tmp_path / "b", **kw)
    assert tr2.step == 5  # restored
    hist2 = tr2.run(5)
    tr2.close()
    assert [h["loss"] for h in hist2] == [h["loss"] for h in ref_hist[5:]]
    for a, b in zip(_stacked(CFG, ref.state.params).values(),
                    _stacked(CFG, tr2.state.params).values()):
        np.testing.assert_array_equal(a, b)


def test_compress_grads_is_seeded_by_step():
    g = {"w": torch.full((1000,), 1.00390625 / 3)}
    a, b, c = (compress_grads(g, s)["w"] for s in (3, 3, 4))
    assert a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) <= {0.333984375, 0.3359375}


def test_reference_checkpoint_continues_in_the_port(tmp_path):
    """A reference ``Trainer`` checkpoint at step 3, restored by the port's
    ``Trainer`` (``train_state_from_numpy``) and run 2 more steps, lands
    within 1e-5 of the reference's own 5-step run."""
    from repro.training import Trainer as JTrainer
    kw = dict(global_batch=4, seq_len=32, ckpt_every=1000, lr=1e-3)
    jt = JTrainer(jconfig(PHI), ckpt_dir=str(tmp_path), **kw)
    jt.run(3)
    jt.save_now()
    jhist = jt.run(2)
    want = _jleaves(jt.state)
    jt.close()

    tr = Trainer(CFG, ckpt_dir=str(tmp_path), device="cpu", **kw)
    assert tr.step == 3
    hist = tr.run(2)
    tr.close()
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    got = {}
    for prefix, tree in ((".params", tr.state.params),
                         (".opt.m", tr.state.opt.m),
                         (".opt.v", tr.state.opt.v)):
        got.update({prefix + k: v for k, v in _stacked(CFG, tree).items()})
    assert int(tr.state.opt.step) == int(want.pop(".opt.step")) == 5
    for key in want:
        _close(got[key], want[key], 1e-5)
