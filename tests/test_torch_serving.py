"""The port's ``ServingEngine`` with ``AdapTBFController`` admission on the
CPU against the reference's engine, on the same weights (the reference's
``init_params`` carried over by ``params_from_numpy``), the same requests and
the same virtual clock: the same requests finish in the same order with the
same output tokens, the controller runs the same number of windows and ends
with the same budgets and records.

The clock advances 30 ms each time a controller reads it, so admission
throttles on a tight budget (20 tokens a window against 12-token requests)
and both engines see the same window rolls.  Engines run float32, the
reference engine's default.  If an output token differs, the assertion
reports the smallest top-2 logit gap the port's run saw: a gap under the
float32 tolerance means a tie, not a fault."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_smoke_config as jconfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.storage import AdapTBFController as JController
from repro_torch import models
from repro_torch.configs import get_smoke_config
from repro_torch.serving import BOS_TOKEN, Request, ServingEngine
from repro_torch.storage import AdapTBFController

torch.set_num_threads(1)


class TickingClock:
    def __init__(self, tick=0.03):
        self.t, self.tick = 0.0, tick

    def time(self):
        self.t += self.tick
        return self.t

    def sleep(self, dt):
        self.t += dt


def _workload(vocab, n=8, max_new=8):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, 4).tolist(), max_new,
             "interactive" if i % 2 == 0 else "batch") for i in range(n)]


def _run(engine_cls, request_cls, ctl, cfg, params, work, **kw):
    eng = engine_cls(cfg, params, slots=2, max_len=32, controller=ctl,
                     classes={"interactive": 3.0, "batch": 1.0}, **kw)
    reqs = [request_cls(prompt=p, max_new_tokens=m, klass=k)
            for p, m, k in work]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    order = [reqs.index(r) for r in done]
    return order, [r.output for r in reqs], eng


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "phi3-mini-3.8b"])
def test_engine_matches_reference_engine(arch, monkeypatch):
    cfg = jconfig(arch)
    jparams = jm.init_params(cfg, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    params = models.params_from_numpy(
        get_smoke_config(arch),
        {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}, "cpu")
    work = _workload(cfg.vocab)
    kw = dict(n_targets=1, capacity_rpc_per_s=400.0, window_s=0.05)

    jclock, tclock = TickingClock(), TickingClock()
    jctl = JController(time_fn=jclock.time, sleep_fn=jclock.sleep, **kw)
    tctl = AdapTBFController(time_fn=tclock.time, sleep_fn=tclock.sleep,
                             device="cpu", **kw)

    gaps = []
    decode = models.decode_step

    def recording(*args, **kwargs):
        logits, cache = decode(*args, **kwargs)
        top2 = logits[:, -1].topk(2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        return logits, cache

    monkeypatch.setattr(models, "decode_step", recording)
    j_order, j_out, _ = _run(JEngine, JRequest, jctl, cfg, jparams, work,
                             compute_dtype=jnp.float32)
    t_order, t_out, eng = _run(ServingEngine, Request, tctl,
                               get_smoke_config(arch), params, work)
    assert len(t_order) == len(work) and all(len(o) == 8 for o in t_out)
    assert t_out == j_out, f"smallest top-2 logit gap {min(gaps)}"
    assert t_order == j_order
    assert tctl.windows_run == jctl.windows_run > 2
    for job in ("serve:interactive", "serve:batch"):
        np.testing.assert_array_equal(tctl.budget_of(job),
                                      jctl.budget_of(job))
        np.testing.assert_allclose(tctl.records_of(job), jctl.records_of(job),
                                   atol=1e-4)
    assert eng.cache["shared" if arch.startswith("zamba") else "k"][
        "k" if arch.startswith("zamba") else 0].dtype == torch.float32


def test_empty_prompt_starts_from_bos_and_bad_requests_raise():
    cfg = get_smoke_config("mamba2-1.3b")
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, slots=2, max_len=16)
    with pytest.raises(ValueError, match="at least one"):
        eng.submit(Request(prompt=[], max_new_tokens=0))
    req = Request(prompt=[], max_new_tokens=3)
    eng.submit(req)
    eng._admit()
    assert eng._next_token[0] == BOS_TOKEN
    done = eng.run_until_drained()
    assert done == [req] and len(req.output) == 3 and req.done
