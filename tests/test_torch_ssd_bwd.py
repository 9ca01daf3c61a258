"""The SSD backward's plain version (``ref.ssd_chunked_bwd``, the chunked
reverse scan that the float32 kernel of ``csrc/ssd_scan_bwd.cu`` computes)
on the CPU: against ``jax.vjp`` of the reference package's ``ssd_chunked``
and against torch autograd of the port's ``ref.ssd_chunked``, in float32,
with and without a warm start and ``d_skip``, with gy only and gstate
only; ``ops.ssd``'s backward on CPU tensors, which takes it; and
``ref.ssd_bwd_model``, the bfloat16 kernels' rounding, held to ``jax.vjp``
in float32 by the bfloat16 reference's own distance from it.

Inputs come from a seeded numpy generator.  Tolerance: 1e-5 x max(1,
max |g|) a gradient against the JAX reference (float32 sums in another
order), 2e-6 against torch autograd in float64; da, a sum over every
position of the reverse cumsum of dcum, at 4e-5 and 2e-5: there both
float32 scans sit up to 1.5e-5 x max |g| from the float64 gradient (the
reference's own vjp 1.25e-5 in the third case)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import ops, ref

torch.set_num_threads(1)

NAMES = ("x", "dt", "a", "B", "C", "d_skip", "initial_state")
# (b, s, h, p, n, warm start, d_skip, gy, gstate)
CASES = [
    (2, 64, 3, 8, 8, False, True, True, True),
    (2, 130, 3, 16, 16, True, True, True, True),
    (1, 130, 2, 8, 16, True, False, True, False),
    (2, 64, 2, 16, 8, True, True, False, True),
    (1, 1, 3, 8, 8, True, True, True, True),
]


def _inputs(b, s, h, p, n, warm, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(
        np.float32)
    a = -np.exp(rng.uniform(0.0, 1.5, h)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * n ** -0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * n ** -0.5).astype(np.float32)
    d_skip = np.linspace(0.5, 1.5, h).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)).astype(np.float32) if warm
          else None)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gstate = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return [x, dt, a, B, C, d_skip, h0], gy, gstate


@functools.lru_cache(maxsize=None)
def _jax_vjp(warm, skip, shapes):
    """jax.vjp of the reference's ssd_chunked, jitted once a shape."""
    def run(x, dt, a, B, C, d_skip, h0, gy, gs):
        def f(x, dt, a, B, C, d_skip, h0):
            return jref.ssd_chunked(x, dt, a, B, C,
                                    d_skip=d_skip if skip else None,
                                    initial_state=h0 if warm else None)
        out, vjp = jax.vjp(f, x, dt, a, B, C, d_skip, h0)
        return vjp((gy, gs))
    return jax.jit(run)


TOL_A = {"jax": 4e-5, "float64": 2e-5}   # da; see the module docstring


def _close(got, want, tol, label):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (label, err)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp(case):
    b, s, h, p, n, warm, skip, use_gy, use_gs = case
    args, gy, gs = _inputs(b, s, h, p, n, warm, seed=sum(case[:5]))
    h0 = args[6] if warm else np.zeros((b, h, p, n), np.float32)
    jargs = [jnp.asarray(v) for v in args[:6]] + [jnp.asarray(h0)]
    jgy = jnp.asarray(gy if use_gy else np.zeros_like(gy))
    jgs = jnp.asarray(gs if use_gs else np.zeros_like(gs))
    shapes = tuple(v.shape for v in args[:6])
    want = _jax_vjp(warm, skip, shapes)(*jargs, jgy, jgs)
    t = [None if v is None else torch.from_numpy(v) for v in args]
    got = ref.ssd_chunked_bwd(
        *t[:5], d_skip=t[5] if skip else None,
        initial_state=t[6] if warm else None,
        gy=torch.from_numpy(gy) if use_gy else None,
        gstate=torch.from_numpy(gs) if use_gs else None)
    for name, g, w in zip(NAMES, got, want):
        if (name == "d_skip" and not skip) or (name == "initial_state"
                                               and not warm):
            assert g is None
            continue
        _close(g.numpy(), w, TOL_A["jax"] if name == "a" else 1e-5, name)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_torch_autograd(case):
    b, s, h, p, n, warm, skip, use_gy, use_gs = case
    args, gy, gs = _inputs(b, s, h, p, n, warm, seed=sum(case[:5]) + 1)
    keep = [i for i in range(7) if args[i] is not None
            and (i != 5 or skip)]
    leaves = [torch.from_numpy(args[i]).double().requires_grad_()
              for i in keep]
    kw = dict(zip([NAMES[i] for i in keep], leaves))
    y, st = ref.ssd_chunked(*(kw[k] for k in NAMES[:5]),
                            d_skip=kw.get("d_skip"),
                            initial_state=kw.get("initial_state"))
    outs = [(o, torch.from_numpy(g).double()) for o, g, on in
            ((y, gy, use_gy), (st, gs, use_gs)) if on]
    want = torch.autograd.grad([o for o, _ in outs], leaves,
                               [g for _, g in outs], allow_unused=True)
    t = [None if v is None else torch.from_numpy(v) for v in args]
    got = ref.ssd_chunked_bwd(
        *t[:5], d_skip=t[5] if skip else None,
        initial_state=t[6] if warm else None,
        gy=torch.from_numpy(gy) if use_gy else None,
        gstate=torch.from_numpy(gs) if use_gs else None)
    for i, w in zip(keep, want):
        g = got[i].double()
        w = torch.zeros_like(g) if w is None else w
        assert g.dtype == torch.float64 and got[i].dtype == torch.float32
        err = float((g - w).abs().max())
        tol = TOL_A["float64"] if NAMES[i] == "a" else 2e-6
        assert err <= tol * max(1.0, float(w.abs().max())), (NAMES[i], err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_on_the_cpu_takes_the_plain_reverse_scan(dtype):
    """``ops.ssd``'s backward on CPU tensors is ``ref.ssd_chunked_bwd``
    bitwise, in the inputs' dtypes, and launches nothing."""
    args, gy, gs = _inputs(1, 70, 2, 8, 8, True, seed=3)
    t = [torch.from_numpy(v) for v in args]
    t[0], t[3], t[4] = (v.to(dtype) for v in (t[0], t[3], t[4]))
    leaves = [v.clone().requires_grad_() for v in t]
    before = ops.launches_bwd
    y, st = ops.ssd(*leaves[:5], d_skip=leaves[5], initial_state=leaves[6])
    got = torch.autograd.grad(
        (y, st), leaves, (torch.from_numpy(gy).to(dtype),
                          torch.from_numpy(gs).to(st.dtype)))
    want = ref.ssd_chunked_bwd(*t[:5], d_skip=t[5], initial_state=t[6],
                               gy=torch.from_numpy(gy).to(dtype),
                               gstate=torch.from_numpy(gs).to(st.dtype))
    assert ops.launches_bwd == before
    for name, g, w, x in zip(NAMES, got, want, t):
        assert g.dtype == x.dtype, name
        assert torch.equal(g, w), name


# (b, s, h, p, n, warm start, d_skip, gy, gstate): S ragged over three
# chunks, N = 128 at P = 32, one whole chunk with gy only
MODEL_CASES = [
    (2, 150, 3, 16, 32, True, True, True, True),
    (1, 100, 2, 32, 128, True, True, True, True),
    (2, 64, 2, 64, 64, False, False, True, False),
]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_kernel_model_is_as_close_to_float32_as_the_bf16_reference(case):
    """``ref.ssd_bwd_model`` (where the bfloat16 tensor-core backward
    rounds its product operands) on bfloat16 x, B, C and gy, against
    ``jax.vjp`` of the reference's ``ssd_chunked`` in float32 on the same
    values (the warm start rounded to bfloat16, as the scan casts it): no
    farther from it than ``jax.vjp`` in bfloat16 is, every gradient (mean
    |err| within 1.25x, max within 2x) -- the rule the card holds the
    kernel to against the bfloat16 plain path."""
    b, s, h, p, n, warm, skip, use_gy, use_gs = case
    args, gy, gs = _inputs(b, s, h, p, n, warm, seed=sum(case[:5]) + 2)
    bf = jnp.bfloat16

    def r(v):   # the float32 value of v rounded to bfloat16
        return np.array(jnp.asarray(v, bf).astype(jnp.float32))

    x, B, C, gyr = r(args[0]), r(args[3]), r(args[4]), r(gy)
    h0 = args[6] if warm else np.zeros((b, h, p, n), np.float32)
    gy32 = gyr if use_gy else np.zeros_like(gyr)
    gs32 = gs if use_gs else np.zeros_like(gs)
    vjp = _jax_vjp(warm, skip, tuple(v.shape for v in args[:6]))
    want = vjp(x, args[1], args[2], B, C, args[5], r(h0), gy32, gs32)
    theirs = vjp(jnp.asarray(x, bf), args[1], args[2], jnp.asarray(B, bf),
                 jnp.asarray(C, bf), args[5], h0, jnp.asarray(gy32, bf),
                 jnp.asarray(gs32, bf))
    t16 = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, B, C, gyr)]
    ours = ref.ssd_bwd_model(
        t16[0], torch.from_numpy(args[1]), torch.from_numpy(args[2]), t16[1],
        t16[2], d_skip=torch.from_numpy(args[5]) if skip else None,
        initial_state=torch.from_numpy(h0) if warm else None,
        gy=t16[3] if use_gy else None,
        gstate=torch.from_numpy(gs) if use_gs else None)
    for name, g, w, o in zip(NAMES, ours, want, theirs):
        if (name == "d_skip" and not skip) or (name == "initial_state"
                                               and not warm):
            assert g is None
            continue
        w = np.asarray(w, np.float64)
        e_ours = np.abs(g.double().numpy() - w)
        e_theirs = np.abs(np.asarray(jnp.asarray(o, jnp.float32),
                                     np.float64) - w)
        assert e_ours.mean() <= 1.25 * e_theirs.mean() + 1e-12, \
            (name, e_ours.mean(), e_theirs.mean())
        assert e_ours.max() <= 2 * e_theirs.max() + 1e-12, \
            (name, e_ours.max(), e_theirs.max())
