"""The port's Mamba-2 SSD (``repro_torch.kernels.ssd``) on the CPU against the
reference package: the plain ``ssd_chunked`` against
``repro.kernels.ssd.ref.ssd_chunked`` and against the Pallas kernel run in
interpret mode (``ssd_pallas(interpret=True)``, as
``tests/test_kernel_ssd.py`` runs it); ``ssd_update`` against the reference's;
and the prefill -> decode handoff inside the port.

Inputs come from a seeded numpy generator.  Tolerances are the reference's
kernel tests': float32 atol/rtol 1e-4, bfloat16 3e-2."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import kernel as jkernel
from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import ops, ref

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_T = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, s, h, p, n, seed):
    """x, dt, a, B, C, d_skip as float32 numpy arrays (dt > 0, a < 0), the
    reference's test distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(
        np.float32)
    a = -np.exp(rng.uniform(0.0, 1.5, h)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * n ** -0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * n ** -0.5).astype(np.float32)
    d_skip = np.linspace(0.5, 1.5, h).astype(np.float32)
    return x, dt, a, B, C, d_skip


def _port(args, dtype):
    x, dt, a, B, C, d_skip = (torch.from_numpy(v) for v in args)
    cast = _T[dtype]
    return x.to(cast), dt, a, B.to(cast), C.to(cast), d_skip


def _ref(args, dtype):
    x, dt, a, B, C, d_skip = (jnp.asarray(v) for v in args)
    cast = _J[dtype]
    return x.astype(cast), dt, a, B.astype(cast), C.astype(cast), d_skip


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(want, np.float32),
        atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _jit_pallas(chunk):
    return jax.jit(functools.partial(jkernel.ssd_pallas, chunk=chunk,
                                     interpret=True))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 16, 8, 32),
    (2, 256, 4, 64, 64, 64),    # zamba2-like head dims and state
    (1, 96, 8, 16, 16, 64),     # ragged S
    (1, 130, 2, 32, 128, 64),   # mamba2-1.3b state, ragged S
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssd_matches_reference_and_its_kernel(b, s, h, p, n, chunk,
                                                    dtype):
    args = _inputs(b, s, h, p, n, seed=s + h)
    tx, tdt, ta, tB, tC, tskip = _port(args, dtype)
    y, st = ref.ssd_chunked(tx, tdt, ta, tB, tC, d_skip=tskip, chunk=chunk)
    y_op, st_op = ops.ssd(tx, tdt, ta, tB, tC, d_skip=tskip, chunk=chunk)
    assert torch.equal(y, y_op) and torch.equal(st, st_op)
    assert y.dtype == _T[dtype] and tuple(st.shape) == (b, h, p, n)
    jx, jdt, ja, jB, jC, jskip = _ref(args, dtype)
    wy, wst = jref.ssd_chunked(jx, jdt, ja, jB, jC, d_skip=jskip, chunk=chunk)
    _close(y, wy, dtype)
    _close(st, wst, dtype)
    ky, kst = _jit_pallas(chunk)(jx, jdt, ja, jB, jC, d_skip=jskip)
    _close(y, ky, dtype)
    _close(st, kst, dtype)


@pytest.mark.parametrize("b,s,h,p,n", [
    (2, 256, 4, 64, 64),    # zamba2 head dims and state
    (1, 130, 3, 32, 128),   # ragged S, mamba2-1.3b state
    (1, 1, 5, 16, 16),      # one position
    (2, 65, 2, 64, 64),     # one position into the second chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_model_matches_plain_and_reference(b, s, h, p, n, dtype):
    """``ref.ssd_scan_model`` (the CUDA kernel's order: both y products in
    one float32 sum, h carried in float32) against the plain version, the
    reference's ``ssd_chunked`` and its Pallas kernel in interpret mode,
    at the reference's kernel tolerances."""
    args = _inputs(b, s, h, p, n, seed=b * s + n)
    tx, tdt, ta, tB, tC, tskip = _port(args, dtype)
    y, st = ref.ssd_scan_model(tx, tdt, ta, tB, tC, d_skip=tskip)
    assert y.dtype == _T[dtype] and st.dtype == torch.float32
    assert tuple(st.shape) == (b, h, p, n)
    py, pst = ref.ssd_chunked(tx, tdt, ta, tB, tC, d_skip=tskip)
    _close(y, py.float(), dtype)
    _close(st, pst.float(), dtype)
    jx, jdt, ja, jB, jC, jskip = _ref(args, dtype)
    wy, wst = jref.ssd_chunked(jx, jdt, ja, jB, jC, d_skip=jskip, chunk=64)
    _close(y, wy, dtype)
    _close(st, wst, dtype)
    ky, kst = _jit_pallas(64)(jx, jdt, ja, jB, jC, d_skip=jskip)
    _close(y, ky, dtype)
    _close(st, kst, dtype)


def test_plain_ssd_takes_an_initial_state_on_the_cpu():
    args = _inputs(1, 64, 2, 16, 8, seed=3)
    h0 = np.random.default_rng(4).standard_normal((1, 2, 16, 8)).astype(
        np.float32)
    tx, tdt, ta, tB, tC, tskip = _port(args, "float32")
    y, st = ops.ssd(tx, tdt, ta, tB, tC, d_skip=tskip,
                    initial_state=torch.from_numpy(h0), chunk=16)
    jx, jdt, ja, jB, jC, jskip = _ref(args, "float32")
    wy, wst = jref.ssd_chunked(jx, jdt, ja, jB, jC, d_skip=jskip,
                               initial_state=jnp.asarray(h0), chunk=16)
    _close(y, wy, "float32")
    _close(st, wst, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_model_warm_start_matches_plain_and_reference(dtype):
    """A warm-started scan (the state rounded to x's type, as the
    reference's oracle casts it) in the CUDA kernel's order against the
    plain version and the reference's ``ssd_chunked(initial_state=...)``,
    at the reference's kernel tolerances."""
    args = _inputs(1, 130, 3, 16, 16, seed=5)
    h0 = np.random.default_rng(6).standard_normal((1, 3, 16, 16)).astype(
        np.float32)
    tx, tdt, ta, tB, tC, tskip = _port(args, dtype)
    y, st = ref.ssd_scan_model(tx, tdt, ta, tB, tC, d_skip=tskip,
                               initial_state=torch.from_numpy(h0))
    py, pst = ref.ssd_chunked(tx, tdt, ta, tB, tC, d_skip=tskip,
                              initial_state=torch.from_numpy(h0))
    _close(y, py.float(), dtype)
    _close(st, pst.float(), dtype)
    jx, jdt, ja, jB, jC, jskip = _ref(args, dtype)
    wy, wst = jref.ssd_chunked(jx, jdt, ja, jB, jC, d_skip=jskip,
                               initial_state=jnp.asarray(h0), chunk=64)
    _close(y, wy, dtype)
    _close(st, wst, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_update_matches_reference(dtype):
    rng = np.random.default_rng(11)
    b, h, p, n = 3, 4, 16, 8
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    a = -np.exp(rng.uniform(0, 1.5, h)).astype(np.float32)
    B, C = (rng.standard_normal((b, n)).astype(np.float32) for _ in range(2))
    skip = np.linspace(0.5, 1.5, h).astype(np.float32)
    cast, jcast = _T[dtype], _J[dtype]
    st, y = ops.ssd_update(
        torch.from_numpy(state).to(cast), torch.from_numpy(x).to(cast),
        torch.from_numpy(dt), torch.from_numpy(a),
        torch.from_numpy(B).to(cast), torch.from_numpy(C).to(cast),
        d_skip=torch.from_numpy(skip).to(cast))
    wst, wy = jref.ssd_update(
        jnp.asarray(state, jcast), jnp.asarray(x, jcast), jnp.asarray(dt),
        jnp.asarray(a), jnp.asarray(B, jcast), jnp.asarray(C, jcast),
        d_skip=jnp.asarray(skip, jcast))
    _close(st, wst, dtype)
    _close(y, wy, dtype)


def test_decode_continues_prefill():
    """``ssd_update`` steps after a chunked prefill equal one long chunked
    pass (the serving prefill -> decode handoff), in the port alone."""
    x, dt, a, B, C, skip = (torch.from_numpy(v) for v in
                            _inputs(1, 40, 2, 8, 4, seed=9))
    y_full, st_full = ref.ssd_chunked(x, dt, a, B, C, d_skip=skip, chunk=8)
    y_pre, st = ref.ssd_chunked(x[:, :32], dt[:, :32], a, B[:, :32],
                                C[:, :32], d_skip=skip, chunk=8)
    ys = [y_pre]
    for t in range(32, 40):
        st, y = ref.ssd_update(st, x[:, t], dt[:, t], a, B[:, t], C[:, t],
                               d_skip=skip)
        ys.append(y[:, None])
    torch.testing.assert_close(torch.cat(ys, dim=1), y_full, atol=1e-4,
                               rtol=1e-3)
    torch.testing.assert_close(st, st_full, atol=1e-4, rtol=1e-3)
