"""Dispatching wrappers for the Mamba-2 SSD: CUDA tensors launch the chunked
scan kernel (``kernels/csrc/ssd_scan.cu``) or its backward
(``kernels/csrc/ssd_scan_bwd.cu``), CPU tensors take the plain versions
(``ref.py``), anything else raises.  The one-token update is plain PyTorch
on every device, as in the reference.

The bfloat16 scan runs on the tensor cores and moves x, B, C and y by TMA,
which wants each base 16-byte aligned and each stride but the last a
multiple of 16 bytes (so P a multiple of 8); the float32 scan is the exact
SIMT kernel.

``ssd`` is differentiable.  Its forward runs the scan above; its backward
(``ssd_bwd``) is ``ref.ssd_chunked``'s gradient: for CUDA tensors the
backward kernels (bfloat16: the chunk-parallel tensor-core kernels, which
read x, gy, B and C by TMA under the forward's rules; float32: the exact
SIMT reverse scan), for CPU tensors ``ref.ssd_chunked_bwd``.  The
reference has no SSD backward kernel: it differentiates its jnp chunked
scan by autodiff."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check_16b, route
from repro_torch.kernels.ssd import ref

#: kernel launches made by ``ssd``'s forward (never by the plain version)
launches = 0
#: launches of the backward kernel (``ssd_bwd`` on CUDA tensors)
launches_bwd = 0
#: the profiler range around the backward's plain version (CPU tensors)
BACKWARD_RANGE = "ssd_backward_plain"
#: the profiler range around the backward kernel (CUDA tensors)
KERNEL_BACKWARD_RANGE = "ssd_backward_kernel"

CHUNK = 64          # the kernel's chunk length
MAX_HEAD_DIM = 64   # P
MAX_STATE = 128     # N
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _SsdParams(ctypes.Structure):
    """``SsdParams`` of ``csrc/ssd_scan.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
                    "x", "dt", "a", "bm", "cm", "d_skip", "y", "state",
                    "h0")]
                + [(n, ctypes.c_longlong) for n in (
                    "x_sb", "x_ss", "x_sh", "dt_sb", "dt_ss", "b_sb", "b_ss",
                    "c_sb", "c_ss", "y_sb", "y_ss", "y_sh")]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "P", "N",
                                               "dtype")])


def _check(x, dt, a, B, C):
    if x.dtype not in _DTYPES:
        raise TypeError(f"the SSD kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    for name, t, shape, dtype in (("dt", dt, (b, s, h), torch.float32),
                                  ("a", a, (h,), torch.float32),
                                  ("B", B, (b, s, n), x.dtype),
                                  ("C", C, (b, s, n), x.dtype)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if x.stride(3) != 1:
        raise ValueError("x's head dim must be contiguous")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"the SSD kernel takes P <= {MAX_HEAD_DIM} and "
                         f"N <= {MAX_STATE}, got P={p}, N={n}")
    if x.dtype == torch.bfloat16:
        check_16b("the bfloat16 SSD kernel's TMA", x=x, B=B, C=C)
        if p % 8:   # y [B,S,H,P] leaves by TMA too: a 16-byte head stride
            raise ValueError(f"the bfloat16 SSD kernel's TMA needs P to be "
                             f"a multiple of 8 (16 bytes), got P={p}")


def ssd(x, dt, a, B, C, d_skip=None, initial_state=None, chunk: int = 64):
    """Chunked SSD scan (training and prefill), differentiable in every
    tensor argument; see ``_ssd_fwd`` for the forward."""
    return _Ssd.apply(x, dt, a, B, C, d_skip, initial_state, chunk)


class _SsdBwdParams(ctypes.Structure):
    """``SsdBwdParams`` of ``csrc/ssd_scan_bwd.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
                    "x", "dt", "a", "bm", "cm", "d_skip", "h0", "gy",
                    "gstate", "states", "cums", "hs", "dhs", "dx", "ddt",
                    "db_part", "dc_part", "da_part", "dd_part", "dh0", "db",
                    "dc", "da", "dd")]
                + [(n, ctypes.c_longlong) for n in (
                    "x_sb", "x_ss", "x_sh", "dt_sb", "dt_ss", "b_sb", "b_ss",
                    "c_sb", "c_ss")]
                + [(n, ctypes.c_int) for n in ("B", "S", "H", "P", "N",
                                               "dtype", "groups")])


class _Ssd(torch.autograd.Function):
    """``_ssd_fwd`` forward; ``ssd_bwd`` backward from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, a, B, C, d_skip, initial_state, chunk):
        ctx.save_for_backward(x, dt, a, B, C, d_skip, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # an unused state brings None
        return _ssd_fwd(x, dt, a, B, C, d_skip, initial_state, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        x, dt, a, B, C, d_skip, h0 = ctx.saved_tensors
        got = ssd_bwd(x, dt, a, B, C, d_skip, h0, gy, gstate, chunk=ctx.chunk)
        return tuple(g if ctx.needs_input_grad[i] else None
                     for i, g in enumerate(got)) + (None,)


def ssd_bwd(x, dt, a, B, C, d_skip=None, initial_state=None, gy=None,
            gstate=None, chunk: int = 64):
    """The gradient of ``ssd`` (``ref.ssd_chunked``) from the incoming
    gradients gy [B,S,H,P] and gstate [B,H,P,N] (either may be None):
    (dx, ddt, da, dB, dC, d_skip's gradient or None, initial_state's or
    None), each in its input's dtype.  CPU tensors take
    ``ref.ssd_chunked_bwd`` (range ``BACKWARD_RANGE``); CUDA tensors launch
    the backward kernels (range ``KERNEL_BACKWARD_RANGE``), which take the
    forward kernel's shapes, its TMA rules in bfloat16, and chunks of
    ``CHUNK``; anything else raises."""
    global launches_bwd
    given = [t for t in (d_skip, initial_state, gy, gstate) if t is not None]
    if not route(x, dt, a, B, C, *given):
        with torch.profiler.record_function(BACKWARD_RANGE):
            return ref.ssd_chunked_bwd(x, dt, a, B, C, d_skip=d_skip,
                                       initial_state=initial_state, gy=gy,
                                       gstate=gstate, chunk=chunk)
    if chunk != CHUNK:
        raise ValueError(f"the SSD backward kernel runs chunks of {CHUNK}, "
                         f"got chunk={chunk}")
    _check(x, dt, a, B, C)
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev, f32 = x.device, torch.float32
    for name, t, shape in (("initial_state", initial_state, (b, h, p, n)),
                           ("gstate", gstate, (b, h, p, n)),
                           ("gy", gy, (b, s, h, p)), ("d_skip", d_skip, (h,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    with torch.profiler.record_function(KERNEL_BACKWARD_RANGE):
        h0 = None if initial_state is None else \
            initial_state.to(f32).contiguous()
        gs = None if gstate is None else gstate.to(f32).contiguous()
        g = None if gy is None else gy.to(x.dtype).contiguous()
        skip = None if d_skip is None else d_skip.to(f32).contiguous()
        code = _DTYPES[x.dtype]
        nc = -(-s // CHUNK)
        if code:     # bf16: gy read by TMA; h_c and dh_c in bf16 scratch
            if g is None:
                g = torch.zeros((b, s, h, p), dtype=x.dtype, device=dev)
            elif g.data_ptr() % 16:
                g = g.clone()
            states = None
            cums = torch.empty((b, h, nc, CHUNK), dtype=f32, device=dev)
            hs = torch.empty((2, b, h, nc, 64 if n <= 64 else 128, 64),
                             dtype=x.dtype, device=dev)
        else:
            states = torch.empty((b, h, nc, p, n), dtype=f32, device=dev)
            cums = hs = None
        groups = _build.load("ssd_scan_bwd_groups", [ctypes.c_int] * 3,
                             lib="ssd_scan_bwd")(h, n, code)
        parts = torch.empty((2, b, groups, s, n), dtype=f32, device=dev)
        small = torch.empty((2, b, nc, h), dtype=f32, device=dev)
        dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
        ddt = torch.empty((b, s, h), dtype=f32, device=dev)
        dB = torch.empty((b, s, n), dtype=B.dtype, device=dev)
        dC = torch.empty((b, s, n), dtype=C.dtype, device=dev)
        da = torch.empty((h,), dtype=f32, device=dev)
        dd = torch.empty((h,), dtype=f32, device=dev)
        dh0 = None if h0 is None else torch.empty_like(h0)

        def ptr(t):
            return None if t is None else t.data_ptr()

        prm = _SsdBwdParams(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(),
            C.data_ptr(), ptr(skip), ptr(h0), ptr(g), ptr(gs), ptr(states),
            ptr(cums), None if hs is None else hs[0].data_ptr(),
            None if hs is None else hs[1].data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), small[0].data_ptr(),
            small[1].data_ptr(), ptr(dh0), dB.data_ptr(), dC.data_ptr(),
            da.data_ptr(), dd.data_ptr(), *x.stride()[:3], *dt.stride()[:2],
            *B.stride()[:2], *C.stride()[:2], b, s, h, p, n, code, groups)
        _build.launch("ssd_scan_bwd", [ctypes.POINTER(_SsdBwdParams),
                                       ctypes.c_void_p], ctypes.byref(prm),
                      torch.cuda.current_stream(dev).cuda_stream)
        launches_bwd += 1
    return (dx, ddt.to(dt.dtype), da.to(a.dtype), dB, dC,
            None if d_skip is None else dd.to(d_skip.dtype),
            None if dh0 is None else dh0.to(initial_state.dtype))


def _ssd_fwd(x, dt, a, B, C, d_skip=None, initial_state=None, chunk: int = 64):
    """Chunked SSD scan (prefill).  x [B,S,H,P]; dt [B,S,H] float32; a [H]
    float32; B/C [B,S,N] in x's type; d_skip [H] or None; initial_state
    [B,H,P,N] or None (zeros).  Returns (y [B,S,H,P] in x's type, final
    state [B,H,P,N]: float32 from the kernel, x's type from the plain
    version, as in the reference).

    A warm start is rounded to x's type before the first chunk, as the
    reference's oracle casts it (``ref.ssd_chunked``).  The kernel runs
    chunks of ``CHUNK`` = 64 positions only; another ``chunk`` raises
    ``ValueError`` on the card (no model path passes one)."""
    global launches
    if not route(x, dt, a, B, C):
        return ref.ssd_chunked(x, dt, a, B, C, d_skip=d_skip,
                               initial_state=initial_state, chunk=chunk)
    if chunk != CHUNK:
        raise ValueError(f"the SSD kernel runs chunks of {CHUNK}, got "
                         f"chunk={chunk}")
    _check(x, dt, a, B, C)
    b, s, h, p = x.shape
    n = B.shape[-1]
    h0 = None
    if initial_state is not None:
        if tuple(initial_state.shape) != (b, h, p, n):
            raise ValueError(f"initial_state must have shape {(b, h, p, n)}, "
                             f"got {tuple(initial_state.shape)}")
        if initial_state.device != x.device:
            raise ValueError("initial_state must lie on x's device")
        h0 = initial_state.to(torch.float32).contiguous()
    skip = (torch.zeros(h, dtype=torch.float32, device=x.device)
            if d_skip is None else d_skip.to(torch.float32).contiguous())
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    prm = _SsdParams(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(),
        C.data_ptr(), skip.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if h0 is None else h0.data_ptr(),
        *x.stride()[:3], *dt.stride()[:2], *B.stride()[:2], *C.stride()[:2],
        *y.stride()[:3], b, s, h, p, n, _DTYPES[x.dtype])
    _build.launch("ssd_scan", [ctypes.POINTER(_SsdParams), ctypes.c_void_p],
                  ctypes.byref(prm),
                  torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    return y, state.transpose(2, 3)


def tc_smem_bytes(n: int) -> int:
    """Dynamic shared memory a block of the bfloat16 kernel takes at state
    dim ``n`` (built on first use, like the launch)."""
    return _build.load("ssd_scan_tc_smem", [ctypes.c_int], lib="ssd_scan")(n)


def ssd_update(state, x_t, dt_t, a, B_t, C_t, d_skip=None):
    """O(1) one-token decode update (plain PyTorch on every device)."""
    return ref.ssd_update(state, x_t, dt_t, a, B_t, C_t, d_skip=d_skip)
