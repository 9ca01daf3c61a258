"""Dispatching wrappers for the attention kernels: CUDA tensors launch the
flash-attention forward (``kernels/csrc/flash_attention.cu``), its backward
(``kernels/csrc/flash_attention_bwd.cu``) or the one-token decode
(``kernels/csrc/flash_decode.cu``); CPU tensors take the plain versions
(``ref.py``); anything else raises.

``attention`` is differentiable: its forward runs the flash-attention
kernel and saves q, k, v, o and lse, its backward (``attention_bwd``)
launches the backward kernels, which sum dK and dV over each KV head's
query group themselves.  ``attention_lse`` and ``decode_attention`` are not
differentiable.

The kernels take KV with its own head count and map query head h to KV
head ``h // (Hq // Hkv)``; the plain versions broadcast KV to the query
heads first, as the reference's model does before its call.

The bfloat16 forward and backward run on the tensor cores and read q, k, v
(and dO; the backward also checks o) by TMA, which wants each tensor's
base 16-byte aligned and its batch, position and head strides multiples of
16 bytes; the float32 forward and backward are the exact SIMT kernels.  The decode copies cache rows 16 bytes at a time, so it wants the
same of k and v (and a row of D elements a multiple of 16 bytes).  The
wrappers raise ``ValueError`` naming the rule otherwise.  The decode splits
each sequence's keys over blocks by ``decode_split_plan``, which reads only
shapes and the SM count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import ref
from repro_torch.kernels.dispatch import check_16b, route

#: kernel launches made by ``attention``/``attention_lse`` (flash_attention),
#: by ``attention``'s backward (flash_attention_bwd) and by
#: ``decode_attention`` (flash_decode), never by the plain versions
launches = {"flash_attention": 0, "flash_attention_bwd": 0,
            "flash_decode": 0}

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _FlashParams(ctypes.Structure):
    """``FlashParams`` of ``csrc/flash_attention.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o", "lse")]
                + [(n, ctypes.c_longlong) for n in (
                    "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh",
                    "v_sb", "v_ss", "v_sh", "o_sb", "o_ss", "o_sh")]
                + [(n, ctypes.c_int) for n in (
                    "B", "S", "T", "Hq", "Hkv", "D", "causal", "dtype")]
                + [("scale", ctypes.c_float)])


class _BwdParams(ctypes.Structure):
    """``BwdParams`` of ``csrc/flash_attention_bwd.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
                    "q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk",
                    "dv")]
                + [(n, ctypes.c_longlong) for n in (
                    "q_sb", "q_ss", "q_sh", "k_sb", "k_ss", "k_sh",
                    "v_sb", "v_ss", "v_sh", "o_sb", "o_ss", "o_sh",
                    "dout_sb", "dout_ss", "dout_sh")]
                + [(n, ctypes.c_int) for n in (
                    "B", "S", "T", "Hq", "Hkv", "D", "causal", "dtype")]
                + [("scale", ctypes.c_float)])


class _DecodeParams(ctypes.Structure):
    """``DecodeParams`` of ``csrc/flash_decode.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "length",
                                                 "o", "part")]
                + [(n, ctypes.c_longlong) for n in (
                    "q_sb", "q_sh", "k_sb", "k_st", "k_sh", "v_sb", "v_st",
                    "v_sh", "o_sb", "o_sh")]
                + [(n, ctypes.c_int) for n in (
                    "B", "T", "Hq", "Hkv", "D", "dtype", "split_len",
                    "n_split", "heads")]
                + [("scale", ctypes.c_float)])


#: keys a decode split holds at least (4 warps x 8 chunks of 16)
DECODE_MIN_SPLIT = 512
#: blocks the decode plan aims for on each SM, so that blocks of short
#: sequences finishing early leave no SM idle at the tail
DECODE_BLOCKS_PER_SM = 16


def decode_heads_per_block(group: int) -> int:
    """Query heads one decode block serves, 8 at most: the power of two at
    or below the GQA group, so a block reads its KV head's rows once for
    all of them."""
    return 8 if group >= 8 else 4 if group >= 4 else 2 if group >= 2 else 1


def decode_split_plan(t: int, b: int, hq: int, hkv: int, n_sm: int):
    """(split_len, n_split) for a decode over a cache of capacity ``t``:
    split i holds keys [i * split_len, min((i + 1) * split_len, t)).  From
    shapes and the SM count only (never the lengths, which would sync the
    host each step): enough splits that B x KV-head blocks x splits reach
    ``DECODE_BLOCKS_PER_SM`` blocks an SM, no split under
    ``DECODE_MIN_SPLIT`` keys, split_len a multiple of 64.  One split when
    the cache is short (the engine's T=128): the kernel then writes o
    itself in one launch."""
    group = hq // hkv
    blocks = b * hkv * -(-group // decode_heads_per_block(group))
    want = -(-DECODE_BLOCKS_PER_SM * n_sm // blocks)
    n = max(1, min(want, -(-t // DECODE_MIN_SPLIT)))
    split_len = -(-(-(-t // n)) // 64) * 64
    return split_len, -(-t // split_len)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v):
    """Raise unless q [B,*,Hq,D] and k/v [B,T,Hkv,D] are what the kernels
    take: one float32 or bfloat16 type, Hq a multiple of Hkv, D <= 128,
    the head dim contiguous."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"the attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype} but q is {q.dtype}")
        if x.ndim != 4 or q.ndim != 4:
            raise ValueError("q, k and v must be [B, S, H, D] tensors")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")


def attention_lse(q, k, v, *, causal: bool = True):
    """GQA flash attention with its log-sum-exp.  q [B,S,Hq,D]; k/v
    [B,T,Hkv,D].  Returns (o [B,S,Hq,D] in q's type, lse [B,S,Hq]
    float32)."""
    if not route(q, k, v):
        return ref.mha_lse(q, ref.broadcast_kv(k, q.shape[2]),
                           ref.broadcast_kv(v, q.shape[2]), causal=causal)
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        check_16b("the bfloat16 attention kernel's TMA", q=q, k=k, v=v)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, hq), dtype=torch.float32, device=q.device)
    p = _FlashParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], b, s, t, hq, hkv, d, int(causal), _DTYPES[q.dtype],
        d ** -0.5)
    _build.launch("flash_attention", [ctypes.POINTER(_FlashParams),
                                      ctypes.c_void_p], ctypes.byref(p),
                  torch.cuda.current_stream(q.device).cuda_stream)
    launches["flash_attention"] += 1
    return o, lse


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True):
    """dq [B,S,Hq,D], dk and dv [B,T,Hkv,D] (in q's type) of GQA attention
    from its output o and lse (``attention_lse``) and the incoming gradient
    do [B,S,Hq,D].  CPU tensors take the plain ``ref.gqa_bwd``; CUDA
    tensors launch the backward kernels: delta, then dK/dV and dQ, on the
    tensor cores for bfloat16 (``ValueError`` unless q, k, v, o and do are
    what TMA reads), SIMT for float32."""
    if not route(q, k, v, o, lse, do):
        return ref.gqa_bwd(q, k, v, o, lse, do, causal)
    _check(q, k, v)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    for name, x, dtype in (("o", o, q.dtype), ("do", do, q.dtype)):
        if x.dtype != dtype or tuple(x.shape) != (b, s, hq, d):
            raise ValueError(f"{name} must be {dtype} of shape "
                             f"{(b, s, hq, d)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if do.stride(3) != 1:
        do = do.contiguous()
    if o.stride(3) != 1:
        raise ValueError("o's head dim must be contiguous")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, s, hq) \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 {(b, s, hq)} "
                         "tensor")
    if q.dtype == torch.bfloat16:
        check_16b("the bfloat16 attention backward's TMA", q=q, k=k, v=v,
                  o=o, do=do)
    delta = torch.empty((b, s, hq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, t, hkv, d), dtype=q.dtype, device=q.device)
    p = _BwdParams(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *o.stride()[:3], *do.stride()[:3], b, s, t, hq,
        hkv, d, int(causal), _DTYPES[q.dtype], d ** -0.5)
    _build.launch("flash_attention_bwd", [ctypes.POINTER(_BwdParams),
                                          ctypes.c_void_p], ctypes.byref(p),
                  torch.cuda.current_stream(q.device).cuda_stream)
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """``attention_lse`` forward (o and lse saved), ``attention_bwd``
    backward: the reference's ``custom_vjp`` with its kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = attention_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*attention_bwd(q, k, v, o, lse, do, causal=ctx.causal), None)


def attention(q, k, v, *, causal: bool = True):
    """GQA attention.  q [B,S,Hq,D]; k/v [B,T,Hkv,D] -> [B,S,Hq,D].
    Differentiable in q, k and v."""
    return _Attention.apply(q, k, v, causal)


def decode_attention(q, k_cache, v_cache, length):
    """One-token attention.  q [B,1,Hq,D]; caches [B,T,Hkv,D] (any strides
    with the head dim contiguous, e.g. a view of the fused [B,T,Hkv*D]
    cache); length [B] int32: positions >= length are masked.  Returns
    [B,1,Hq,D] in q's type."""
    if not route(q, k_cache, v_cache, length):
        hq = q.shape[2]
        return ref.decode_attention(
            q, ref.broadcast_kv(k_cache, hq).to(q.dtype),
            ref.broadcast_kv(v_cache, hq).to(q.dtype), length)
    _check(q, k_cache, v_cache)
    b, one, hq, d = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query token, got {one}")
    if length.dtype != torch.int32 or tuple(length.shape) != (b,) \
            or not length.is_contiguous():
        raise ValueError(f"length must be a contiguous int32 [{b}] tensor")
    if (d * q.element_size()) % 16:
        raise ValueError(f"the decode kernel's 16-byte copies need a row of "
                         f"D={d} elements to be a multiple of 16 bytes")
    check_16b("the decode kernel's 16-byte copies", k_cache=k_cache,
               v_cache=v_cache)
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    split_len, n_split = decode_split_plan(t, b, hq, hkv,
                                           _sm_count(q.device.index))
    o = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    part = (torch.empty((b, hq, n_split, d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    p = _DecodeParams(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), o.data_ptr(),
        part.data_ptr() if part is not None else None, q.stride(0),
        q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        o.stride(0), o.stride(2), b, t, hq, hkv, d, _DTYPES[q.dtype],
        split_len, n_split, decode_heads_per_block(hq // hkv), d ** -0.5)
    _build.launch("flash_decode", [ctypes.POINTER(_DecodeParams),
                                   ctypes.c_void_p], ctypes.byref(p),
                  torch.cuda.current_stream(q.device).cuda_stream)
    launches["flash_decode"] += 1
    return o

