"""Plain PyTorch versions of the attention kernels: the blockwise
online-softmax forward (``_fwd``, returning o and lse), its hand-written
recompute backward (``_bwd_impl``) and one-token attention over a KV cache,
op for op the reference package's ``kernels/attention/ref.py``.

``mha`` is differentiable the way the reference's ``custom_vjp`` makes it:
the backward recomputes each block's probabilities from the saved lse
instead of letting autograd stack them through the blockwise loop
(``[n_blocks, B, S, H, block]`` float32 -- gigabytes at 4k).

Head convention, as in the reference: q/k/v all carry H = n_q_heads (the
wrapper in ``ops.py`` broadcasts KV heads to query heads first):
  q: [B, S, H, D]   k/v: [B, T, H, D]
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _blocks(x, block):
    """Zero-pad axis 1 to a multiple of ``block``; returns [B, n, block, ...]."""
    b, t = x.shape[0], x.shape[1]
    n = (t + block - 1) // block
    pad = n * block - t
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad) + tuple(x.shape[2:]))], dim=1)
    return x.reshape((b, n, block) + tuple(x.shape[2:])), n


def _fwd(q, k, v, causal: bool, block_kv: int):
    """Returns (o [B,S,H,D] in q's dtype, lse [B,S,H] float32)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = d ** -0.5
    kb, n = _blocks(k, block_kv)          # [B,n,Bk,H,D]
    vb, _ = _blocks(v, block_kv)
    q_pos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, s, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    for i in range(n):
        k_i, v_i = kb[:, i], vb[:, i]
        logits = torch.einsum("bshd,bthd->bsht", q, k_i) * scale
        kv_pos = i * block_kv + torch.arange(block_kv, device=q.device)[None, :]
        valid = kv_pos < t
        if causal:
            valid = valid & (kv_pos <= q_pos)
        logits = logits.masked_fill(~valid[None, :, None, :], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bsht,bthd->bshd", p.to(v_i.dtype), v_i)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    o = (acc / l_safe[..., None]).to(q.dtype)
    lse = m + torch.log(l_safe)
    return o, lse


def _bwd_impl(q, k, v, o, lse, do, causal: bool, block_kv: int):
    """dq, dk, dv of ``_fwd`` from its saved o and lse: each block's
    probabilities recomputed from lse, delta = sum(dO * O); p cast to dO's
    type before dV, dS to q's type before dQ and dK."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = d ** -0.5
    kb, n = _blocks(k, block_kv)
    vb, _ = _blocks(v, block_kv)
    q_pos = torch.arange(s, device=q.device)[:, None]
    delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    dq = torch.zeros_like(q)
    dkb, dvb = [], []
    for i in range(n):
        k_i, v_i = kb[:, i], vb[:, i]
        logits = torch.einsum("bshd,bthd->bsht", q, k_i) * scale
        kv_pos = i * block_kv + torch.arange(block_kv, device=q.device)[None, :]
        valid = kv_pos < t
        if causal:
            valid = valid & (kv_pos <= q_pos)
        logits = logits.masked_fill(~valid[None, :, None, :], NEG_INF)
        p = torch.exp(logits - lse[..., None])           # [B,S,H,Bk] f32
        dvb.append(torch.einsum("bsht,bshd->bthd", p.to(do.dtype), do))
        dp = torch.einsum("bshd,bthd->bsht", do, v_i).to(torch.float32)
        ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
        dq = dq + torch.einsum("bsht,bthd->bshd", ds, k_i)
        dkb.append(torch.einsum("bsht,bshd->bthd", ds, q))
    dk = torch.cat(dkb, dim=1)[:, :t]
    dv = torch.cat(dvb, dim=1)[:, :t]
    return dq, dk, dv


class _Mha(torch.autograd.Function):
    """The reference's ``custom_vjp`` around ``_fwd``: the forward saves
    q, k, v, o and lse, the backward is ``_bwd_impl``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_kv):
        o, lse = _fwd(q, k, v, causal, block_kv)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.block_kv = causal, block_kv
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_impl(q, k, v, o, lse, do.contiguous(), ctx.causal,
                               ctx.block_kv)
        return dq, dk, dv, None, None


def gqa_bwd(q, k, v, o, lse, do, causal: bool):
    """dq [B,S,Hq,D], dk and dv [B,T,Hkv,D] of attention over KV with its
    own head count: ``_bwd_impl`` on KV broadcast to the query heads (the
    block size ``mha`` picks), each group's dK and dV then summed in
    float32 and rounded once to q's type."""
    hq, hkv = q.shape[2], k.shape[2]
    dq, dk, dv = _bwd_impl(q, broadcast_kv(k, hq), broadcast_kv(v, hq), o,
                           lse, do.contiguous(), causal,
                           min(1024, max(k.shape[1], 128)))
    if hq != hkv:
        b, t, _, d = dk.shape
        dk, dv = (x.float().reshape(b, t, hkv, hq // hkv, d).sum(3)
                  .to(q.dtype) for x in (dk, dv))
    return dq, dk, dv


def mha_lse(q, k, v, *, causal: bool = True, block_kv: int = 1024):
    """Flash attention (plain) with its log-sum-exp.  q [B,S,H,D]; k/v
    [B,T,H,D].  Returns (o [B,S,H,D], lse [B,S,H] float32); o is
    differentiable (``_bwd_impl``), lse is not."""
    assert q.shape[2] == k.shape[2], "broadcast KV to query heads first"
    block_kv = min(block_kv, max(k.shape[1], 128))
    return _Mha.apply(q, k, v, causal, block_kv)


def mha(q, k, v, *, causal: bool = True, block_kv: int = 1024):
    """Flash attention (plain).  q [B,S,H,D]; k/v [B,T,H,D]."""
    return mha_lse(q, k, v, causal=causal, block_kv=block_kv)[0]


def decode_attention(q, k_cache, v_cache, length):
    """One-token attention: q [B,1,H,D] over cache [B,T,H,D], positions
    >= ``length`` masked out."""
    d = q.shape[-1]
    t = k_cache.shape[1]
    logits = torch.einsum("bshd,bthd->bsht", q, k_cache) * (d ** -0.5)
    valid = torch.arange(t, device=q.device)[None, :] < length[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(logits.to(torch.float32), dim=-1)
    out = torch.einsum("bsht,bthd->bshd", w.to(v_cache.dtype), v_cache)
    return out.to(q.dtype)


def decode_attention_split(q, k_cache, v_cache, length, split_len: int):
    """``decode_attention`` as ``csrc/flash_decode.cu`` computes it, split
    over keys (for the tests: the model calls ``decode_attention``).  Split
    i takes keys [i * split_len, (i + 1) * split_len) below the sequence's
    key count (all T when length <= 0, every score then -1e30), keeps its
    own max m, sum l and unnormalised accumulator (p rounded to v's type),
    and the splits merge in order with weights exp(m_i - max m).  An empty
    split has m = -1e30 and l = 0: weight 0 beside a live split, nothing to
    add to an all-masked one.  q [B,1,H,D]; caches [B,T,H,D]."""
    d = q.shape[-1]
    t = k_cache.shape[1]
    keys = torch.where(length <= 0, t, length.clamp(max=t))
    in_range = torch.arange(t, device=q.device)[None, :] < keys[:, None]
    logits = torch.einsum("bhd,bthd->bht", q[:, 0].float(),
                          k_cache.float()) * (d ** -0.5)
    logits = logits.masked_fill((length <= 0)[:, None, None], NEG_INF)
    parts = []
    for s0 in range(0, t, split_len):
        ok = in_range[:, None, s0:s0 + split_len]
        lg = logits[..., s0:s0 + split_len]
        m = torch.where(ok, lg, NEG_INF).amax(dim=-1)
        e = torch.where(ok, torch.exp(lg - m[..., None]), 0.0)
        acc = torch.einsum("bht,bthd->bhd", e.to(v_cache.dtype).float(),
                           v_cache[:, s0:s0 + split_len].float())
        parts.append((m, e.sum(dim=-1), acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m_all)
    acc = torch.zeros_like(parts[0][2])
    for m, l_i, acc_i in parts:
        f = torch.exp(m - m_all)
        l = l + l_i * f
        acc = acc + acc_i * f[..., None]
    return (acc / torch.clamp_min(l, 1e-30)[..., None])[:, None].to(q.dtype)


def broadcast_kv(k, n_q: int):
    """[B,T,Hkv,D] -> [B,T,Hq,D] by group broadcast (a view when the group
    is 1, a copy otherwise)."""
    b, t, hkv, d = k.shape
    g = n_q // hkv
    if g == 1:
        return k
    return k[:, :, :, None, :].expand(b, t, hkv, g, d).reshape(b, t, n_q, d)
