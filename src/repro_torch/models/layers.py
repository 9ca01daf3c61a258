"""Layer library: RMSNorm, RoPE, GQA attention, dense/MoE FFN, Mamba-2 block.

Every layer is a pair of functions, as in the reference package:
  ``*_defs(cfg)``  -> tree of ParamDef (shapes + logical sharding + init)
  ``*_apply(p, x, cfg, ...)`` -> output

Compute dtype follows ``x.dtype`` (weights are cast at use, a no-op when
the step cast them once).  Attention and the SSD scan go through the
kernel wrappers (``kernels/attention/ops.py``, ``kernels/ssd/ops.py``:
CUDA tensors launch the kernels, CPU tensors take the plain versions);
``kernels=False`` calls the plain versions on any device, the comparison
path.  The kernels take KV with its own head count; the plain versions
broadcast it to the query heads first, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models.common import ModelConfig, ParamDef

# ---------------------------------------------------------------- norms


def rmsnorm_defs(d):
    return {"scale": ParamDef((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps):
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


# ---------------------------------------------------------------- rope


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float):
    """Rotary embedding on the first ``fraction`` of the head dim (half-split
    layout).  x [B,S,H,D]; positions [S] or [B,S]."""
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    if positions.ndim == 1:
        ang = positions[:, None].to(torch.float32) * freq[None, :]   # [S,half]
        ang = ang[None, :, None, :]                                  # [1,S,1,half]
    else:
        ang = positions[..., None].to(torch.float32) * freq          # [B,S,half]
        ang = ang[:, :, None, :]
    sin, cos = torch.sin(ang).to(x.dtype), torch.cos(ang).to(x.dtype)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# ---------------------------------------------------------------- attention


def attention_defs(cfg: ModelConfig):
    # fused [D, H*hd] layouts, as in the reference
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, hq * hd), ("fsdp", "tp")),
        "wk": ParamDef((d, hkv * hd), ("fsdp", "tp")),
        "wv": ParamDef((d, hkv * hd), ("fsdp", "tp")),
        "wo": ParamDef((hq * hd, d), ("tp", "fsdp")),
    }


def _qkv(p, x, cfg: ModelConfig, positions):
    dt = x.dtype
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = torch.matmul(x, p["wq"].to(dt)).reshape(b, s, hq, hd)
    k = torch.matmul(x, p["wk"].to(dt)).reshape(b, s, hkv, hd)
    v = torch.matmul(x, p["wv"].to(dt)).reshape(b, s, hkv, hd)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def attention_apply(p, x, cfg: ModelConfig, positions=None, *,
                    kernels: bool = True):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    if kernels:
        o = attn_ops.attention(q, k, v, causal=cfg.causal)
    else:
        o = attn_ref.mha(q, attn_ref.broadcast_kv(k, cfg.n_heads),
                         attn_ref.broadcast_kv(v, cfg.n_heads),
                         causal=cfg.causal)
    out = torch.matmul(o.reshape(b, s, -1), p["wo"].to(x.dtype))
    return out, (k, v)


def attention_decode(p, x, cache_k, cache_v, pos, cfg: ModelConfig, *,
                     kernels: bool = True):
    """One-token decode.  x [B,1,D]; cache [B,T,Hkv*hd] (fused head axis);
    pos a 0-d (aligned batch decode) or [B] (continuous batching: per-slot
    positions) int32 tensor.  The new K/V row is written into the caches in
    place.  Returns (out, cache_k, cache_v)."""
    bsz, t = cache_k.shape[0], cache_k.shape[1]
    if pos.ndim == 0:
        positions = pos.to(torch.int32).expand(bsz, 1)
    else:
        positions = pos[:, None]
    q, k, v = _qkv(p, x, cfg, positions)
    rows = torch.arange(bsz, device=x.device)
    slot_pos = positions[:, 0].long()
    cache_k[rows, slot_pos] = k.reshape(bsz, -1).to(cache_k.dtype)
    cache_v[rows, slot_pos] = v.reshape(bsz, -1).to(cache_v.dtype)
    length = (positions[:, 0] + 1).to(torch.int32)
    kc = cache_k.reshape(bsz, t, cfg.kv_heads, cfg.hd).to(q.dtype)
    vc = cache_v.reshape(bsz, t, cfg.kv_heads, cfg.hd).to(q.dtype)
    if kernels:
        o = attn_ops.decode_attention(q, kc, vc, length)
    else:
        o = attn_ref.decode_attention(
            q, attn_ref.broadcast_kv(kc, cfg.n_heads),
            attn_ref.broadcast_kv(vc, cfg.n_heads), length)
    out = torch.matmul(o.reshape(bsz, 1, -1), p["wo"].to(x.dtype))
    return out, cache_k, cache_v


# ---------------------------------------------------------------- dense FFN


def ffn_defs(cfg: ModelConfig, gated: bool = True):
    d, f = cfg.d_model, cfg.d_ff
    defs = {"wi": ParamDef((d, f), ("fsdp", "mlp")),
            "wo": ParamDef((f, d), ("mlp", "fsdp"))}
    if gated:
        defs["wg"] = ParamDef((d, f), ("fsdp", "mlp"))
    return defs


def ffn_apply(p, x, cfg: ModelConfig):
    dt = x.dtype
    h = torch.matmul(x, p["wi"].to(dt))
    if "wg" in p:  # SwiGLU
        h = F.silu(torch.matmul(x, p["wg"].to(dt))) * h
    else:  # GELU (encoder-style; jax.nn.gelu's tanh form)
        h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, p["wo"].to(dt))


# ---------------------------------------------------------------- MoE FFN


def moe_defs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, e), ("fsdp", None), scale=d ** -0.5),
        "wi": ParamDef((e, d, 2 * f), ("experts", "fsdp", None)),
        "wo": ParamDef((e, f, d), ("experts", None, "fsdp")),
    }


def moe_capacity(s: int, cfg: ModelConfig) -> int:
    """Slots an expert holds in a group of ``s`` tokens: the reference's
    rule, dropless for tiny groups (decode: ``s=1`` gives 1)."""
    cap = int((s * cfg.top_k / cfg.n_experts) * cfg.capacity_factor + 0.5)
    return max(min(cap, s), min(s, 4), 1)


def moe_route(p, x, cfg: ModelConfig):
    """Top-k routing of each group (batch row) of x [G,S,D] -> (experts
    [G,S,k] int64, gates [G,S,k] float32): the router product in x's type,
    then float32; a stable descending sort picks the k largest logits, so
    ties keep the lower expert first, as ``jax.lax.top_k`` does
    (``torch.topk`` promises no order among ties); softmax over those k."""
    logits = torch.matmul(x, p["router"].to(x.dtype)).to(torch.float32)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.top_k
    return idx[..., :k], torch.softmax(vals[..., :k], dim=-1)


def moe_sort(flat, n_experts: int):
    """Each group's entries sorted by expert, stably, so that every
    expert's entries stay in token order.  flat [G,N] expert ids (token-
    major) -> (order [G,N]: the entries in expert order; starts, counts
    [G,E]: each expert's range in that order; rank [G,N]: each entry's
    place in its expert's range)."""
    b, n = flat.shape
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    experts = torch.arange(n_experts, device=flat.device).expand(
        b, n_experts).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    entries = torch.arange(n, device=flat.device).expand(b, n)
    inv = torch.empty_like(order).scatter_(1, order, entries)  # a permutation
    rank = (entries - torch.gather(starts, 1, sorted_e)).gather(1, inv)
    return order, starts, counts, rank


def moe_apply(p, x, cfg: ModelConfig):
    """Grouped sort-based top-k dispatch, as the reference's: routing per
    group (batch row), each expert's entries in token order, the first
    ``moe_capacity`` kept and the rest dropped (weight 0).

    Vectorised over groups, with no scatter into the buffers: each expert
    slot gathers the token that fills it (empty slots stay zero), the
    experts run as two batched products over an [E, G*C, D] buffer, and
    each (token, j) contribution is gathered back by its expert and rank,
    scaled by its gate in x's type and summed over j in index order.  No
    ``index_add_`` or atomics: two calls are bitwise equal on the card."""
    b, s, d = x.shape
    e, k, dt, dev = cfg.n_experts, cfg.top_k, x.dtype, x.device
    cap = moe_capacity(s, cfg)
    idx, gates = moe_route(p, x, cfg)
    flat = idx.reshape(b, s * k)
    order, starts, counts, rank = moe_sort(flat, e)
    slots = torch.arange(cap, device=dev)
    groups = torch.arange(b, device=dev)

    # dispatch: slot c of expert i takes entry starts[i] + c of the order
    src = (starts[:, :, None] + slots).clamp(max=s * k - 1)   # [G,E,C]
    token = torch.gather(order, 1, src.reshape(b, e * cap)) // k
    row = token.reshape(b, e, cap) + s * groups[:, None, None]
    filled = slots < counts[:, :, None]                        # [G,E,C]
    buf = torch.where(filled.transpose(0, 1)[..., None],
                      x.reshape(b * s, d)[row.transpose(0, 1)], 0)
    buf = buf.reshape(e, b * cap, d)

    hg = torch.bmm(buf, p["wi"].to(dt))                        # [E,G*C,2F]
    h, g = hg.chunk(2, dim=-1)
    out = torch.bmm(F.silu(g) * h, p["wo"].to(dt))             # [E,G*C,D]

    # combine: entry (t, j) sits in slot (expert, rank) if it was kept
    keep = (rank < cap).reshape(b, s, k)
    slot = flat * (b * cap) + cap * groups[:, None] + rank.clamp(max=cap - 1)
    contrib = out.reshape(e * b * cap, d)[slot].reshape(b, s, k, d)
    contrib = torch.where(keep[..., None], contrib * gates.to(dt)[..., None], 0)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


# ---------------------------------------------------------------- Mamba-2


def mamba_defs(cfg: ModelConfig):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    return {
        "in_z": ParamDef((d, di), ("fsdp", "tp")),
        "in_x": ParamDef((d, di), ("fsdp", "tp")),
        "in_b": ParamDef((d, n), ("fsdp", None)),
        "in_c": ParamDef((d, n), ("fsdp", None)),
        "in_dt": ParamDef((d, h), ("fsdp", "tp")),
        "conv_x": ParamDef((w, di), (None, "tp"), scale=w ** -0.5),
        "conv_b": ParamDef((w, n), (None, None), scale=w ** -0.5),
        "conv_c": ParamDef((w, n), (None, None), scale=w ** -0.5),
        "a_log": ParamDef((h,), ("tp",), init="ssm_a"),
        "dt_bias": ParamDef((h,), ("tp",), init="dt_bias"),
        "d_skip": ParamDef((h,), ("tp",), init="ones"),
        "norm": ParamDef((di,), ("tp",), init="ones"),
        "out": ParamDef((di, d), ("tp", "fsdp")),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x [B,S,C]; w [W,C]; state [B,W-1,C] or None.
    Returns (y, new_state)."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :].to(x.dtype)
            for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return F.silu(y), new_state


def _mamba_proj(p, x, cfg: ModelConfig):
    dt_ = x.dtype
    z = torch.matmul(x, p["in_z"].to(dt_))
    xs = torch.matmul(x, p["in_x"].to(dt_))
    bb = torch.matmul(x, p["in_b"].to(dt_))
    cc = torch.matmul(x, p["in_c"].to(dt_))
    dt = torch.matmul(x, p["in_dt"].to(dt_))
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    return z, xs, bb, cc, dt


def _gated_out(p, y, z, cfg, shape_bsd):
    b, s, _ = shape_bsd
    y = y.reshape(b, s, cfg.d_inner)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z)
    var = torch.mean(torch.square(y.to(torch.float32)), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps).to(y.dtype)
    y = y * p["norm"].to(y.dtype)
    return torch.matmul(y, p["out"].to(y.dtype))


def mamba_apply(p, x, cfg: ModelConfig, *, kernels: bool = True):
    """Full-sequence Mamba-2 block (prefill).  Returns (out, state) where
    state = (conv_x, conv_b, conv_c, ssm)."""
    b, s, _ = x.shape
    z, xs, bb, cc, dt = _mamba_proj(p, x, cfg)
    xs, st_x = _causal_conv(xs, p["conv_x"])
    bb, st_b = _causal_conv(bb, p["conv_b"])
    cc, st_c = _causal_conv(cc, p["conv_c"])
    xh = xs.reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim)
    a = -torch.exp(p["a_log"].to(torch.float32))
    scan = ssd_ops.ssd if kernels else ssd_ref.ssd_chunked
    y, ssm = scan(xh, dt, a, bb, cc, d_skip=p["d_skip"])
    out = _gated_out(p, y, z, cfg, (b, s, cfg.d_model))
    return out, (st_x, st_b, st_c, ssm)


def mamba_decode(p, x, state, cfg: ModelConfig):
    """One-token decode.  x [B,1,D]; state=(conv_x,conv_b,conv_c,ssm)."""
    b = x.shape[0]
    st_x, st_b, st_c, ssm = state
    z, xs, bb, cc, dt = _mamba_proj(p, x, cfg)
    xs, st_x = _causal_conv(xs, p["conv_x"], st_x)
    bb, st_b = _causal_conv(bb, p["conv_b"], st_b)
    cc, st_c = _causal_conv(cc, p["conv_c"], st_c)
    a = -torch.exp(p["a_log"].to(torch.float32))
    xh = xs.reshape(b, cfg.ssm_heads, cfg.ssm_head_dim)
    ssm, y = ssd_ops.ssd_update(ssm, xh, dt[:, 0], a, bb[:, 0], cc[:, 0],
                                d_skip=p["d_skip"])
    out = _gated_out(p, y[:, None], z, cfg, (b, 1, cfg.d_model))
    return out, (st_x, st_b, st_c, ssm)
