"""Layer library: RMSNorm, RoPE, GQA attention, dense FFN, Mamba-2 block.

Every layer is a pair of functions, as in the reference package:
  ``*_defs(cfg)``  -> tree of ParamDef (shapes + init)
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
    return {"scale": ParamDef((d,), init="ones")}


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
        "wq": ParamDef((d, hq * hd)),
        "wk": ParamDef((d, hkv * hd)),
        "wv": ParamDef((d, hkv * hd)),
        "wo": ParamDef((hq * hd, d)),
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
    defs = {"wi": ParamDef((d, f)), "wo": ParamDef((f, d))}
    if gated:
        defs["wg"] = ParamDef((d, f))
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
        "router": ParamDef((d, e), scale=d ** -0.5),
        "wi": ParamDef((e, d, 2 * f)),
        "wo": ParamDef((e, f, d)),
    }


def moe_apply(p, x, cfg: ModelConfig):
    raise NotImplementedError(
        "the MoE block is not ported to PyTorch yet (ROADMAP.md, queue A, "
        "item A.3, \"the MoE block\")")


# ---------------------------------------------------------------- Mamba-2


def mamba_defs(cfg: ModelConfig):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv
    return {
        "in_z": ParamDef((d, di)),
        "in_x": ParamDef((d, di)),
        "in_b": ParamDef((d, n)),
        "in_c": ParamDef((d, n)),
        "in_dt": ParamDef((d, h)),
        "conv_x": ParamDef((w, di), scale=w ** -0.5),
        "conv_b": ParamDef((w, n), scale=w ** -0.5),
        "conv_c": ParamDef((w, n), scale=w ** -0.5),
        "a_log": ParamDef((h,), init="ssm_a"),
        "dt_bias": ParamDef((h,), init="dt_bias"),
        "d_skip": ParamDef((h,), init="ones"),
        "norm": ParamDef((di,), init="ones"),
        "out": ParamDef((di, d)),
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
