"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) scan
[arXiv:2405.21060], op for op the reference package's ``kernels/ssd/ref.py``.

Chunked formulation: within a chunk of length Q the recurrence is expanded as
a masked quadratic form; across chunks the state h [B,H,P,N] is carried by a
short loop.  Single B/C group (n_groups=1).

  x:  [B, S, H, P]   (P = head dim)
  dt: [B, S, H]      (> 0, already softplus'ed + bias)
  a:  [H]            (< 0, = -exp(a_log))
  B, C: [B, S, N]    (N = state dim)

``ssd_chunked`` is the prefill path; ``ssd_update`` is the O(1) one-token
decode path (plain on every device, as in the reference).  ``ssd_scan_model``
is a test-only model of the CUDA kernel's own order of rounding and summing;
``ssd_bwd_model`` is the same for the bfloat16 backward kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pad_seq(x, pad):
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))],
                     dim=1)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    d_skip: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,H,P], final_state [B,H,P,N] in x's dtype)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    orig_s = s
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = (_pad_seq(t, pad) for t in (x, dt, B, C))  # dt=0: no-op steps
        s = s + pad
    nc = s // chunk
    dtype = x.dtype

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).to(torch.float32)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    dA = dtc * a.to(torch.float32)                   # [b,nc,q,h], <= 0
    cum = torch.cumsum(dA, dim=2)                    # running within-chunk decay
    seg_total = cum[:, :, -1, :]                     # [b,nc,h]
    xw = xc * dtc[..., None].to(dtype)               # dt-weighted inputs

    # ---- intra-chunk (quadratic, masked) ------------------------------------
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # [b,nc,q,q]
    # exponent <= 0 on the valid (lower) triangle; the clamp keeps the masked
    # upper triangle from overflowing to inf
    decay = torch.exp(torch.clamp_max(
        cum[:, :, :, None, :] - cum[:, :, None, :, :], 0.0))  # [b,nc,q,q,h]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    w = torch.where(tri[None, None, :, :, None], scores[..., None] * decay,
                    torch.zeros((), dtype=torch.float32, device=x.device))
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w.to(dtype), xw)

    # ---- per-chunk end states ------------------------------------------------
    state_decay = torch.exp(seg_total[:, :, None, :] - cum)        # [b,nc,q,h]
    h_chunk = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc,
                           state_decay.to(dtype), xw)              # [b,nc,h,p,n]

    # ---- inter-chunk scan ----------------------------------------------------
    gamma = torch.exp(seg_total)                     # [b,nc,h]
    if initial_state is None:
        h_prev = torch.zeros((b, h, p, n), dtype=dtype, device=x.device)
    else:
        h_prev = initial_state.to(dtype)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum(
            "bqn,bqh,bhpn->bqhp", Cc[:, c], torch.exp(cum[:, c]).to(dtype),
            h_prev))
        h_prev = h_prev * gamma[:, c, :, None, None].to(dtype) + h_chunk[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)
    if d_skip is not None:
        y = y + d_skip[None, None, None, :, None].to(dtype) * xc
    y = y.reshape(b, s, h, p)[:, :orig_s]
    return y.to(x.dtype), h_prev


def ssd_chunked_bwd(x, dt, a, B, C, d_skip=None, initial_state=None,
                    gy=None, gstate=None, chunk: int = 64):
    """The gradient of ``ssd_chunked`` by a chunked reverse scan, in float32:
    op for op what the float32 kernel of ``csrc/ssd_scan_bwd.cu`` computes.  ``gy`` [B,S,H,P] and
    ``gstate`` [B,H,P,N] are the incoming gradients of y and the final
    state; either may be None (zeros).  Returns (dx, ddt, da, dB, dC,
    d_skip's gradient or None, initial_state's gradient or None), each in
    its input's dtype.

    1. The states entering each chunk by a forward walk (``h_prev`` of chunk
       0 is the warm start rounded to x's type, as ``ssd_chunked`` casts
       it).
    2. Intra-chunk, per chunk: dw_ij = <gy_i, xw_j> (j <= i) gives
       d(xw)_j += sum_i w_ij gy_i, dscores = dw * decay (into dC and dB,
       summed over the heads that share B and C) and, where the clamp of
       ``cum_i - cum_j`` at 0 passes its gradient (below the diagonal, where
       the two terms of a diagonal entry cancel), dw * w into dcum_i and
       -dcum_j.
    3. Inter-chunk, walking the chunks in reverse with dh (the gradient of
       the state leaving the chunk, from ``gstate``): y_inter gives
       dC_i += exp(cum_i) h_prev^T gy_i and dcum_i += exp(cum_i) <C_i
       h_prev, gy_i>; the state update h = h_prev gamma + h_chunk gives
       dseg += <dh, h_prev> gamma and, through h_chunk = sum_j B_j
       exp(seg - cum_j) xw_j, dB_j, d(xw)_j and dcum_j (seg's share added
       to the chunk's last position); then dh_prev = dh gamma + sum_i
       exp(cum_i) gy_i C_i^T.
    4. dA = the reverse cumsum of dcum; ddt = dA a + <d(xw), x>; da = sum
       dA dt; dx = d(xw) dt + D gy; dD = sum <x, gy>.
    Padded rows (S not a multiple of ``chunk``) carry dt = 0 and gy = 0, as
    in the forward."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    pad = (-s) % chunk
    if gy is None:
        gy = torch.zeros((b, s, h, p), dtype=f32, device=x.device)
    if pad:
        x, dt, B, C, gy = (_pad_seq(t, pad) for t in (x, dt, B, C, gy))
    nc = (s + pad) // chunk
    q = chunk
    xc = x.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    Bc = B.reshape(b, nc, q, n).to(f32)
    Cc = C.reshape(b, nc, q, n).to(f32)
    gyc = gy.reshape(b, nc, q, h, p).to(f32)
    a32 = a.to(f32)
    skip = None if d_skip is None else d_skip.to(f32)

    cum = torch.cumsum(dtc * a32, dim=2)                   # [b,nc,q,h]
    seg = cum[:, :, -1, :]                                 # [b,nc,h]
    xw = xc * dtc[..., None]
    e = torch.exp(cum)                                     # exp(cum_i)
    sd = torch.exp(seg[:, :, None, :] - cum)               # exp(seg - cum_j)
    gamma = torch.exp(seg)

    # 1. the states entering each chunk
    h_chunk = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, sd, xw)
    hs = []
    h_prev = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
              if initial_state is None
              else initial_state.to(x.dtype).to(f32))
    for c in range(nc):
        hs.append(h_prev)
        h_prev = h_prev * gamma[:, c, :, None, None] + h_chunk[:, c]
    hp = torch.stack(hs, dim=1)                            # [b,nc,h,p,n]

    # 2. intra-chunk
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    below = torch.tril(tri, -1)
    u = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,nc,i,j,h]
    decay = torch.exp(torch.clamp_max(u, 0.0))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    zero = torch.zeros((), dtype=f32, device=x.device)
    w = torch.where(tri[..., None], scores[..., None] * decay, zero)
    dw = torch.where(tri[..., None],
                     torch.einsum("bcihp,bcjhp->bcijh", gyc, xw), zero)
    dxw = torch.einsum("bcijh,bcihp->bcjhp", w, gyc)
    dscores = (dw * decay).sum(-1)                         # [b,nc,i,j]
    dC = torch.einsum("bcij,bcjn->bcin", dscores, Bc)
    dB = torch.einsum("bcij,bcin->bcjn", dscores, Cc)
    g = torch.where(below[..., None] & (u <= 0.0), dw * w, zero)
    dcum = g.sum(3) - g.sum(2)                             # [b,nc,q,h]

    # 3. inter-chunk, in reverse
    t1 = torch.einsum("bcihp,bchpn->bcihn", gyc, hp)       # h_prev^T gy_i
    dC = dC + torch.einsum("bcih,bcihn->bcin", e, t1)
    dcum = dcum + e * torch.einsum("bcihn,bcin->bcih", t1, Cc)
    dh = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
          if gstate is None else gstate.to(f32))
    after = [None] * nc
    for c in reversed(range(nc)):
        after[c] = dh
        dh = dh * gamma[:, c, :, None, None] + torch.einsum(
            "bih,bihp,bin->bhpn", e[:, c], gyc[:, c], Cc[:, c])
    dh_after = torch.stack(after, dim=1)                   # [b,nc,h,p,n]
    dseg = torch.einsum("bchpn,bchpn->bch", dh_after, hp) * gamma
    t2 = torch.einsum("bchpn,bcjhp->bcjhn", dh_after, xw)  # dh^T xw_j
    dB = dB + torch.einsum("bcjh,bcjhn->bcjn", sd, t2)
    dxw = dxw + sd[..., None] * torch.einsum("bchpn,bcjn->bcjhp", dh_after,
                                             Bc)
    dsd = torch.einsum("bcjhn,bcjn->bcjh", t2, Bc) * sd
    dseg = dseg + dsd.sum(2)
    dcum = dcum - dsd
    dcum[:, :, -1, :] += dseg

    # 4. through the cumsum, dt weighting and the skip
    dA = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = dA * a32 + (dxw * xc).sum(-1)
    da = (dA * dtc).sum((0, 1, 2))
    dx = dxw * dtc[..., None]
    dskip = None
    if skip is not None:
        dx = dx + skip[:, None] * gyc
        dskip = (xc * gyc).sum((0, 1, 2, 4)).to(d_skip.dtype)
    dh0 = None if initial_state is None else dh.to(initial_state.dtype)
    rows = nc * q

    def cut(t, shape):
        return t.reshape((b, rows) + shape)[:, :s]

    return (cut(dx, (h, p)).to(x.dtype), cut(ddt, (h,)).to(dt.dtype),
            da.to(a.dtype), cut(dB, (n,)).to(B.dtype),
            cut(dC, (n,)).to(C.dtype), dskip, dh0)


def ssd_bwd_model(x, dt, a, B, C, d_skip=None, initial_state=None, gy=None,
                  gstate=None, chunk: int = 64):
    """Test-only plain model of the bfloat16 tensor-core backward
    (``csrc/ssd_scan_bwd.cu``: ``ssd_bwd_walk_tc`` then
    ``ssd_bwd_chunk_tc``): the gradient of ``ssd_chunked`` with every
    product's operands rounded to x's type exactly where the kernel rounds
    them (r: to x's type and back), each product and sum in float32.  Same
    arguments and returns as ``ssd_chunked_bwd``.

    - The walks (one product a chunk): h = h exp(cum_Q) + r(B exp(cum_Q -
      cum) dt)^T x and dh = dh exp(cum_Q) + r(C exp(cum))^T gy, carried in
      float32 from the warm start rounded to x's type (zeros) and gstate;
      the state entering each chunk and the gradient of the one leaving it
      are kept rounded (the chunk products' operands); dh after chunk 0 is
      the warm start's gradient.
    - Per chunk, x dt in float32 (x and gy are the products' operands, dt
      scales their float32 results): the scores, dw = gy (x dt)^T, the
      decays, w, the clamp's share dw x w, dS = dw x decay; dC = r(dS) B +
      exp(cum) gy r(h) and dB = r(dS)^T C + exp(cum_Q - cum) (x dt) r(dh),
      summed over the heads, with their dcum shares; d(xw) = r(w)^T gy +
      exp(cum_Q - cum) B r(dh)^T; <r(dh), r(h)> exp(cum_Q) for the
      chunk's decay, whose share of the state decay's dcum enters dA as
      the sum before each position (the same sum as ``ssd_chunked_bwd``'s
      reverse cumsum of dseg at the last position, without its
      cancellation)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    dtype = x.dtype
    f32 = torch.float32
    q = chunk
    pad = (-s) % q
    if gy is None:
        gy = torch.zeros((b, s, h, p), dtype=dtype, device=x.device)
    if pad:
        x, dt, B, C, gy = (_pad_seq(t, pad) for t in (x, dt, B, C, gy))
    nc = (s + pad) // q

    def rnd(t):
        return t.to(dtype).to(f32)

    xc = x.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    Bc = B.reshape(b, nc, q, n).to(f32)
    Cc = C.reshape(b, nc, q, n).to(f32)
    gyc = rnd(gy.reshape(b, nc, q, h, p).to(f32))
    a32 = a.to(f32)
    cum = torch.cumsum(dtc * a32, dim=2)                   # [b,nc,q,h]
    seg = cum[:, :, -1, :]
    gamma = torch.exp(seg)
    xw = xc * dtc[..., None]
    e = torch.exp(cum)
    sd = torch.exp(seg[:, :, None, :] - cum)

    hp, dha, dh = _model_walks(xc, dtc, Bc, Cc, gyc, e, sd, gamma,
                               initial_state, gstate, dtype)

    # the chunks
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    below = torch.tril(tri, -1)
    zero = torch.zeros((), dtype=f32, device=x.device)
    u = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [b,nc,i,j,h]
    decay = torch.exp(torch.clamp_max(u, 0.0))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = torch.where(tri[..., None], scores[..., None] * decay, zero)
    dw = torch.where(tri[..., None],
                     torch.einsum("bcihp,bcjhp->bcijh", gyc, xw), zero)
    ds = rnd(dw * decay)
    g = torch.where(below[..., None] & (u <= 0.0), dw * w, zero)
    t1 = torch.einsum("bcihp,bchpn->bcihn", gyc, hp)
    t2 = torch.einsum("bcjhp,bchpn->bcjhn", xw, dha)
    dC = (torch.einsum("bcijh,bcjn->bcin", ds, Bc)
          + torch.einsum("bcih,bcihn->bcin", e, t1))
    dB = (torch.einsum("bcijh,bcin->bcjn", ds, Cc)
          + torch.einsum("bcjh,bcjhn->bcjn", sd, t2))
    de = e * torch.einsum("bcihn,bcin->bcih", t1, Cc)
    dsd = sd * torch.einsum("bcjhn,bcjn->bcjh", t2, Bc)
    dxw = (torch.einsum("bcijh,bcihp->bcjhp", rnd(w), gyc)
           + sd[..., None] * torch.einsum("bcjn,bchpn->bcjhp", Bc, dha))
    # dA: the reverse cumsum of dcum but the state decay's share dsd, plus
    # the chunk decay's <dh, h> exp(cum_Q), plus the sum of dsd before each
    # position (dseg's sum of every dsd less the reverse cumsum of dsd,
    # without the cancellation)
    hg = torch.einsum("bchpn,bchpn->bch", dha, hp) * gamma
    dcum = g.sum(3) - g.sum(2) + de
    before = torch.cat([torch.zeros_like(dsd[:, :, :1]),
                        torch.cumsum(dsd, dim=2)[:, :, :-1]], dim=2)
    dA = (torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
          + before + hg[:, :, None, :])
    ddt = dA * a32 + (dxw * xc).sum(-1)
    da = (dA * dtc).sum((0, 1, 2))
    dx = dxw * dtc[..., None]
    dskip = None
    if d_skip is not None:
        dx = dx + d_skip.to(f32)[:, None] * gyc
        dskip = (xc * gyc).sum((0, 1, 2, 4)).to(d_skip.dtype)
    dh0 = None if initial_state is None else dh.to(initial_state.dtype)
    rows = nc * q

    def cut(t, shape):
        return t.reshape((b, rows) + shape)[:, :s]

    return (cut(dx, (h, p)).to(x.dtype), cut(ddt, (h,)).to(dt.dtype),
            da.to(a.dtype), cut(dB, (n,)).to(B.dtype),
            cut(dC, (n,)).to(C.dtype), dskip, dh0)


def _model_walks(xc, dtc, Bc, Cc, gyc, e, sd, gamma, initial_state, gstate,
                 dtype):
    """``ssd_bwd_model``'s walks from its chunked float32 inputs (xc, gyc
    [b,nc,q,h,p], dtc, e = exp(cum), sd = exp(cum_Q - cum) [b,nc,q,h], Bc,
    Cc [b,nc,q,n], gamma [b,nc,h]): (the states entering each chunk, the
    gradients of those leaving it, both rounded to ``dtype`` [b,nc,h,p,n];
    dh after chunk 0 in float32)."""
    b, nc, _, h, p = xc.shape
    n = Bc.shape[-1]
    f32 = torch.float32

    def rnd(t):
        return t.to(dtype).to(f32)

    b_w = rnd(Bc[:, :, :, None, :] * (sd * dtc)[..., None])  # [b,nc,q,h,n]
    c_w = rnd(Cc[:, :, :, None, :] * e[..., None])
    h_chunk = torch.einsum("bcjhn,bcjhp->bchpn", b_w, xc)
    d_chunk = torch.einsum("bcihn,bcihp->bchpn", c_w, gyc)
    hcar = (torch.zeros((b, h, p, n), dtype=f32, device=xc.device)
            if initial_state is None else rnd(initial_state.to(f32)))
    hs = []
    for c in range(nc):
        hs.append(rnd(hcar))
        hcar = hcar * gamma[:, c, :, None, None] + h_chunk[:, c]
    dh = (torch.zeros((b, h, p, n), dtype=f32, device=xc.device)
          if gstate is None else gstate.to(f32))
    dhs = [None] * nc
    for c in reversed(range(nc)):
        dhs[c] = rnd(dh)
        dh = dh * gamma[:, c, :, None, None] + d_chunk[:, c]
    return torch.stack(hs, dim=1), torch.stack(dhs, dim=1), dh


def ssd_scan_model(x, dt, a, B, C, d_skip=None, initial_state=None,
                   chunk: int = 64):
    """Test-only plain model of ``csrc/ssd_scan.cu`` (the bfloat16
    tensor-core kernel; in float32 the same sums): per chunk, x dt, w, C
    exp(cum), B exp(cum_Q - cum) and h rounded to x's type where the
    reference casts; the two y products summed in ONE float32 sum over
    their K = Q + N terms (the kernel's shared accumulator, where the
    reference adds two float32 sums); h carried in float32 and scaled by
    exp(cum_Q) before its product is added; a warm start [B,H,P,N] is
    rounded to x's type first.  Returns (y [B,S,H,P] in x's type, final
    state [B,H,P,N] float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    dtype = x.dtype
    pad = (-s) % chunk
    if pad:
        x, dt, B, C = (_pad_seq(t, pad) for t in (x, dt, B, C))
    nc = (s + pad) // chunk
    f32 = torch.float32

    def rnd(t):
        return t.to(dtype).to(f32)

    xc = x.reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).permute(0, 3, 1, 2).to(f32)
    Bc = B.reshape(b, 1, nc, chunk, n).to(f32)
    Cc = C.reshape(b, 1, nc, chunk, n).to(f32)
    skip = (torch.zeros(h) if d_skip is None else d_skip).to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    hs = (torch.zeros((b, h, n, p), dtype=f32) if initial_state is None
          else rnd(initial_state.to(f32)).transpose(-1, -2))
    ys = []
    for c in range(nc):
        dtk = dtc[:, :, c]                                     # [b,h,q]
        cum = torch.cumsum(dtk * a.to(f32)[None, :, None], -1)
        seg = cum[..., -1:]
        xw = rnd(xc[:, :, c] * rnd(dtk)[..., None])            # [b,h,q,p]
        scores = Cc[:, :, c] @ Bc[:, :, c].transpose(-1, -2)   # [b,h,q,q]
        decay = torch.exp(torch.clamp_max(cum[..., :, None] - cum[..., None, :],
                                          0.0))
        w = rnd(torch.where(tri, scores * decay, torch.zeros(())))
        c_in = rnd(Cc[:, :, c] * rnd(torch.exp(cum))[..., None])
        y = torch.cat([w, c_in], -1) @ torch.cat([xw, rnd(hs)], -2)
        b_w = rnd(Bc[:, :, c] * rnd(torch.exp(seg - cum))[..., None])
        hs = hs * torch.exp(seg)[..., None] + b_w.transpose(-1, -2) @ xw
        ys.append(y + xc[:, :, c] * skip[None, :, None, None])
    y = torch.stack(ys, 2).permute(0, 2, 3, 1, 4).reshape(b, nc * chunk, h, p)
    return y[:, :s].to(dtype), hs.transpose(-1, -2)


def ssd_update(
    state: torch.Tensor,
    x_t: torch.Tensor,
    dt_t: torch.Tensor,
    a: torch.Tensor,
    B_t: torch.Tensor,
    C_t: torch.Tensor,
    d_skip: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  state [B,H,P,N], x_t [B,H,P], dt_t [B,H], B_t/C_t [B,N].
    Returns (new_state, y [B,H,P])."""
    dt_t = dt_t.to(torch.float32)
    g = torch.exp(dt_t * a.to(torch.float32))       # [B,H]
    state = state * g[..., None, None].to(state.dtype) + torch.einsum(
        "bn,bh,bhp->bhpn", B_t, dt_t.to(x_t.dtype), x_t)
    y = torch.einsum("bn,bhpn->bhp", C_t, state)
    if d_skip is not None:
        y = y + d_skip[None, :, None].to(y.dtype) * x_t
    return state, y
