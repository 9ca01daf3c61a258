"""Model assembly: param defs, forward, loss, prefill and one-token decode
for every family of the reference package's ``models/model.py`` (dense,
MoE, SSM, hybrid, the audio encoder and the vision-language model).

Parameters are a plain dictionary; ``params["layers"]`` is a list with one
dictionary per block (the reference stacks them on a leading axis for
``lax.scan``; ``params_from_numpy`` splits such stacked leaves).  The zamba
(hybrid) family runs groups of ``shared_attn_every`` mamba blocks with a
single weight-tied attention block applied after each group.  The decode
cache keeps the reference's stacked layout ([n_layers, ...] per leaf) and
``decode_step`` updates it in place.

``kernels=False`` runs the plain versions of the attention and SSD kernels
(forward and backward) on any device: the comparison path.

Training: ``loss_fn`` is the reference's chunked cross-entropy, each
chunk's head product and logsumexp recomputed in the backward
(``torch.utils.checkpoint``), so [B,S,V] logits are never held.  Under
autograd ``cfg.remat == "full"`` checkpoints every block and
``cfg.remat_group`` (attn/moe families) checkpoints groups of G blocks
around that (sqrt-remat), as the reference's ``jax.checkpoint``s do;
without a graph (serving) nothing is checkpointed.  Gradients reach the
float32 masters through ``cast_params``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, ParamDef, init_tree,
                                       map_tree, spec_tree)

# ------------------------------------------------------------- definitions


def _block_defs(cfg: ModelConfig):
    if cfg.block == "attn":
        return {
            "ln1": L.rmsnorm_defs(cfg.d_model),
            "attn": L.attention_defs(cfg),
            "ln2": L.rmsnorm_defs(cfg.d_model),
            "ffn": L.ffn_defs(cfg, gated=not cfg.is_encoder),
        }
    if cfg.block == "moe":
        return {
            "ln1": L.rmsnorm_defs(cfg.d_model),
            "attn": L.attention_defs(cfg),
            "ln2": L.rmsnorm_defs(cfg.d_model),
            "moe": L.moe_defs(cfg),
        }
    if cfg.block in ("mamba", "zamba"):
        return {
            "ln": L.rmsnorm_defs(cfg.d_model),
            "mamba": L.mamba_defs(cfg),
        }
    raise ValueError(cfg.block)


def _stacked_scale(defs, n_layers: int):
    """A block's defs drawn at the reference's scale.  The reference stacks
    them on a leading ``[n_layers]`` axis, and its ``materialize`` takes
    that axis as the fan-in of every leaf, so a ``"normal"`` leaf without
    an explicit scale is drawn at ``n_layers ** -0.5``.  The port keeps the
    blocks as a list, so the scale is set here, leaf by leaf."""
    return map_tree(
        lambda d: ParamDef(d.shape, d.logical, scale=n_layers ** -0.5)
        if d.init == "normal" and d.scale is None else d, defs)


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    block = _stacked_scale(_block_defs(cfg), cfg.n_layers)
    defs: Dict[str, Any] = {
        # vocab-sharded only, as in the reference
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", None),
                          scale=1.0),
        "final_norm": L.rmsnorm_defs(cfg.d_model),
        "head": ParamDef((cfg.d_model, cfg.vocab), ("fsdp", "vocab")),
        "layers": [block] * cfg.n_layers,
    }
    if cfg.frontend != "none":
        defs["frontend"] = {"proj": ParamDef((cfg.frontend_dim, cfg.d_model),
                                             ("fsdp", None))}
    if cfg.block == "zamba":
        defs["shared"] = {
            "ln1": L.rmsnorm_defs(cfg.d_model),
            "attn": L.attention_defs(cfg),
            "ln2": L.rmsnorm_defs(cfg.d_model),
            "ffn": L.ffn_defs(cfg, gated=True),
        }
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32):
    """Seeded random weights on the generator's device (a CUDA generator,
    ``torch.Generator(device="cuda").manual_seed(0)``, makes them on the
    card).  Other numbers than the reference's ``jax.random`` gives for the
    same seed; ``params_from_numpy`` carries the reference's weights."""
    return init_tree(model_defs(cfg), generator, dtype)


def _leaf_paths(defs, prefix=""):
    """(reference path string, port path) of every ParamDef; a list level
    (stacked blocks) adds nothing to the reference path."""
    if isinstance(defs, dict):
        for k in defs:
            yield from ((p, (k,) + q) for p, q in
                        _leaf_paths(defs[k], f"{prefix}['{k}']"))
    elif isinstance(defs, list):
        yield from ((p, (None,) + q) for p, q in _leaf_paths(defs[0], prefix))
    else:
        yield prefix, ()


def params_from_numpy(cfg: ModelConfig, leaves: Mapping[str, np.ndarray],
                      device=None):
    """The port's parameters from the reference's: ``leaves`` maps the
    reference parameter tree's path strings (``jax.tree_util.keystr``, the
    keys its checkpoints use, e.g. ``['layers']['mamba']['in_z']``) to
    numpy arrays.  Stacked ``[n_layers, ...]`` leaves are split into the
    per-block dictionaries.  Raises on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)
    defs = model_defs(cfg)
    want = {}
    for key, path in _leaf_paths(defs):
        node = defs
        for k in path:
            node = node[0] if k is None else node[k]
        shape = ((cfg.n_layers,) if None in path else ()) + node.shape
        want[key] = (path, shape)
    missing = sorted(set(want) - set(leaves))
    extra = sorted(set(leaves) - set(want))
    if missing or extra:
        raise ValueError(f"parameter leaves missing: {missing}; "
                         f"unexpected: {extra}")
    params = map_tree(lambda d: None, defs)
    params["layers"] = [map_tree(lambda d: None, _block_defs(cfg))
                        for _ in range(cfg.n_layers)]
    for key, (path, shape) in want.items():
        arr = np.asarray(leaves[key])
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {key} has shape {tuple(arr.shape)}, "
                             f"expected {shape}")
        if None in path:
            for i in range(cfg.n_layers):
                node = params["layers"][i]
                for k in path[2:-1]:
                    node = node[k]
                node[path[-1]] = torch.tensor(arr[i], device=dev)
        else:
            node = params
            for k in path[:-1]:
                node = node[k]
            node[path[-1]] = torch.tensor(arr, device=dev)
    return params


def train_state_from_numpy(cfg: ModelConfig,
                           leaves: Mapping[str, np.ndarray], device=None):
    """The port's ``launch.steps.TrainState`` from the reference's: ``leaves``
    maps the reference train state's path strings (the keys of its
    checkpoints: ``.params[...]``, ``.opt.m[...]``, ``.opt.v[...]`` and
    ``.opt.step``) to numpy arrays; stacked leaves are split into the
    per-block dictionaries as ``params_from_numpy`` does.  Raises on a
    missing, extra or misshapen leaf."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim import OptState

    dev = resolve_device(device)
    parts = {".params": {}, ".opt.m": {}, ".opt.v": {}}
    step = None
    for key, arr in leaves.items():
        if key == ".opt.step":
            step = arr
            continue
        prefix = next((p for p in parts if key.startswith(p + "[")), None)
        if prefix is None:
            raise ValueError(f"unexpected train-state leaf {key!r}")
        parts[prefix][key[len(prefix):]] = arr
    if step is None:
        raise ValueError("train-state leaf '.opt.step' missing")
    if np.shape(step) != ():
        raise ValueError(f"leaf .opt.step has shape {np.shape(step)}, "
                         "expected ()")
    params, m, v = (params_from_numpy(cfg, parts[p], dev) for p in parts)
    return TrainState(params, OptState(m, v, torch.tensor(
        int(step), dtype=torch.int32, device=dev)))


def param_specs(cfg: ModelConfig):
    """The parameter tree's logical axes, in the port's layout: a block's
    leaves carry the reference's axes without its stacked ``"layers"``
    axis (always replicated)."""
    return spec_tree(model_defs(cfg))


def param_shapes(cfg: ModelConfig, dtype=torch.float32):
    """The parameter tree as ``device="meta"`` tensors (shapes and dtype, no
    storage), in the port's layout: ``layers`` a list of per-block dicts."""
    return map_tree(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                    model_defs(cfg))


def cast_params(params, dtype):
    """Float32 weights cast to the compute dtype (others as they are).  A
    step casts once when it is built; the layers' own casts are then
    no-ops."""
    return map_tree(
        lambda w: w.to(dtype) if w.dtype == torch.float32 else w, params)


# ----------------------------------------------------------------- blocks


def _attn_block(p, x, cfg: ModelConfig, kernels: bool):
    h, _ = L.attention_apply(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                             cfg, kernels=kernels)
    x = x + h
    fn = L.moe_apply if "moe" in p else L.ffn_apply
    return x + fn(p["moe" if "moe" in p else "ffn"],
                  L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)


def _mamba_block(p, x, cfg: ModelConfig, kernels: bool):
    h, _ = L.mamba_apply(p["mamba"], L.rmsnorm(p["ln"], x, cfg.norm_eps),
                         cfg, kernels=kernels)
    return x + h


def _maybe_remat(fn, cfg: ModelConfig):
    if cfg.remat == "full":
        return _remat(fn)
    return fn


def _remat(fn):
    """``fn(p, x)`` recomputed in the backward instead of keeping its
    activations (``jax.checkpoint``), when autograd records a graph."""
    def wrapped(p, x):
        if torch.is_grad_enabled() and x.requires_grad:
            return checkpoint(fn, p, x, use_reentrant=False)
        return fn(p, x)
    return wrapped


# ---------------------------------------------------------------- forward


def _embed_inputs(params, cfg: ModelConfig, batch, dtype):
    """Token / frontend embedding.  batch keys: tokens [B,S] and/or
    frames|patches [B,P,F] (stub modality embeddings): audio frames replace
    the token embedding, vision patches overwrite its first P positions."""
    if cfg.frontend == "audio":
        return torch.matmul(batch["frames"].to(dtype),
                            params["frontend"]["proj"].to(dtype))
    x = params["embed"].to(dtype)[batch["tokens"].long()]
    if cfg.frontend == "vision" and "patches" in batch:
        pe = torch.matmul(batch["patches"].to(dtype),
                          params["frontend"]["proj"].to(dtype))
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def forward_hidden(params, cfg: ModelConfig, batch, dtype=torch.bfloat16, *,
                   kernels: bool = True):
    """Full-sequence forward up to the final norm -> hidden [B,S,D]."""
    params = cast_params(params, dtype)
    x = _embed_inputs(params, cfg, batch, dtype)
    afn = _maybe_remat(lambda lp, h: _attn_block(lp, h, cfg, kernels), cfg)
    mfn = _maybe_remat(lambda lp, h: _mamba_block(lp, h, cfg, kernels), cfg)
    if cfg.block in ("attn", "moe"):
        g = cfg.remat_group
        if g and cfg.scan_layers and cfg.n_layers % g == 0:
            # sqrt-remat: only the L/G group inputs are kept; each group
            # recomputes its G block inputs during its backward
            def group_fn(gp, h):
                for lp in gp:
                    h = afn(lp, h)
                return h

            group_fn = _remat(group_fn)
            for i in range(0, cfg.n_layers, g):
                x = group_fn(params["layers"][i:i + g], x)
        else:
            for lp in params["layers"]:
                x = afn(lp, x)
    elif cfg.block == "mamba":
        for lp in params["layers"]:
            x = mfn(lp, x)
    elif cfg.block == "zamba":
        k = cfg.shared_attn_every
        for g in range(cfg.n_layers // k):
            for lp in params["layers"][g * k:(g + 1) * k]:
                x = mfn(lp, x)
            x = afn(params["shared"], x)  # weight-tied
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, batch, dtype=torch.bfloat16,
            last_only: bool = False, *, kernels: bool = True):
    """Full-sequence forward -> logits [B,S,V] (or [B,1,V] for serving
    prefill, which only needs the next-token distribution)."""
    x = forward_hidden(params, cfg, batch, dtype, kernels=kernels)
    if last_only:
        x = x[:, -1:]
    return torch.matmul(x, params["head"].to(dtype))


def loss_fn(params, cfg: ModelConfig, batch, dtype=torch.bfloat16,
            ce_chunk: int = 512, *, kernels: bool = True):
    """Mean next-token (decoder) or masked-unit (encoder) cross-entropy.

    The head product and logsumexp run in sequence chunks, each recomputed
    in the backward, so the [B,S,V] logits tensor is never materialized."""
    x = forward_hidden(params, cfg, batch, dtype, kernels=kernels)  # [B,S,D]
    labels = batch["labels"].long()
    b, s, d = x.shape
    chunk = min(ce_chunk, s)
    n = s // chunk
    head = params["head"].to(dtype)

    def one(xc, yc, w):                                    # [B,C,D], [B,C]
        logits = torch.matmul(xc, w).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        return torch.sum(logz - gold)

    def part(xc, yc):
        if torch.is_grad_enabled() and (xc.requires_grad or head.requires_grad):
            return checkpoint(one, xc, yc, head, use_reentrant=False)
        return one(xc, yc, head)

    if n * chunk == s and n > 1:
        total = torch.sum(torch.stack([
            part(x[:, i * chunk:(i + 1) * chunk],
                 labels[:, i * chunk:(i + 1) * chunk]) for i in range(n)]))
    else:
        total = part(x, labels)
    return total / (b * s)


# ------------------------------------------------------------ decode state


def cache_defs(cfg: ModelConfig, batch: int, max_len: int):
    """ParamDef tree for the decode cache (zeros), in the reference's stacked
    layout."""
    hkv, hd = cfg.kv_heads, cfg.hd
    di, n, h, p_, w = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_head_dim, cfg.ssm_conv)

    def kv(n_layers):
        # fused head*dim axis, as in the reference: always divisible by the
        # model axis
        axes = ("layers", "batch", "kv_seq", "tp")
        return {"k": ParamDef((n_layers, batch, max_len, hkv * hd), axes,
                              init="zeros"),
                "v": ParamDef((n_layers, batch, max_len, hkv * hd), axes,
                              init="zeros")}

    def mamba_state(n_layers):
        return {
            "conv_x": ParamDef((n_layers, batch, w - 1, di),
                               ("layers", "batch", None, "tp"), init="zeros"),
            "conv_b": ParamDef((n_layers, batch, w - 1, n),
                               ("layers", "batch", None, None), init="zeros"),
            "conv_c": ParamDef((n_layers, batch, w - 1, n),
                               ("layers", "batch", None, None), init="zeros"),
            "ssm": ParamDef((n_layers, batch, h, p_, n),
                            ("layers", "batch", "tp", None, None),
                            init="zeros"),
        }

    if cfg.block in ("attn", "moe"):
        return kv(cfg.n_layers)
    if cfg.block == "mamba":
        return mamba_state(cfg.n_layers)
    if cfg.block == "zamba":
        groups = cfg.n_layers // cfg.shared_attn_every
        return {"mamba": mamba_state(cfg.n_layers), "shared": kv(groups)}
    raise ValueError(cfg.block)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    return map_tree(lambda d: torch.zeros(d.shape, dtype=dtype, device=dev),
                    cache_defs(cfg, batch, max_len))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """The decode cache's logical axes, in its stacked layout."""
    return spec_tree(cache_defs(cfg, batch, max_len))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16):
    """The decode cache as ``device="meta"`` tensors, in ``init_cache``'s
    stacked layout; nothing is allocated."""
    return map_tree(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                    cache_defs(cfg, batch, max_len))


# ---------------------------------------------------------------- decode


def _mamba_block_decode(p, x, st, i, cfg):
    """Block ``i`` of the mamba stack; its cache rows are updated in place."""
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    names = ("conv_x", "conv_b", "conv_c", "ssm")
    h, new = L.mamba_decode(p["mamba"], h, tuple(st[k][i] for k in names),
                            cfg)
    for k, v in zip(names, new):
        st[k][i].copy_(v)
    return x + h


def _attn_block_decode(p, x, kv, i, pos, cfg, kernels):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    h, _, _ = L.attention_decode(p["attn"], h, kv["k"][i], kv["v"][i], pos,
                                 cfg, kernels=kernels)
    x = x + h
    fn = L.moe_apply if "moe" in p else L.ffn_apply
    return x + fn(p["moe" if "moe" in p else "ffn"],
                  L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)


def decode_step(params, cache, cfg: ModelConfig, tokens, pos,
                dtype=torch.bfloat16, *, kernels: bool = True):
    """One decode step.  tokens [B,1] integer; pos an int, a 0-d tensor
    (current length) or a [B] int32 tensor of per-slot positions.  Returns
    (logits [B,1,V], cache), the cache updated in place."""
    params = cast_params(params, dtype)
    x = params["embed"].to(dtype)[tokens.long()]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if cfg.block in ("attn", "moe"):
        for i, lp in enumerate(params["layers"]):
            x = _attn_block_decode(lp, x, cache, i, pos, cfg, kernels)
    elif cfg.block == "mamba":
        for i, lp in enumerate(params["layers"]):
            x = _mamba_block_decode(lp, x, cache, i, cfg)
    elif cfg.block == "zamba":
        k = cfg.shared_attn_every
        for g in range(cfg.n_layers // k):
            for i in range(g * k, (g + 1) * k):
                x = _mamba_block_decode(params["layers"][i], x,
                                        cache["mamba"], i, cfg)
            x = _attn_block_decode(params["shared"], x, cache["shared"], g,
                                   pos, cfg, kernels)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return torch.matmul(x, params["head"].to(dtype)), cache
