"""Roofline terms of a step on NVIDIA H100 SXM cards.

The counterpart of the reference's ``launch/roofline.py``, with the
H100's constants in place of the TPU's (NVIDIA's data sheet, SXM part,
dense rates, at the 700 W limit):

  peak compute   989 TFLOP/s bf16 (tensor cores) per card
  HBM bandwidth  3.35 TB/s per card
  NVLink 4       450 GB/s per card, one direction

Terms, as in the reference:
  compute    = FLOPs_global      / (cards * peak)
  memory     = HBM_bytes_global  / (cards * hbm_bw)
  collective = collective_bytes  / link_bw          (a card's own bytes)

``analytic_cost`` and ``model_flops_for`` are the reference's formulas on
the port's ``ModelConfig`` and ``ShapeCell``.  ``collective_stats`` reads
the bytes the port's collectives counted in this process
(``launch/mesh.collectives``) into the reference's schema.  There is no
compiled HLO to parse, so the reference's ``_split_computations`` and
``_trip_counts`` (loop bodies weighted by their trip counts) have no
counterpart: the counters see every call as it runs.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAK_FLOPS = 989e12       # H100 SXM, dense bf16
HBM_BW = 3.35e12          # H100 SXM
LINK_BW = 450e9           # H100 SXM, NVLink 4, one direction

#: the port's collectives (``launch/mesh.py``) by the reference's kinds:
#: the host gather is every rank's block broadcast to all, an all-gather
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "gather": "all-gather"}


def collective_stats(counters: Optional[Dict[str, Dict[str, float]]] = None
                     ) -> Dict[str, Dict[str, float]]:
    """A rank's collective bytes, ``{kind: {count, operand_bytes,
    ring_bytes}}`` as the reference's: ``counters`` is
    ``launch.mesh.collectives`` (the default), read as they stand (reset
    them before the step to be measured).  The ring model is the
    reference's: an all-reduce moves 2(g-1)/g of its operand, an
    all-gather (g-1)/g of its result."""
    if counters is None:
        from repro_torch.launch.mesh import collectives as counters
    out: Dict[str, Dict[str, float]] = {}
    for name, c in counters.items():
        slot = out.setdefault(_KINDS[name], {"count": 0, "operand_bytes": 0.0,
                                             "ring_bytes": 0.0})
        slot["count"] += c["calls"]
        slot["operand_bytes"] += c["bytes"]
        slot["ring_bytes"] += c["ring_bytes"]
    return out


# --------------------------------------------------------- analytic model


def analytic_cost(cfg, shape, microbatches: int = 1) -> Dict[str, float]:
    """Global per-step FLOPs and HBM bytes from first principles.

    FLOPs: 2*tokens*N_matmul per forward; train multiplies by 4 for bwd and
    adds a full recompute forward under remat (total x8).  Attention adds the
    quadratic term, SSD adds the chunked-scan terms, MoE counts only routed
    (active) experts.  HBM bytes: weight streaming per microbatch + optimizer
    state traffic + activation traffic + (decode) KV/state cache traffic.
    """
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    tokens = b * (1 if kind == "decode" else s)
    d = cfg.d_model

    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    n_matmul = n_active - cfg.vocab * d          # embed gather isn't a matmul

    fwd_mult = 2.0
    if kind == "train":
        total_mult = 6.0 + (2.0 if cfg.remat == "full" else 0.0)
    else:
        total_mult = 2.0

    flops = tokens * n_matmul * total_mult

    # attention quadratic term
    if cfg.n_heads:
        if cfg.block == "zamba":
            attn_layers = cfg.n_layers // cfg.shared_attn_every
        else:
            attn_layers = cfg.n_layers
        ctx = s
        causal = 0.5 if (cfg.causal and kind != "decode") else 1.0
        if kind == "decode":
            per_layer = 4.0 * b * ctx * cfg.n_heads * cfg.hd
        else:
            per_layer = 4.0 * b * s * ctx * cfg.n_heads * cfg.hd * causal
        flops += attn_layers * per_layer * (total_mult / fwd_mult)

    # SSD terms (mamba/zamba)
    if cfg.block in ("mamba", "zamba"):
        di, n_state, q = cfg.d_inner, cfg.ssm_state, 64
        if kind == "decode":
            per_layer = 4.0 * b * n_state * di
        else:
            per_layer = (2.0 * b * s * q * di + 2.0 * b * s * q * n_state
                         + 4.0 * b * s * n_state * di)
        flops += cfg.n_layers * per_layer * (total_mult / fwd_mult)

    # ---- HBM bytes ----------------------------------------------------------
    act_token_bytes = 2  # bf16 activations
    if kind == "train":
        micro = max(microbatches, 1)
        weight_traffic = micro * 3 * 2 * n_total        # stream bf16 weights
        opt_traffic = 6 * 4 * n_total                   # p,m,v read+write f32
        act_traffic = cfg.n_layers * tokens * d * act_token_bytes * 25
        hbm = weight_traffic + opt_traffic + act_traffic
    elif kind == "prefill":
        hbm = 2 * n_total + cfg.n_layers * tokens * d * act_token_bytes * 10
    else:  # decode
        hbm = 2 * n_total + cfg.n_layers * b * d * act_token_bytes * 10
        if cfg.n_heads:
            attn_layers = (cfg.n_layers // cfg.shared_attn_every
                           if cfg.block == "zamba" else cfg.n_layers)
            hbm += 2 * attn_layers * b * s * cfg.kv_heads * cfg.hd * 2  # KV read
        if cfg.block in ("mamba", "zamba"):
            hbm += 2 * cfg.n_layers * b * cfg.ssm_heads * cfg.ssm_head_dim \
                * cfg.ssm_state * 4 * 2  # SSM state read+write f32
    return {"flops_global": flops, "hbm_bytes_global": float(hbm)}


def roofline_terms(
    analytic: Dict[str, float],
    coll: Dict[str, Dict[str, float]],
    n_chips: int,
    model_flops: float,
    raw_cost: Dict[str, float],
) -> Dict[str, float]:
    """The three time terms on ``n_chips`` cards, the dominant one, and the
    compute term's share of the largest (the reference's keys;
    ``raw_cost`` is carried as given)."""
    operand = sum(v["operand_bytes"] for v in coll.values())
    ring = sum(v["ring_bytes"] for v in coll.values())
    flops_global = analytic["flops_global"]
    bytes_global = analytic["hbm_bytes_global"]
    terms = {
        "compute_s": flops_global / (n_chips * PEAK_FLOPS),
        "memory_s": bytes_global / (n_chips * HBM_BW),
        "collective_s": operand / LINK_BW,
        "collective_ring_s": ring / LINK_BW,
        "flops_global": flops_global,
        "hbm_bytes_global": bytes_global,
        "collective_operand_bytes_per_dev": operand,
        "collective_ring_bytes_per_dev": ring,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / flops_global if flops_global else 0.0,
        "raw_cost_analysis": raw_cost,
    }
    dom = max(("compute_s", "memory_s", "collective_ring_s"),
              key=lambda k: terms[k])
    terms["dominant"] = {"compute_s": "compute", "memory_s": "memory",
                         "collective_ring_s": "collective"}[dom]
    bound = max(terms["compute_s"], terms["memory_s"],
                terms["collective_ring_s"])
    # fraction of the step spent at the compute roofline if perfectly
    # overlapped: compute_term / max(all terms)
    terms["roofline_fraction"] = terms["compute_s"] / bound if bound else 0.0
    return terms


def model_flops_for(cfg, shape) -> float:
    """Analytic 'useful' FLOPs per step: 6*N*D train, 2*N*D prefill,
    2*N*B decode (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
