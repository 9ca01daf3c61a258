"""Model configuration and parameter templates.

Plain-dictionary module system, as in the reference package: every layer
is a ``*_defs(cfg)`` function returning a tree of ``ParamDef`` plus an
``*_apply(p, x, ...)`` function on tensors.  The reference's logical
sharding axes and its ``shard`` constraints are TPU-mesh code and wait
for ROADMAP.md queue A, item A.5; a ``ParamDef`` here is a shape and an
initializer.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# ---------------------------------------------------------------- config


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                  # 0 => attention-free (pure SSM)
    kv_heads: int
    d_ff: int                     # dense FFN hidden (0 => no FFN in blocks)
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    # block pattern
    block: str = "attn"           # attn | moe | mamba | zamba (mamba + shared attn)
    shared_attn_every: int = 6    # zamba: shared attention block period
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # attention details
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # chatglm: 0.5 (rotary on half the head dim)
    causal: bool = True           # False => encoder (hubert)
    # modality frontend stub
    frontend: str = "none"        # none | audio | vision
    frontend_dim: int = 0         # stub embedding feature dim
    norm_eps: float = 1e-5
    # serving knobs (overridable per shape cell)
    seq_shard_decode_cache: bool = False  # context-parallel KV for decode
    sequence_parallel: bool = False  # residual stream seq-sharded over 'tp'
    # training knobs (overridable per shape cell)
    remat: str = "full"           # full | none
    remat_group: int = 0          # sqrt-remat: checkpoint groups of G layers
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.block == "mamba"

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        total += d * v  # lm head (untied)
        if self.frontend_dim:
            total += self.frontend_dim * d
        attn = d * self.n_heads * self.hd + 2 * d * self.kv_heads * self.hd \
            + self.n_heads * self.hd * d if self.n_heads else 0
        dense_ffn = 3 * d * self.d_ff if self.d_ff else 0
        moe_ffn = self.n_experts * 3 * d * self.d_ff if self.n_experts else 0
        di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
        mamba = (2 * d * di + 2 * d * n + d * h + self.ssm_conv * (di + 2 * n)
                 + 3 * h + di + di * d)
        per_layer = {
            "attn": attn + dense_ffn + 2 * d,
            "moe": attn + d * self.n_experts + moe_ffn + 2 * d,
            "mamba": mamba + d,
            "zamba": mamba + d,
        }[self.block]
        total += self.n_layers * per_layer
        if self.block == "zamba":
            total += attn + dense_ffn + 2 * d  # one shared block
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.block != "moe" or not self.n_experts:
            return self.param_count()
        d = self.d_model
        moe_all = self.n_experts * 3 * d * self.d_ff
        moe_act = self.top_k * 3 * d * self.d_ff
        return self.param_count() - self.n_layers * (moe_all - moe_act)


# ------------------------------------------------------------- param utils


class ParamDef:
    """A parameter template: shape + initializer (normal, zeros, ones,
    ssm_a, dt_bias)."""

    def __init__(self, shape, init="normal", scale=None):
        self.shape = tuple(shape)
        self.init = init
        self.scale = scale

    def materialize(self, generator: torch.Generator,
                    dtype=torch.float32) -> torch.Tensor:
        device = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        x = torch.empty(self.shape, dtype=torch.float32, device=device)
        if self.init == "ssm_a":
            # a_log init: A in [1, 16) -> a = -exp(a_log)
            return torch.log(torch.nn.init.uniform_(
                x, 1.0, 16.0, generator=generator)).to(dtype)
        if self.init == "dt_bias":
            # softplus^-1 of dt ~ U[1e-3, 1e-1]
            u = torch.nn.init.uniform_(x, generator=generator)
            dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                           + math.log(0.001))
            return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        if self.init != "normal":
            raise ValueError(f"unknown init {self.init!r}")
        fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        scale = self.scale if self.scale is not None else fan_in ** -0.5
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return x.mul_(scale).to(dtype)


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def init_tree(defs, generator: torch.Generator, dtype=torch.float32):
    """Materialize a tree of ParamDef into tensors on the generator's
    device, drawing from ``generator`` leaf by leaf in a fixed order (dict
    keys sorted, lists in order)."""
    if isinstance(defs, dict):
        out = {k: init_tree(defs[k], generator, dtype) for k in sorted(defs)}
        return {k: out[k] for k in defs}
    if isinstance(defs, list):
        return [init_tree(d, generator, dtype) for d in defs]
    return defs.materialize(generator, dtype)
