"""Model configuration, parameter templates and logical sharding axes.

Plain-dictionary module system, as in the reference package: every layer
is a ``*_defs(cfg)`` function returning a tree of ``ParamDef`` (shape,
logical axes, initializer) plus an ``*_apply(p, x, ...)`` function on
tensors.  Parameter sharding is expressed with the reference's *logical
axis names*; ``logical_to_mesh`` maps them onto the axes of a mesh of
ranks (``launch/mesh.py``):

  logical axis -> mesh axis
  ------------------------------
  'fsdp'   -> 'data'  (ZeRO/FSDP parameter+optimizer sharding)
  'tp'     -> 'model' (heads / mlp hidden / experts / vocab)
  'batch'  -> ('pod', 'data')
  None     -> replicated

A *layout* is what a ``PartitionSpec`` is to the reference: one entry a
dimension, an axis name, a tuple of axis names (row-major, the first the
slowest) or ``None`` (whole).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

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


# ---------------------------------------------------------------- sharding

LOGICAL_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "tp": "model",
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "vocab": "model",
    "mlp": "model",
    "experts": "model",
    "layers": None,
    "stage": None,
}

#: the axes of a production mesh, for a layout asked for without a mesh
_ALL_AXES = ("data", "model", "pod")


def logical_to_mesh(logical: Tuple[Optional[str], ...], mesh=None) -> tuple:
    """The layout of a tuple of logical axis names on ``mesh`` (anything
    with a ``shape`` dict of axis sizes; None: every production axis),
    dropping mesh axes the mesh lacks (e.g. 'pod' on a single pod)."""
    names = set(mesh.shape) if mesh is not None else set(_ALL_AXES)
    out = []
    for ax in logical:
        m = None if ax is None else LOGICAL_RULES.get(ax)
        if m is None:
            out.append(None)
        elif isinstance(m, tuple):
            kept = tuple(x for x in m if x in names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(m if m in names else None)
    return tuple(out)


def is_layout(x) -> bool:
    """A leaf of a tree of logical axes or of layouts: a tuple of axis
    names, tuples of axis names and Nones."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def spec_tree_to_shardings(specs, mesh):
    """A tree of logical-axis tuples as a tree of layouts on ``mesh``."""
    return map_tree(lambda lg: logical_to_mesh(lg, mesh), specs)


def shard(x, logical: Tuple[Optional[str], ...]):
    """The reference's activation sharding constraint: ``x`` unchanged.
    The reference resolves it against the ambient mesh and is a no-op
    when there is none; the port has none to give it: its sharded train
    step (``launch/steps.py``) runs each rank's forward and backward on
    gathered weights, and eager PyTorch has no layout constraint to
    attach to a tensor."""
    return x


# ------------------------------------------------------------- param utils


class ParamDef:
    """A parameter template: shape, logical sharding axes (one a dimension)
    and initializer (normal, zeros, ones, ssm_a, dt_bias)."""

    def __init__(self, shape, logical, init="normal", scale=None):
        self.shape = tuple(shape)
        self.logical = tuple(logical)
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
    """Apply ``fn`` to every leaf of a tree of dicts and lists (a tuple is
    a leaf: a tree of layouts maps too)."""
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


def spec_tree(defs):
    """The tree of logical axes of a tree of ParamDef."""
    return map_tree(lambda d: d.logical, defs)
