"""Assigned input-shape cells (LM shapes are seq_len x global_batch) and the
(arch x shape) applicability rules, the reference package's
``configs/shapes.py``:

  * ``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
    cache of seq_len), not ``train_step``.
  * ``long_500k`` requires sub-quadratic attention: runs for SSM/hybrid archs,
    skipped (with reason) for pure full-attention archs.
  * encoder-only archs (hubert) have no decode step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from repro_torch.models.common import ModelConfig


class ShapeCell(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def skip_reason(cfg: ModelConfig, shape: ShapeCell) -> Optional[str]:
    """None if the (arch, shape) cell runs; otherwise the documented skip."""
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.block in ("attn", "moe"):
        return ("long_500k needs sub-quadratic attention; this arch is pure "
                "full-attention")
    return None


def cells(cfg: ModelConfig):
    """All four cells with their skip status for one architecture."""
    return [(s, skip_reason(cfg, s)) for s in SHAPES.values()]
