"""Phi-3.5-MoE: 16 experts top-2, GQA kv=8 [hf:microsoft/Phi-3.5-MoE-instruct]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='phi3.5-moe-42b-a6.6b',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=6400,
    vocab=32064,
    block='moe',
    n_experts=16,
    top_k=2,
)

SMOKE = ModelConfig(
    name='phi3.5-moe-42b-a6.6b-smoke',
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=64,
    vocab=256,
    block='moe',
    n_experts=4,
    top_k=2,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
