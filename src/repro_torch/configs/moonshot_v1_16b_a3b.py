"""Moonlight 16B-A3B: fine-grained 64-expert top-6 MoE [hf:moonshotai/Moonlight-16B-A3B]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='moonshot-v1-16b-a3b',
    n_layers=48,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=1408,
    vocab=163840,
    block='moe',
    n_experts=64,
    top_k=6,
)

SMOKE = ModelConfig(
    name='moonshot-v1-16b-a3b-smoke',
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    d_ff=32,
    vocab=256,
    block='moe',
    n_experts=8,
    top_k=2,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
