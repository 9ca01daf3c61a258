"""Phi-3-medium: dense RoPE SwiGLU GQA [arXiv:2404.14219]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='phi3-medium-14b',
    n_layers=40,
    d_model=5120,
    n_heads=40,
    kv_heads=10,
    d_ff=17920,
    vocab=100352,
    head_dim=128,
)

SMOKE = ModelConfig(
    name='phi3-medium-14b-smoke',
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
