"""Phi-3-mini: dense RoPE SwiGLU, MHA [arXiv:2404.14219]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='phi3-mini-3.8b',
    n_layers=32,
    d_model=3072,
    n_heads=32,
    kv_heads=32,
    d_ff=8192,
    vocab=32064,
)

SMOKE = ModelConfig(
    name='phi3-mini-3.8b-smoke',
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    d_ff=128,
    vocab=256,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
