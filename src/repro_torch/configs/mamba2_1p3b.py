"""Mamba-2 1.3B: attention-free SSD [arXiv:2405.21060]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='mamba2-1.3b',
    n_layers=48,
    d_model=2048,
    n_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    block='mamba',
)

SMOKE = ModelConfig(
    name='mamba2-1.3b-smoke',
    n_layers=2,
    d_model=64,
    n_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=256,
    ssm_state=16,
    block='mamba',
    ssm_head_dim=16,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
