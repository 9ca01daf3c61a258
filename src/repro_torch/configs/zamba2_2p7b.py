"""Zamba2: Mamba-2 backbone + weight-tied shared attention block [arXiv:2411.15242]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='zamba2-2.7b',
    n_layers=54,
    d_model=2560,
    n_heads=32,
    kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    block='zamba',
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name='zamba2-2.7b-smoke',
    n_layers=4,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    d_ff=128,
    vocab=256,
    ssm_state=16,
    block='zamba',
    shared_attn_every=2,
    ssm_head_dim=16,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
