"""HuBERT-XL encoder; stub conv frontend provides 512-d frame embeddings [arXiv:2106.07447]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='hubert-xlarge',
    n_layers=48,
    d_model=1280,
    n_heads=16,
    kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    frontend='audio',
    frontend_dim=512,
)

SMOKE = ModelConfig(
    name='hubert-xlarge-smoke',
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    d_ff=128,
    vocab=64,
    causal=False,
    frontend='audio',
    frontend_dim=32,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
