"""Pixtral-12B backbone (mistral-nemo-like); stub ViT provides 1024-d patch embeddings [hf:mistralai/Pixtral-12B-2409]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='pixtral-12b',
    n_layers=40,
    d_model=5120,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    frontend='vision',
    frontend_dim=1024,
)

SMOKE = ModelConfig(
    name='pixtral-12b-smoke',
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=256,
    head_dim=16,
    frontend='vision',
    frontend_dim=32,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
