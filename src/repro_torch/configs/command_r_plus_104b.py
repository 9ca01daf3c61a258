"""Command R+: 104B dense, GQA kv=8, no-bias [hf:CohereForAI/c4ai-command-r-v01]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='command-r-plus-104b',
    n_layers=64,
    d_model=12288,
    n_heads=96,
    kv_heads=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
)

SMOKE = ModelConfig(
    name='command-r-plus-104b-smoke',
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
