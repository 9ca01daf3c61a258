"""ChatGLM3: 2d RoPE (half head dim), GQA kv=2 [arXiv:2406.12793]

The same data as the reference package's config; the smoke config runs
real steps on the CPU in the tests.
"""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name='chatglm3-6b',
    n_layers=28,
    d_model=4096,
    n_heads=32,
    kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_fraction=0.5,
)

SMOKE = ModelConfig(
    name='chatglm3-6b-smoke',
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=256,
    rope_fraction=0.5,
)


def config() -> ModelConfig:
    return FULL


def smoke_config() -> ModelConfig:
    return SMOKE
