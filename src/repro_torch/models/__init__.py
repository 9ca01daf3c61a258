"""Composable model definitions (plain dictionaries of tensors)."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import (
    cache_defs,
    cache_shapes,
    cache_specs,
    cast_params,
    decode_step,
    forward,
    forward_hidden,
    init_cache,
    init_params,
    loss_fn,
    model_defs,
    param_shapes,
    param_specs,
    params_from_numpy,
    train_state_from_numpy,
)

__all__ = [
    "ModelConfig",
    "model_defs",
    "init_params",
    "param_specs",
    "param_shapes",
    "params_from_numpy",
    "train_state_from_numpy",
    "cast_params",
    "forward",
    "forward_hidden",
    "loss_fn",
    "init_cache",
    "cache_defs",
    "cache_specs",
    "cache_shapes",
    "decode_step",
]
