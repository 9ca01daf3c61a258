"""Training loop substrate."""
from repro_torch.training.trainer import Trainer, compress_grads, stochastic_round_bf16

__all__ = ["Trainer", "compress_grads", "stochastic_round_bf16"]
