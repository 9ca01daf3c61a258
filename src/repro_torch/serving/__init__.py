"""Serving substrate: continuous batching + AdapTBF admission."""
from repro_torch.serving.engine import BOS_TOKEN, Request, ServingEngine

__all__ = ["BOS_TOKEN", "Request", "ServingEngine"]
