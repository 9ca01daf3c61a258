"""Fault-tolerant, AdapTBF-paced checkpointing in the reference's format."""
from repro_torch.checkpoint.manager import (
    AsyncCheckpointer,
    checkpoint_leaves,
    checkpoint_meta,
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "checkpoint_meta", "checkpoint_leaves", "gc_checkpoints",
           "AsyncCheckpointer"]
