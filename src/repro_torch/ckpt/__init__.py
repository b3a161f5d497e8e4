"""Checkpoints: manifest + per-leaf shard files, async save, retention."""

from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         load_checkpoint, load_checkpoint_arrays,
                                         save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "load_checkpoint_arrays", "save_checkpoint"]
