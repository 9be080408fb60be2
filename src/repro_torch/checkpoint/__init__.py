"""Checkpoints: npz shards plus a JSON manifest (counterpart of
``repro.checkpoint``; the same on-disk format)."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, all_steps,
                                                 latest_step,
                                                 restore_checkpoint,
                                                 save_checkpoint)

__all__ = ["Checkpointer", "all_steps", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
