"""Iteration-level checkpointing (paper §8 'Failure recovery') —
crash-atomic writes, truncated-checkpoint fallback on resume, in the
reference's npz layout (either package loads the other's checkpoints)."""
from repro_torch.checkpoint.store import (CheckpointCorrupt, latest_step,
                                          load_checkpoint, save_checkpoint,
                                          tree_leaves, valid_steps)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "valid_steps", "CheckpointCorrupt", "tree_leaves"]
