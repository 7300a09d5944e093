"""repro_torch.optim — the reference's optimizers, updating in place."""
from repro_torch.optim.optimizers import (AdamState, Optimizer, SGDState,
                                          adam, adamw, clip_by_global_norm,
                                          cosine_schedule, leaves, sgd,
                                          tree_leaves)

__all__ = ["Optimizer", "AdamState", "SGDState", "adamw", "adam", "sgd",
           "clip_by_global_norm", "cosine_schedule", "leaves", "tree_leaves"]
