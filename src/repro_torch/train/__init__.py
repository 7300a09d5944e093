"""repro_torch.train — shape budgets. The Trainer and its async pipeline
arrive with the training slice."""
from repro_torch.train.budget import ShapeBudget, next_bucket

__all__ = ["ShapeBudget", "next_bucket"]
