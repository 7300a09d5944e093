"""repro_torch.train — the compile-once training loop for the LeapGNN
engine: shape budgets, a prefetching double-buffered planner with a
planning thread pool, the async device pipeline (fused in-place optimizer
step, non-blocking dispatch, plan uploads on a side CUDA stream, optional
K-stacked dispatch — see pipeline.py), the §5.3 merging controller fed a
trace-free timing signal, the remote-feature cache with its epoch
prefetch, and eval. See loop.py for the design notes."""
from repro_torch.train.budget import ShapeBudget, next_bucket
from repro_torch.train.loop import EpochStats, Trainer
from repro_torch.train.pipeline import (EpochRunResult, PlanUploader,
                                        run_pipelined_epoch)

__all__ = ["ShapeBudget", "next_bucket", "EpochStats", "Trainer",
           "EpochRunResult", "PlanUploader", "run_pipelined_epoch"]
