"""repro_torch.core — LeapGNN's planner and device engine, and the serving
forward.

  - plan_iteration(...)          host-side training planner → IterationPlan
  - run_iteration(...)           grads and loss of one planned iteration
  - run_train_step(...)          the same plus the optimizer update, fused
  - get_compiled_iteration(...)  cached engine callables (trace log)
  - EmulatedComm                 the exchange over stacked shard tensors
  - MergingController            §5.3 adaptive time-step merging
  - plan_inference(cfg)          serving micro-batch planner → InferencePlan
  - get_compiled_inference(cfg)  the device forward over ``[cached | fetched]``
  - PlanOverflow                 structured shape-budget overflow signal

The compile-once training loop over these lives in :mod:`repro_torch.train`.
"""
from repro_torch.core.distributed import (EmulatedComm, clear_compile_cache,
                                          get_compiled_inference,
                                          get_compiled_iteration,
                                          get_compiled_train_step,
                                          infer_trace_count, run_iteration,
                                          run_train_step, trace_count,
                                          trace_log)
from repro_torch.core.merging import MergingController, fold_assignment
from repro_torch.core.pregather import PlanOverflow
from repro_torch.core.strategies import (InferencePlan, IterationPlan,
                                         Strategy, plan_inference,
                                         plan_iteration)

__all__ = ["plan_iteration", "IterationPlan", "Strategy", "run_iteration",
           "run_train_step", "get_compiled_iteration",
           "get_compiled_train_step", "EmulatedComm", "MergingController",
           "fold_assignment", "plan_inference", "InferencePlan",
           "PlanOverflow", "get_compiled_inference", "infer_trace_count",
           "trace_count", "trace_log", "clear_compile_cache"]
