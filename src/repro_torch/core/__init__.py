"""repro_torch.core — the serving planner and the serving forward.

  - plan_inference(...)          host-side micro-batch planner → InferencePlan
  - get_compiled_inference(cfg)  the device forward over ``[cached | fetched]``
  - PlanOverflow                 structured shape-budget overflow signal

The training planner and engine arrive with the training slice.
"""
from repro_torch.core.distributed import (clear_compile_cache,
                                          get_compiled_inference,
                                          infer_trace_count, trace_count,
                                          trace_log)
from repro_torch.core.pregather import PlanOverflow
from repro_torch.core.strategies import InferencePlan, plan_inference

__all__ = ["plan_inference", "InferencePlan", "PlanOverflow",
           "get_compiled_inference", "infer_trace_count", "trace_count",
           "trace_log", "clear_compile_cache"]
