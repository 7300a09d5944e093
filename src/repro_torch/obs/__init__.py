"""repro_torch.obs — span tracing, the metrics registry, Perfetto export.

- :mod:`repro_torch.obs.trace`   ring-buffer span recorder (``span``/``event``)
- :mod:`repro_torch.obs.metrics` unified counter/gauge/histogram registry
- :mod:`repro_torch.obs.export`  Chrome-trace/Perfetto + JSONL emitters with
  a run manifest (git sha, versions, GPU, platform)

Tracing is off by default and never changes numerics.
"""
from repro_torch.obs import metrics, trace  # noqa: F401
from repro_torch.obs.metrics import registry  # noqa: F401
from repro_torch.obs.export import (chrome_trace,  # noqa: F401
                                    export_chrome_trace, run_manifest,
                                    write_metrics_jsonl)
from repro_torch.obs.trace import event, span  # noqa: F401

__all__ = ["trace", "metrics", "span", "event", "registry", "run_manifest",
           "chrome_trace", "export_chrome_trace", "write_metrics_jsonl"]
