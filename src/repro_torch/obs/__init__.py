"""repro_torch.obs — span tracing and the metrics registry.

- :mod:`repro_torch.obs.trace`   ring-buffer span recorder (``span``/``event``)
- :mod:`repro_torch.obs.metrics` unified counter/gauge/histogram registry

Tracing is off by default and never changes numerics. The Perfetto
exporter (``repro.obs.export``) is not ported yet.
"""
from repro_torch.obs import metrics, trace  # noqa: F401
from repro_torch.obs.metrics import registry  # noqa: F401
from repro_torch.obs.trace import event, span  # noqa: F401

__all__ = ["trace", "metrics", "span", "event", "registry"]
