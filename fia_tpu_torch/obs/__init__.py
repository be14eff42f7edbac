"""The observability spine: tracing, metrics and exporters (port of
``fia_tpu/obs/``; the same names, ids, series keys and output formats).

- :mod:`fia_tpu_torch.obs.trace` — deterministic spans
  (contextvar-propagated, ids derived from seeds, so traced and untraced
  runs of the same traffic carry the same ids and the same results).
- :mod:`fia_tpu_torch.obs.registry` — process-wide counters / gauges /
  fixed-bucket µs histograms with a deterministic snapshot order.
- :mod:`fia_tpu_torch.obs.export` — the JSONL span form, Chrome/Perfetto
  ``trace_event`` JSON, Prometheus text exposition.
- :mod:`fia_tpu_torch.obs.diag` — the replacement for bare ``print``
  diagnostics: stderr + counter + span event in one call.
"""

from fia_tpu_torch.obs.diag import diag
from fia_tpu_torch.obs.registry import REGISTRY, Registry, get_registry
from fia_tpu_torch.obs.trace import (
    TRACER,
    Span,
    Tracer,
    configure,
    current_span,
    event,
    span,
    trace,
    trace_id_for,
    tracing_enabled,
)

__all__ = [
    "REGISTRY",
    "Registry",
    "get_registry",
    "TRACER",
    "Span",
    "Tracer",
    "configure",
    "current_span",
    "diag",
    "event",
    "span",
    "trace",
    "trace_id_for",
    "tracing_enabled",
]
