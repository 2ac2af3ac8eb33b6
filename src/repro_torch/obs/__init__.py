"""Engine observability of the port (the counterpart of ``repro.obs``):
counters on the card, stage tracing, the metrics registry, exporters.

- :mod:`repro_torch.obs.counters` — device-side counter dicts threaded
  through streaming states and the pane store; surfaced as
  ``AggResult.stats`` / ``StreamResult.stats`` via
  ``execute(..., collect_stats=True)``.  The placement, time-placement and
  reorder kernels count into them on the card.
- :mod:`repro_torch.obs.trace` — host-side nested span timers
  (``with trace.capture() as tr: ...``) around plan and dispatch.
- :mod:`repro_torch.obs.registry` — process-wide per-(backend, plan
  fingerprint) observed tuples/s, the measured-cost routing table.
- :mod:`repro_torch.obs.export` — JSONL and Prometheus text exporters.
"""
from repro_torch.obs import counters, export, trace  # noqa: F401
from repro_torch.obs.export import (dumps_jsonl, prometheus_metrics,  # noqa
                                    read_jsonl, to_jsonable, write_jsonl)
from repro_torch.obs.registry import (METRICS, MetricsRegistry,  # noqa: F401
                                      get_registry, plan_fingerprint,
                                      query_fingerprint)
from repro_torch.obs.trace import Tracer, capture, span  # noqa: F401
