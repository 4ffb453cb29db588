"""Observability for the port (torch port of ``repro/obs``): metrics
registry, span tracing, telemetry export, structured logging.

  * :mod:`repro_torch.obs.metrics` — process-wide registry of counters,
    gauges and histograms plus mirrors of the ``*Stats`` objects
    (``EngineStats``, the serving stores, the Trainer), so one
    :func:`snapshot` sees the whole stack;
  * :mod:`repro_torch.obs.trace` — spans with per-request trace ids,
    exported as Chrome trace-event JSON, and ``device_trace`` over
    ``torch.profiler``;
  * :mod:`repro_torch.obs.export` — periodic JSONL snapshots stamped with
    the scenario ``content_hash``; ``python -m repro_torch.obs.report``
    summarizes a run file;
  * :mod:`repro_torch.obs.log` — the structured logger and ``warn_once``.

The ``obs`` knob (``off | metrics | trace``) resolves explicit arg >
``ScenarioSpec.obs.mode`` > ``REPRO_TORCH_OBS`` > auto(off). When off,
every record-path hook is one knob resolve; ``snapshot()`` always works.
"""
from repro_torch.obs import export, log, metrics, trace  # noqa: F401
from repro_torch.obs.metrics import (REGISTRY, metrics_enabled,  # noqa: F401
                                     mode, register_stats, snapshot)
from repro_torch.obs.trace import (get_tracer, span,  # noqa: F401
                                   tracing_enabled)

__all__ = ["REGISTRY", "snapshot", "register_stats", "mode",
           "metrics_enabled", "tracing_enabled", "get_tracer", "span",
           "metrics", "trace", "export", "log"]
