"""Observability: metrics, traces, flight recorder, live telemetry, SLO burn.

The paper's contribution is a *time-resolved* accuracy curve — which shard
finished when, and what the completion bought.  This package makes that
observable on the live runtime instead of reconstructable from print lines:

* :class:`MetricsRegistry` — named counters / gauges / histograms threaded
  through the pool, transport, backend, scheduler and decode cache; a
  disabled registry hands out shared no-op instruments so the hot path
  pays one attribute call when observability is off.
* :class:`Tracer` — per-shard spans assembled master-side from worker-
  reported monotonic deltas (no clock sync needed), exported as
  Chrome/Perfetto trace-event JSON keyed by worker lane.
* :class:`FlightRecorder` — a bounded ring of recent events dumped (with a
  metrics snapshot and the sampler's pre-crash series) when a serve
  aborts, so chaos failures in CI become artifacts instead of log
  archaeology.
* :class:`TimeSeriesSampler` — ring-buffer (t, counters, gauges) samples
  ticked by the scheduler event loop on the serving clock (virtual on
  modeled backends, wall on the cluster).
* :class:`BurnRateTracker` — per-tenant multi-window (1x/6x) SLO
  error-budget burn-rate alerting over the `serve.slo_hit/miss` stream.
* :class:`MetricsExporter` — background-thread HTTP endpoint serving
  Prometheus text and a JSON scrape of snapshot + series + burn state.
* :func:`span` — spans at the serving path's and the training step's
  layer boundaries, host ranges on the profiler's clock and, where read,
  stream intervals on the device, recorded only while a
  ``torch.profiler`` runs (:mod:`.spans`); read back with
  :func:`span_records`, emptied with :func:`clear_spans`.  They load
  torch on first use, so that a numpy-compute cluster worker, which
  imports this package, starts without it.
"""
from .exporter import MetricsExporter, prometheus_text
from .flight import NULL_FLIGHT, FlightRecorder
from .metrics import NULL_REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .slo import NULL_BURN, BurnAlert, BurnRateTracker
from .timeseries import NULL_SAMPLER, TimeSeriesSampler
from .trace import NULL_TRACER, Tracer

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "NULL_REGISTRY", "Tracer", "NULL_TRACER", "FlightRecorder",
           "NULL_FLIGHT", "TimeSeriesSampler", "NULL_SAMPLER",
           "BurnRateTracker", "BurnAlert", "NULL_BURN", "MetricsExporter",
           "prometheus_text", "span", "span_records", "clear_spans"]

_SPANS = ("span", "span_records", "clear_spans")


def __getattr__(name):
    if name in _SPANS:
        from . import spans
        for n in _SPANS:
            globals()[n] = getattr(spans, n)
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
