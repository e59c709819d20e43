"""Serving telemetry of the port (a copy of ``repro.obs``).

  * :mod:`repro_torch.obs.trace`   — request-lifecycle and lane tracer with
    Chrome-trace/Perfetto export;
  * :mod:`repro_torch.obs.metrics` — labeled counter/gauge/histogram
    registry behind one ``snapshot()``, and the views that keep the counter
    surfaces (``WeightStreamer.counters``, ``RecoveryStats``, ``GenStats``)
    reading and writing through it;
  * :mod:`repro_torch.obs.drift`   — rolling sim-vs-measured lane residuals
    that flag systematic ``simulate_steps`` error before the controller's
    damped refit absorbs it.

Everything is host-side Python: turning any of it on adds no device call and
no host sync.
"""
from .drift import DEFAULT_FLAG_REL, DRIFT_LANES, DriftMonitor
from .metrics import (Counter, CounterDictView, DEFAULT_REGISTRY, Gauge,
                      Histogram, MetricsRegistry, ScalarStatsView,
                      fold_timeline_metrics, register_busy_fraction_collector)
from .trace import (NULL_TRACER, PID_LANES, PID_REQUESTS, PID_SERVER,
                    REQUEST_EVENTS, Tracer, assert_single_rooted,
                    span_forest, validate_chrome_trace)

__all__ = [
    "Counter", "CounterDictView", "DEFAULT_FLAG_REL", "DEFAULT_REGISTRY",
    "DRIFT_LANES", "DriftMonitor", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "PID_LANES", "PID_REQUESTS", "PID_SERVER",
    "REQUEST_EVENTS", "ScalarStatsView", "Tracer", "assert_single_rooted",
    "fold_timeline_metrics", "register_busy_fraction_collector",
    "span_forest", "validate_chrome_trace",
]
