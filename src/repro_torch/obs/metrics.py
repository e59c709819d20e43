"""Metrics registry: one labeled counter/gauge/histogram store for serving
(a copy of ``repro.obs.metrics``).

  * ``Counter`` — monotone-by-convention accumulators (int or float);
  * ``Gauge``   — last-write-wins instantaneous values;
  * ``Histogram`` — bounded-reservoir observations with percentile
    summaries (TTFT/TBT, per-step utilization);
  * labels — ``registry.counter("lane_busy_s", lane="pcie")`` keys the
    metric by ``(name, sorted(labels))``, so per-lane / per-kind families
    stay one metric name;
  * collectors — pull-style callbacks run at ``snapshot()`` time for state
    that lives elsewhere (BlockManager occupancy, controller fits), so the
    hot path never pays for keeping gauges fresh.

The counter surfaces of the serving stack stay as VIEWS over the registry:
``CounterDictView`` backs ``WeightStreamer.counters`` and
``HostAttnExecutor.counters`` (a MutableMapping whose values ARE registry
counters) and ``ScalarStatsView`` backs ``RecoveryStats`` / ``GenStats``
attribute access: one counter source of truth.

Everything here is plain host-side Python: creating, incrementing or
snapshotting a metric never touches a device or adds a call.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from collections.abc import MutableMapping


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _full_name(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Accumulator.  ``set`` exists for the view layer (which rewrites a
    base-offset total); normal producers only ``inc``."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = float(v)


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Reservoir of observations with percentile summaries.

    The reservoir is bounded (default 65536) by dropping the OLDEST half
    when full — soak runs keep recent behaviour, and the count/sum summary
    stays exact regardless."""

    __slots__ = ("count", "total", "_obs", "_maxlen")

    def __init__(self, maxlen: int = 65536):
        self.count = 0
        self.total = 0.0
        self._obs: List[float] = []
        self._maxlen = maxlen

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self._obs.append(float(v))
        if len(self._obs) > self._maxlen:
            del self._obs[: self._maxlen // 2]

    def percentile(self, q: float) -> float:
        if not self._obs:
            return 0.0
        xs = sorted(self._obs)
        idx = min(int(round((q / 100.0) * (len(xs) - 1))), len(xs) - 1)
        return xs[max(idx, 0)]

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else 0.0,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create store of labeled metrics + pull collectors.

    ``snapshot()`` returns a flat ``{qualified_name: value}`` dict —
    counters/gauges as numbers, histograms as their summary dicts — after
    running every registered collector (so occupancy-style gauges are
    computed exactly when read, not maintained on the hot path)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._hists: Dict[Tuple[str, LabelKey], Histogram] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    # ------------------------------------------------------------ get/create
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
            return g

    def histogram(self, name: str, **labels) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
            return h

    def register_collector(
            self, fn: Callable[["MetricsRegistry"], None]) -> None:
        """``fn(registry)`` runs at every ``snapshot()`` before the read —
        the pull-style hook for gauges derived from live objects."""
        with self._lock:
            self._collectors.append(fn)

    # ---------------------------------------------------------------- lookup
    def counters_with_prefix(self, prefix: str
                             ) -> List[Tuple[str, LabelKey, Counter]]:
        with self._lock:
            return [(n, k, c) for (n, k), c in self._counters.items()
                    if n.startswith(prefix)]

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, object]:
        for fn in list(self._collectors):
            fn(self)
        out: Dict[str, object] = {}
        with self._lock:
            for (n, k), c in self._counters.items():
                v = c.value
                out[_full_name(n, k)] = int(v) if float(v).is_integer() else v
            for (n, k), g in self._gauges.items():
                out[_full_name(n, k)] = g.value
            for (n, k), h in self._hists.items():
                out[_full_name(n, k)] = h.summary()
        return out


#: process-default registry for callers that don't thread their own
DEFAULT_REGISTRY = MetricsRegistry()


# =============================================================================
# legacy-surface views
# =============================================================================

class CounterDictView(MutableMapping):
    """Dict-shaped view over a family of registry counters.

    Backs ``WeightStreamer.counters``: ``view["copy_retries"] += 1``
    increments the registry counter ``<name>{key=copy_retries,**labels}``;
    iteration and ``dict(view)`` reproduce the old plain-dict behaviour.
    Per-instance base offsets make a fresh view start from zero even when
    the registry already carries totals from an earlier instance (two
    streamers sharing one registry still aggregate correctly — the
    registry keeps the grand total, each view its own)."""

    def __init__(self, registry: MetricsRegistry, name: str,
                 labels: Optional[Dict[str, object]] = None,
                 keys: Tuple[str, ...] = ()):
        self._reg = registry
        self._name = name
        self._labels = dict(labels or {})
        self._keys: List[str] = []
        self._base: Dict[str, float] = {}
        for k in keys:
            self[k] = 0

    def _counter(self, k: str) -> Counter:
        return self._reg.counter(self._name, key=k, **self._labels)

    def __getitem__(self, k: str):
        if k not in self._base:
            raise KeyError(k)
        v = self._counter(k).value - self._base[k]
        return int(v) if float(v).is_integer() else v

    def __setitem__(self, k: str, v) -> None:
        c = self._counter(k)
        if k not in self._base:
            self._keys.append(k)
            self._base[k] = c.value
        c.set(self._base[k] + v)

    def __delitem__(self, k: str) -> None:          # pragma: no cover
        raise TypeError("counter views do not support deletion")

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._keys))

    def __len__(self) -> int:
        return len(self._keys)


class ScalarStatsView:
    """Attribute-shaped view over registry counters — the machinery behind
    registry-backed ``RecoveryStats`` / ``GenStats``.

    Subclasses declare ``_FIELDS`` (name -> default).  Unbound instances
    (``registry=None``) behave exactly like the old dataclasses: plain
    attributes, no registry.  Bound instances forward every read/write to
    ``<prefix>_<field>`` counters with per-instance base offsets, so a
    per-call stats object (the engine's aggregate ``GenStats``) reads zero
    at construction while the registry accumulates across calls — one
    source of truth, same attribute surface."""

    _FIELDS: Dict[str, object] = {}

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "stats"):
        object.__setattr__(self, "_reg", registry)
        object.__setattr__(self, "_prefix", prefix)
        if registry is None:
            for k, dv in self._FIELDS.items():
                object.__setattr__(self, k, dv)
        else:
            base = {k: registry.counter(f"{prefix}_{k}").value
                    for k in self._FIELDS}
            object.__setattr__(self, "_base", base)

    def __getattr__(self, k: str):
        # only reached when the attribute is NOT set on the instance, i.e.
        # bound mode (unbound instances materialise plain attributes)
        if k.startswith("_") or k not in self._FIELDS:
            raise AttributeError(k)
        reg: MetricsRegistry = object.__getattribute__(self, "_reg")
        base = object.__getattribute__(self, "_base")
        v = reg.counter(f"{self._prefix}_{k}").value - base[k]
        return (type(self._FIELDS[k])(v)
                if isinstance(self._FIELDS[k], int) and
                float(v).is_integer() else v)

    def __setattr__(self, k: str, v) -> None:
        reg = object.__getattribute__(self, "_reg")
        if reg is None or k not in self._FIELDS:
            object.__setattr__(self, k, v)
            return
        base = object.__getattribute__(self, "_base")
        reg.counter(f"{self._prefix}_{k}").set(base[k] + v)

    def as_dict(self) -> Dict[str, object]:
        return {k: getattr(self, k) for k in self._FIELDS}

    def __repr__(self) -> str:                      # pragma: no cover
        inner = ", ".join(f"{k}={getattr(self, k)}" for k in self._FIELDS)
        return f"{type(self).__name__}({inner})"


# =============================================================================
# timeline folds (engine + scheduler share these)
# =============================================================================

#: lanes reported by ``fold_timeline_metrics`` ("pcie_up" is derived from
#: the "st" tag — TimelineResult has no dedicated upload-lane field)
FOLD_LANES = ("pcie", "pcie_up", "gpu")


def fold_timeline_metrics(registry: MetricsRegistry, results,
                          source: str = "measured") -> None:
    """Fold per-step ``TimelineResult``s into the lane counter families:
    ``lane_busy_s{lane,source}``, ``lane_time_s{source}``,
    ``timeline_steps{source}``, ``traffic_bytes{cat,source}`` and
    ``timeline_events{event}``.  ``source`` distinguishes measured lane
    times from simulated predictions so busy fractions stay honest."""
    for res in results or ():
        tb = getattr(res, "tag_busy", None) or {}
        registry.counter("lane_busy_s", lane="pcie",
                         source=source).inc(float(res.pcie_busy))
        registry.counter("lane_busy_s", lane="pcie_up",
                         source=source).inc(float(tb.get("st", 0.0)))
        registry.counter("lane_busy_s", lane="gpu",
                         source=source).inc(float(res.gpu_busy))
        registry.counter("lane_time_s", source=source).inc(float(res.total))
        registry.counter("timeline_steps", source=source).inc()
        for k, v in (getattr(res, "traffic", None) or {}).items():
            registry.counter("traffic_bytes", cat=k,
                             source=source).inc(float(v))
        for name, n in (getattr(res, "events", None) or {}).items():
            registry.counter("timeline_events", event=name).inc(int(n))


def register_busy_fraction_collector(registry: MetricsRegistry) -> None:
    """Derive ``lane_busy_frac{lane,source}`` gauges from the fold counters
    at every ``snapshot()``.  Idempotent per registry."""
    if getattr(registry, "_busy_frac_registered", False):
        return
    registry._busy_frac_registered = True

    def _collect(reg: MetricsRegistry) -> None:
        for source in ("measured", "sim"):
            tot = reg.counter("lane_time_s", source=source).value
            if tot <= 0.0:
                continue
            for lane in FOLD_LANES:
                busy = reg.counter("lane_busy_s", lane=lane,
                                   source=source).value
                reg.gauge("lane_busy_frac", lane=lane,
                          source=source).set(busy / tot)

    registry.register_collector(_collect)
