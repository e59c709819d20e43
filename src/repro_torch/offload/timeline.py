"""Measured per-task lane timelines for the host-offload runtime (a copy of
``repro.offload.timeline``, with CUDA-event spans).

The analytic simulator (``core/pipeline.py``) predicts what a decode step
costs on the target hardware; the offload executor records what the step
actually cost, task by task, in the same lane vocabulary ("pcie" loads,
"pcie_up" stores, "gpu" compute, "cpu" host attention) and emits
``TimelineResult`` objects with the same schema as ``simulate_steps``.

On the card a step boundary or a span end may be a ``torch.cuda.Event``
recorded on the copy or the compute stream instead of a host time.  Events
are turned into host ``perf_counter`` seconds when completed steps are read:
every pending event is synchronised once, then one anchor event recorded and
synchronised after them maps device time onto the host clock.  Recording a
span therefore adds no host sync to the hot path; reading results does.

With a tracer (``obs.trace.Tracer``) every span also goes onto the trace's
lane tracks: a span stamped in host seconds when it is recorded, a span
stamped with events when ``results``/``drain`` resolve it, in host seconds
on the tracer's clock.  Robustness events are host-side and go at once.

Spans are recorded from two threads (the compute thread and the CPU lane's
worker); a lock serialises appends.  A span belongs to the step that is
current when it is recorded.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional, Union

from repro_torch.core.pipeline import TimelineResult

#: traffic categories, matching ``simulate_steps``'s traffic dict keys
TRAFFIC_TAGS = ("weights", "kv_load", "act_load", "store")

#: lane names, matching ``core.pipeline``.  "cpu" is the host-compute
#: attention lane: spans recorded from the ``HostAttnExecutor`` worker.
LANES = ("pcie", "pcie_up", "gpu", "cpu")

#: a host perf_counter time, or a torch.cuda.Event not yet resolved
Stamp = Union[float, object]


@dataclass
class Span:
    lane: str                 # "pcie" | "pcie_up" | "gpu" | "cpu"
    tag: str                  # "w" | "kv" | "act" | "st" | "fwd" | "cpu"
    start: Stamp
    end: Stamp
    nbytes: int = 0
    shard: int = 0            # the reference's mesh lane; one device here

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass
class _Step:
    tag: str
    start: Stamp
    end: Stamp = 0.0
    spans: List[Span] = field(default_factory=list)
    events: dict = field(default_factory=dict)    # robustness events by name


@dataclass
class MeasuredStep(TimelineResult):
    """A measured step: ``TimelineResult``'s schema (the reference's, key for
    key), and the gpu busy seconds that lie inside the pcie lane's busy
    intervals: the compute the weight copies hide."""
    gpu_hidden: float = 0.0


#: span tag -> traffic category (compute tags carry no bytes)
_TAG_TO_TRAFFIC = {"w": "weights", "kv": "kv_load", "act": "act_load",
                   "st": "store"}


def covered(spans: List[Span], lane: str, under: str) -> float:
    """Seconds of ``lane``'s spans that lie inside the union of ``under``'s
    spans: how much of one lane's busy time the other's busy time hides
    (the gpu lane's compute under the pcie lane's copies)."""
    merged: List[List[float]] = []
    for a, b in sorted((sp.start, sp.end) for sp in spans if sp.lane == under):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(max(0.0, min(b, sp.end) - max(a, sp.start))
               for sp in spans if sp.lane == lane for a, b in merged)


def _is_event(t) -> bool:
    return not isinstance(t, (int, float))


def _resolve(steps: List[_Step]) -> None:
    """Replace every CUDA event stamp of ``steps`` by host seconds."""
    stamps = []
    for s in steps:
        stamps += [s.start, s.end]
        for sp in s.spans:
            stamps += [sp.start, sp.end]
    events = [t for t in stamps if _is_event(t)]
    if not events:
        return
    import torch
    for ev in events:
        ev.synchronize()
    anchor = torch.cuda.Event(enable_timing=True)
    anchor.record()
    anchor.synchronize()
    host = time.perf_counter()
    conv = lambda t: host - t.elapsed_time(anchor) / 1e3 if _is_event(t) else t
    for s in steps:
        s.start, s.end = conv(s.start), conv(s.end)
        for sp in s.spans:
            sp.start, sp.end = conv(sp.start), conv(sp.end)


class MeasuredTimeline:
    """Collects lane spans grouped into steps.

    Usage::

        tl = MeasuredTimeline()
        tl.begin_step("decode")
        with tl.task("gpu", "fwd"):
            ... compute ...
        tl.end_step()
        results = tl.results()          # List[TimelineResult], one per step
    """

    def __init__(self, tracer=None):
        self._lock = threading.Lock()
        self._steps: List[_Step] = []
        self._cur: Optional[_Step] = None
        # optional obs bridge: every span and robustness event is mirrored
        # onto the tracer's lane tracks; None records exactly as without it
        self.tracer = tracer
        # spans stamped with CUDA events, held for the tracer until resolved
        self._untraced: List[Span] = []

    # ------------------------------------------------------------------ steps
    def begin_step(self, tag: str = "decode", now: Stamp = None) -> None:
        """``now`` overrides the wall clock: a host time, or a CUDA event
        recorded on the compute stream."""
        with self._lock:
            now = time.perf_counter() if now is None else now
            if self._cur is not None:
                self._cur.end = now
                self._steps.append(self._cur)
            self._cur = _Step(tag=tag, start=now)

    def end_step(self, now: Stamp = None) -> None:
        with self._lock:
            if self._cur is not None:
                self._cur.end = time.perf_counter() if now is None else now
                self._steps.append(self._cur)
                self._cur = None

    # ------------------------------------------------------------------ spans
    def record(self, lane: str, tag: str, start: Stamp, end: Stamp,
               nbytes: int = 0) -> None:
        assert lane in LANES, lane
        span = Span(lane, tag, start, end, nbytes)
        with self._lock:
            if self._cur is None:           # span outside any step: open one
                self._cur = _Step(tag="untagged", start=start)
            self._cur.spans.append(span)
            if self.tracer is not None and (_is_event(start) or _is_event(end)):
                self._untraced.append(span)
                return
        if self.tracer is not None:
            self.tracer.lane_span(lane, tag, start, end, nbytes=nbytes)

    def record_event(self, name: str, n: int = 1) -> None:
        """Count a robustness event (watchdog timeout, copy retry, lane
        fallback, arena denial, ...) against the current step; events ride
        ``TimelineResult.events``."""
        with self._lock:
            if self._cur is None:
                self._cur = _Step(tag="untagged", start=time.perf_counter())
            self._cur.events[name] = self._cur.events.get(name, 0) + n
        if self.tracer is not None:
            self.tracer.lane_event(name)

    @contextmanager
    def task(self, lane: str, tag: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(lane, tag, t0, time.perf_counter(), nbytes)

    # ---------------------------------------------------------------- results
    def results(self, tag: Optional[str] = None) -> List[MeasuredStep]:
        """Per-step measured ``TimelineResult``s (same schema as
        ``simulate_steps``, and ``gpu_hidden``) of the COMPLETED steps;
        ``tag`` filters steps (e.g. only "decode").  Synchronises pending
        CUDA events."""
        out = []
        with self._lock:
            _resolve(self._steps)
            steps = [s for s in self._steps if tag is None or s.tag == tag]
            ready = [sp for sp in self._untraced
                     if not (_is_event(sp.start) or _is_event(sp.end))]
            self._untraced = [sp for sp in self._untraced
                              if _is_event(sp.start) or _is_event(sp.end)]
        for sp in ready:
            self.tracer.lane_span(sp.lane, sp.tag, sp.start, sp.end,
                                  nbytes=sp.nbytes)
        for s in steps:
            busy = {l: 0.0 for l in LANES}
            tag_busy: dict = {}
            traffic = {k: 0.0 for k in TRAFFIC_TAGS}
            finish = []
            end = s.end
            for sp in s.spans:
                busy[sp.lane] += sp.dur
                tag_busy[sp.tag] = tag_busy.get(sp.tag, 0.0) + sp.dur
                cat = _TAG_TO_TRAFFIC.get(sp.tag)
                if cat is not None:
                    traffic[cat] += sp.nbytes
                finish.append(sp.end - s.start)
                end = max(end, sp.end)
            out.append(MeasuredStep(
                total=end - s.start, pcie_busy=busy["pcie"],
                gpu_busy=busy["gpu"], cpu_busy=busy["cpu"], traffic=traffic,
                finish=finish, tag_busy=tag_busy, events=dict(s.events),
                gpu_hidden=covered(s.spans, "gpu", "pcie")))
        return out

    def drain(self, tag: Optional[str] = None) -> List[TimelineResult]:
        """Close the in-flight step, return ``results`` and reset — the
        collector a caller uses at group boundaries."""
        self.end_step()
        res = self.results(tag)
        with self._lock:
            self._steps.clear()
            self._cur = None
        return res
