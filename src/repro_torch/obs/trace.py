"""Structured request-lifecycle + lane tracer with Chrome-trace export (a
copy of ``repro.obs.trace``: the same event names, categories and tracks).

The serving stack emits three families of events:

  * REQUEST lifecycle — one track per request id (pid ``PID_REQUESTS``,
    tid = rid): a single root ``request`` span from admission to
    completion, with nested phase spans (``prefill``, ``decode``,
    ``resume_prefill``) and instant markers (``admit``, ``preempt``,
    ``park``, ``resume``, ``complete``, ``fail``).  The root STAYS OPEN
    across preemption, so every request's span tree is complete and
    single-rooted however often it went through the re-admission queue.
  * LANE events — one track per (lane, shard) (pid ``PID_LANES``): weight
    copies (``w``), spilled-KV loads (``kv``), the server's host-mirror pull
    (``mirror``), stores (``st``), compute (``fwd``), host attention
    (``cpu``), and instant robustness markers (``copy_retry``,
    ``watchdog_timeout``, ``sync_fallback``, ...).  They arrive through the
    ``MeasuredTimeline`` bridge; on the card a span's stamps are CUDA
    events, and it reaches the tracer when the timeline resolves them.
  * SERVER spans (pid ``PID_SERVER``) — chunk, admission, prefill and
    decode windows.

Disabled (the module-level ``NULL_TRACER``), every call returns after one
``self.enabled`` check and context-manager spans return a shared no-op
context.  On or off, the tracer only runs host-side around calls already
issued: it changes no device call and no host sync.

Export is Chrome-trace / Perfetto JSON (``{"traceEvents": [...]}``):
complete ``X`` spans with microsecond ``ts``/``dur``, instant ``i`` events,
and ``M`` metadata naming the process/thread tracks.

``validate_chrome_trace`` / ``span_forest`` / ``assert_single_rooted`` are
the verification helpers: schema well-formedness and proper span nesting
per track, and single-rooted request trees.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List

PID_REQUESTS = 1
PID_LANES = 2
PID_SERVER = 3

_PROCESS_NAMES = {PID_REQUESTS: "requests", PID_LANES: "lanes",
                  PID_SERVER: "server"}

#: request-lifecycle instant vocabulary
REQUEST_EVENTS = ("admit", "preempt", "park", "resume", "complete", "fail")

_NULL_CTX = nullcontext()


class Tracer:
    """Collects raw events host-side; exports Chrome-trace JSON.

    ``clock`` is injectable (tests drive deterministic traces with a
    counter clock); production uses ``time.perf_counter``, the clock of the
    timeline's resolved lane spans.  All mutation is lock-serialised: the
    cpu lane's worker records spans concurrently with the compute
    thread."""

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = enabled
        self.clock = clock
        self._lock = threading.Lock()
        self._events: List[dict] = []
        # open request roots: rid -> start ts (survives park/resume; the
        # root span is emitted at request_end)
        self._open_requests: Dict[int, float] = {}
        self._lane_tids: Dict[str, int] = {}

    # ------------------------------------------------------------ low level
    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def _lane_tid(self, lane: str, shard: int) -> int:
        key = f"{lane}/{shard}"
        with self._lock:
            tid = self._lane_tids.get(key)
            if tid is None:
                tid = len(self._lane_tids)
                self._lane_tids[key] = tid
            return tid

    # ------------------------------------------------------ request lifecycle
    def request_begin(self, rid: int, **args) -> None:
        """Open the request's root span (idempotent: a resume of a parked
        request re-enters through admission, but the root from its first
        admission is still open)."""
        if not self.enabled:
            return
        with self._lock:
            if rid in self._open_requests:
                return
            self._open_requests[rid] = self.clock()
        self.request_event(rid, "admit", **args)

    def request_event(self, rid: int, name: str, **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "cat": "lifecycle", "ph": "i",
                    "ts": self.clock(), "pid": PID_REQUESTS, "tid": int(rid),
                    "s": "t", "args": args})

    def request_span(self, rid: int, name: str, **args):
        """Context manager: one nested phase span on the request's track."""
        if not self.enabled:
            return _NULL_CTX
        return self._span_ctx(name, "phase", PID_REQUESTS, int(rid), args)

    def request_end(self, rid: int, status: str = "complete", **args) -> None:
        """Close the root span and mark the outcome.  No-op for unknown
        rids, so failure-path sweeps can call it unconditionally."""
        if not self.enabled:
            return
        with self._lock:
            start = self._open_requests.pop(rid, None)
        if start is None:
            return
        end = self.clock()
        # the outcome instant shares the root's end ts so it can never
        # escape the root span it belongs to
        self._emit({"name": status, "cat": "lifecycle", "ph": "i",
                    "ts": end, "pid": PID_REQUESTS, "tid": int(rid),
                    "s": "t", "args": args})
        self._emit({"name": "request", "cat": "lifecycle", "ph": "X",
                    "ts": start, "dur": max(end - start, 0.0),
                    "pid": PID_REQUESTS, "tid": int(rid), "args": args})

    def open_requests(self) -> List[int]:
        with self._lock:
            return sorted(self._open_requests)

    # --------------------------------------------------------------- server
    def server_span(self, name: str, **args):
        if not self.enabled:
            return _NULL_CTX
        return self._span_ctx(name, "server", PID_SERVER, 0, args)

    @contextmanager
    def _span_ctx(self, name: str, cat: str, pid: int, tid: int, args: dict):
        t0 = self.clock()
        try:
            yield
        finally:
            self._emit({"name": name, "cat": cat, "ph": "X", "ts": t0,
                        "dur": max(self.clock() - t0, 0.0), "pid": pid,
                        "tid": tid, "args": args})

    # ----------------------------------------------------------------- lanes
    def lane_span(self, lane: str, tag: str, start: float, end: float,
                  nbytes: int = 0, shard: int = 0) -> None:
        """One completed lane task (the ``MeasuredTimeline`` bridge calls
        this with the span's own wall window — lane spans are recorded at
        completion, never opened)."""
        if not self.enabled:
            return
        self._emit({"name": tag, "cat": f"lane:{lane}", "ph": "X",
                    "ts": start, "dur": max(end - start, 0.0),
                    "pid": PID_LANES, "tid": self._lane_tid(lane, shard),
                    "args": {"nbytes": nbytes, "shard": shard,
                             "lane": lane}})

    def lane_event(self, name: str, shard: int = 0, lane: str = "pcie",
                   **args) -> None:
        """Instant robustness marker (fault injected, retry, fallback...)."""
        if not self.enabled:
            return
        self._emit({"name": name, "cat": "fault", "ph": "i",
                    "ts": self.clock(), "pid": PID_LANES,
                    "tid": self._lane_tid(lane, shard), "s": "t",
                    "args": dict(args, shard=shard)})

    # ---------------------------------------------------------------- export
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """Chrome-trace dict: ts normalised to start at 0, seconds -> µs,
        metadata events naming every track."""
        with self._lock:
            events = [dict(e) for e in self._events]
            lane_tids = dict(self._lane_tids)
        t0 = min((e["ts"] for e in events), default=0.0)
        out: List[dict] = []
        for pid, pname in _PROCESS_NAMES.items():
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": pname}})
        seen_req_tids = sorted({e["tid"] for e in events
                                if e["pid"] == PID_REQUESTS})
        for tid in seen_req_tids:
            out.append({"name": "thread_name", "ph": "M",
                        "pid": PID_REQUESTS, "tid": tid,
                        "args": {"name": f"request {tid}"}})
        for key, tid in sorted(lane_tids.items(), key=lambda kv: kv[1]):
            out.append({"name": "thread_name", "ph": "M", "pid": PID_LANES,
                        "tid": tid, "args": {"name": key}})
        out.append({"name": "thread_name", "ph": "M", "pid": PID_SERVER,
                    "tid": 0, "args": {"name": "scheduler"}})
        for e in events:
            ev = dict(e)
            ev["ts"] = (e["ts"] - t0) * 1e6
            if "dur" in ev:
                ev["dur"] = e["dur"] * 1e6
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)


#: the zero-overhead default: every serving entry point that takes a
#: ``tracer=`` falls back to this disabled singleton
NULL_TRACER = Tracer(enabled=False)


# =============================================================================
# verification helpers
# =============================================================================

def validate_chrome_trace(data: dict) -> List[dict]:
    """Assert the dict is well-formed Chrome trace JSON and that ``X``
    spans nest properly per (pid, tid) track; returns the event list.

    Checks: a top-level ``traceEvents`` list;
    every event has string ``name``/``ph`` and numeric ``pid``/``tid``;
    ``X``/``i`` events carry numeric ``ts`` (and ``dur`` >= 0 for ``X``);
    on each track, spans sorted by start are properly nested — a span
    either contains or is disjoint from its successor, never partially
    overlaps (instant events are excluded from the nesting check).
    """
    assert isinstance(data, dict) and "traceEvents" in data, \
        "missing traceEvents"
    events = data["traceEvents"]
    assert isinstance(events, list) and events, "empty trace"
    tracks: Dict[tuple, List[tuple]] = {}
    for e in events:
        assert isinstance(e.get("name"), str) and e.get("name"), e
        ph = e.get("ph")
        assert ph in ("X", "i", "M", "B", "E"), f"bad phase: {e}"
        assert isinstance(e.get("pid"), int), e
        assert isinstance(e.get("tid"), int), e
        if ph == "M":
            continue
        ts = e.get("ts")
        assert isinstance(ts, (int, float)), e
        if ph == "X":
            dur = e.get("dur")
            assert isinstance(dur, (int, float)) and dur >= 0.0, e
            tracks.setdefault((e["pid"], e["tid"]), []).append(
                (float(ts), float(ts) + float(dur), e["name"]))
    eps = 1e-3                                 # µs-scale clock jitter slack
    for (pid, tid), spans in tracks.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[tuple] = []
        for s in spans:
            while stack and s[0] >= stack[-1][1] - eps:
                stack.pop()
            if stack:
                assert s[1] <= stack[-1][1] + eps, (
                    f"span {s} partially overlaps {stack[-1]} on track "
                    f"({pid}, {tid})")
            stack.append(s)
    return events


def span_forest(data: dict, pid: int = PID_REQUESTS
                ) -> Dict[int, List[dict]]:
    """Per-tid event lists (spans + instants, ts order) for one process —
    the survival tests build request trees from this."""
    out: Dict[int, List[dict]] = {}
    for e in data["traceEvents"]:
        if e.get("pid") == pid and e.get("ph") in ("X", "i"):
            out.setdefault(int(e["tid"]), []).append(e)
    for evs in out.values():
        evs.sort(key=lambda e: (e["ts"],
                                -(e.get("dur", 0.0) or 0.0)))
    return out


def assert_single_rooted(data: dict, rid: int,
                         require: tuple = ()) -> dict:
    """Assert request ``rid``'s track has exactly ONE root ``request`` span
    covering every other event on the track (the trace-context-survival
    contract), and that every name in ``require`` appears.  Returns the
    root event."""
    track = span_forest(data).get(int(rid))
    assert track, f"no events for request {rid}"
    roots = [e for e in track if e["name"] == "request" and e["ph"] == "X"]
    assert len(roots) == 1, (
        f"request {rid}: expected 1 root span, got {len(roots)}")
    root = roots[0]
    lo, hi = root["ts"], root["ts"] + root["dur"]
    eps = 1e-3
    for e in track:
        if e is root:
            continue
        t0 = e["ts"]
        t1 = t0 + (e.get("dur", 0.0) or 0.0)
        assert lo - eps <= t0 and t1 <= hi + eps, (
            f"request {rid}: event {e['name']} at [{t0}, {t1}] escapes the "
            f"root [{lo}, {hi}]")
    names = {e["name"] for e in track}
    for need in require:
        assert need in names, f"request {rid}: missing '{need}' ({names})"
    return root
