"""Double-buffered host→device weight streamer (paper Fig. 8's PCIe lane),
built for the card; counterpart of ``repro.offload.streamer``.

The reference runs a worker thread that stages each layer into a numpy slot
and hands it to the device with a synchronous ``device_put``, a workaround
for a CPU backend.  Here the copy from a layer's pinned host buffer to a
device slot, issued with ``non_blocking=True`` on a side ``torch.cuda.Stream``
(the copy stream), IS the DMA: the host only enqueues it.

  * ``prefetch_depth + 1`` device slots, each one flat buffer of a layer's
    bytes with the layer's leaves as views, are allocated once: no block of
    the caching allocator ever crosses streams.
  * CUDA events order the two streams both ways: the copy stream waits on
    "slot s released" (recorded on the compute stream by ``release``) before
    it overwrites slot s, and ``acquire(i)`` makes the compute stream wait on
    "slot of i landed".  Neither blocks the host.

Dispatch-ahead protocol (prefetch depth ``d``):

  * ``begin(schedule)`` arms a pass over a sequence of layer ids (a decode
    loop cycles ``[0..L-1]`` per step, so prefetch crosses step boundaries)
    and issues the first ``d`` copies.
  * ``acquire(i)`` returns the device tree of schedule position ``i`` and
    tops the in-flight window back up to ``d`` copies beyond ``i``.  With
    ``d = 0`` each copy is issued in ``acquire`` and waited for by the
    layer that reads it: no overlap, the baseline.
  * ``release(i)`` marks the slot reusable once the compute stream has
    passed the layer's last kernel; residency stays bounded at ``d + 1``
    layer slots.

``side`` (given to ``begin``) issues further copies that belong to a
schedule position, on the copy stream just before its weights: the
executor's spilled-KV upload rides the same lane and the same slot
discipline.

Robustness (the reference's ladder): ``faults`` is consulted once per issued
copy at site ``"stage:0"``.  An injected ``copy_fail`` issues nothing and
raises ``TransientCopyError`` at ``acquire``, which retries up to
``MAX_COPY_RETRIES`` times with exponential backoff; an injected stall or
slowdown holds the copy's landing back by its seconds.  ``watchdog_s`` arms a
deadline on every wait, checked by polling the landed event: a copy that has
not landed in time trips the watchdog.  Either ladder exhausting drops the
lane to DEGRADED: in-flight copies are abandoned (their slots are off limits
until ``begin`` drains them) and every further ``acquire`` of the pass
copies synchronously, on the compute stream, into a dedicated spare buffer,
bypassing injection.  ``begin`` restores the lane to HEALTHY; counters
persist.

For ``device="cpu"`` (the tests) every copy is a synchronous ``copy_`` on
the caller thread and the timeline records host times.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.obs.metrics import CounterDictView, MetricsRegistry
from repro_torch.offload.faults import (MAX_COPY_RETRIES, FaultPlan,
                                        TransientCopyError)
from repro_torch.offload.host_pool import HostWeightPool
from repro_torch.offload.timeline import MeasuredTimeline

#: the streamer's robustness-counter ladder
FAULT_COUNTER_KEYS = ("watchdog_timeouts", "copy_retries", "copy_failures",
                      "sync_fallbacks", "stalls_injected")

#: fault-injection site of the (single) weight lane
STAGE_SITE = "stage:0"

#: host poll interval while a watchdog waits on a landed event
_POLL_S = 5e-5


@dataclass
class _Staged:
    """One issued (or injected-failed) copy of a schedule position."""
    slot: int
    landed: Optional[object] = None   # CUDA event after the copy (None on CPU)
    ready_at: float = 0.0             # injected delay: not landed before this
    failed: bool = False              # injected copy_fail: nothing was issued


def timing_event(stream=None):
    """A timing CUDA event recorded on ``stream`` (default: current)."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class WeightStreamer:
    """Streams per-layer weight shards from a ``HostWeightPool``."""

    def __init__(self, pool: HostWeightPool, *, prefetch_depth: int = 1,
                 timeline: Optional[MeasuredTimeline] = None,
                 faults: Optional[FaultPlan] = None,
                 watchdog_s: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None):
        assert prefetch_depth >= 0
        assert watchdog_s is None or watchdog_s > 0.0
        self.pool = pool
        self.device = pool.device
        self.cuda = self.device.type == "cuda"
        self.depth = prefetch_depth
        self.timeline = timeline if timeline is not None else MeasuredTimeline()
        self.faults = faults
        self.watchdog_s = watchdog_s
        nbytes = pool.layout.nbytes
        self._bufs = [torch.empty(nbytes, dtype=torch.uint8, device=self.device)
                      for _ in range(prefetch_depth + 1)]
        self._trees = [pool.layout.views(b) for b in self._bufs]
        self.copy_stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._released: List[Optional[object]] = [None] * len(self._bufs)
        self._spare = None        # emergency slot, allocated on first fallback
        self._sched: List[int] = []
        self._side: Optional[Callable[[int, int], None]] = None
        self._staging: Dict[int, _Staged] = {}     # seq index -> issued copy
        self._abandoned: List[_Staged] = []         # timed-out copies
        self._live: Dict[int, Optional[int]] = {}   # seq index -> slot (None: spare)
        self.uploads = 0
        self.bytes_uploaded = 0
        self.peak_resident = 0
        self.degraded = False
        # robustness counters (cumulative across passes).  With a metrics
        # registry the dict is a live view over ``streamer_faults{key=...,
        # shard=0}`` counters; without one it is a plain dict
        if metrics is None:
            self.counters: Dict[str, int] = {k: 0 for k in FAULT_COUNTER_KEYS}
        else:
            self.counters = CounterDictView(
                metrics, "streamer_faults", labels={"shard": 0},
                keys=FAULT_COUNTER_KEYS)

    # ------------------------------------------------------------------ copies
    def _stage(self, i: int, slot: int) -> _Staged:
        """Issue schedule position ``i``'s copy into ``slot`` (the fault
        site: an injected copy_fail issues nothing)."""
        ready_at = 0.0
        if self.faults is not None:
            ev = self.faults.draw(STAGE_SITE,
                                  kinds=("stall", "copy_fail", "slow"))
            if ev is not None:
                if ev.kind == "copy_fail":
                    self.timeline.record_event("copy_fail_injected")
                    return _Staged(slot, failed=True)
                if ev.kind == "stall":
                    self.counters["stalls_injected"] += 1
                self.timeline.record_event(f"{ev.kind}_injected")
                ready_at = time.perf_counter() + ev.seconds
        if not self.cuda:
            if self._side is not None:
                self._side(i, slot)
            self._copy(self._sched[i], self._bufs[slot])
            return _Staged(slot, ready_at=ready_at)
        with torch.cuda.stream(self.copy_stream):
            if self._released[slot] is not None:
                self.copy_stream.wait_event(self._released[slot])
            if self._side is not None:
                self._side(i, slot)
            landed = self._copy(self._sched[i], self._bufs[slot])
        return _Staged(slot, landed, ready_at)

    def _copy(self, layer: int, dst: torch.Tensor):
        """One layer's host buffer into ``dst`` on the current stream;
        -> the landed event (None on the CPU)."""
        nbytes = self.pool.layer_nbytes[layer]
        src = self.pool.buffer(layer)
        if self.cuda:
            start = timing_event()
            dst.copy_(src, non_blocking=True)
            end = timing_event()
        else:
            start = time.perf_counter()
            dst.copy_(src)
            end = time.perf_counter()
        self.timeline.record("pcie", "w", start, end, nbytes)
        self.uploads += 1
        self.bytes_uploaded += nbytes
        return end if self.cuda else None

    def _stage_emergency(self, i: int):
        """Degraded-mode copy into the spare buffer, ordered on the compute
        stream (serial with compute: the direct load the degraded lane IS);
        never touches the slot ring and bypasses fault injection."""
        if self._spare is None:
            self._spare = torch.empty(self.pool.layout.nbytes,
                                      dtype=torch.uint8, device=self.device)
            self._spare_tree = self.pool.layout.views(self._spare)
        self.counters["sync_fallbacks"] += 1
        self.timeline.record_event("sync_fallback")
        if self._side is not None:
            self._side(i, None)
        self._copy(self._sched[i], self._spare)
        return self._spare_tree

    def _landed(self, st: _Staged) -> bool:
        """Wait until ``st`` counts as landed; False when the watchdog's
        deadline passes first.  Without a watchdog only an injected delay
        blocks the host: the device-side wait is the compute stream's."""
        now = time.perf_counter()
        if self.watchdog_s is None:
            if st.ready_at > now:
                time.sleep(st.ready_at - now)
            return True
        deadline = now + self.watchdog_s
        while True:
            if now >= st.ready_at and (st.landed is None or st.landed.query()):
                return True
            if now >= deadline:
                return False
            time.sleep(min(_POLL_S, deadline - now))
            now = time.perf_counter()

    # ------------------------------------------------------------------- pass
    def begin(self, schedule: Sequence[int],
              side: Optional[Callable[[int, Optional[int]], None]] = None
              ) -> None:
        """Arm a pass; leftover slots are released and abandoned copies
        drained first, so the ring is quiescent before reuse.  A degraded
        lane recovers here.  ``side(i, slot)`` issues position ``i``'s extra
        copies (slot None: the degraded path's spare)."""
        for i in list(self._live):
            self.release(i)
        self._drain()
        self._sched = list(schedule)
        self._side = side
        self._live = {}
        self.degraded = False
        for j in range(min(self.depth, len(self._sched))):
            self._dispatch(j)

    def _drain(self) -> None:
        for st in list(self._staging.values()) + self._abandoned:
            if st.landed is not None:
                st.landed.synchronize()
        self._staging = {}
        self._abandoned = []

    def _degrade(self) -> None:
        """Abandon every in-flight copy and stop prefetching."""
        self.degraded = True
        self._abandoned += list(self._staging.values())
        self._staging = {}

    def _dispatch(self, i: int) -> None:
        if i in self._staging or not (0 <= i < len(self._sched)):
            return
        self._staging[i] = self._stage(i, i % (self.depth + 1))

    def acquire(self, i: int):
        """Device weights (the layer tree) for schedule position ``i``."""
        if i in self._live:
            return self._tree(self._live[i])
        if self.degraded:
            tree, slot = self._stage_emergency(i), None
        else:
            slot = self._acquire_staged(i)
            tree = self._tree(slot)
        self._live[i] = slot
        if not self.degraded:               # degraded: no prefetch top-up
            for j in range(i + 1, min(i + 1 + self.depth, len(self._sched))):
                self._dispatch(j)
        self.peak_resident = max(self.peak_resident,
                                 len(self._live) + len(self._staging))
        return tree

    def _tree(self, slot):
        return self._spare_tree if slot is None else self._trees[slot]

    def _acquire_staged(self, i: int) -> Optional[int]:
        """Healthy-path wait: watchdog deadline, bounded retry with backoff
        on an injected failure; either ladder exhausting degrades the lane
        and falls back to the spare (-> None)."""
        if i not in self._staging:
            self._dispatch(i)
        retries = 0
        while True:
            st = self._staging[i]
            if st.failed:
                retries += 1
                del self._staging[i]
                if retries > MAX_COPY_RETRIES:
                    self.counters["copy_failures"] += 1
                    self.timeline.record_event("copy_give_up")
                    self._degrade()
                    self._stage_emergency(i)
                    return None
                self.counters["copy_retries"] += 1
                self.timeline.record_event("copy_retry")
                time.sleep(min(0.001 * (2 ** (retries - 1)), 0.05))
                self._dispatch(i)
                continue
            if not self._landed(st):
                self.counters["watchdog_timeouts"] += 1
                self.timeline.record_event("watchdog_timeout")
                self._degrade()
                self._stage_emergency(i)
                return None
            del self._staging[i]
            if st.landed is not None:
                torch.cuda.current_stream(self.device).wait_event(st.landed)
            return st.slot

    def release(self, i: int) -> None:
        """Schedule position ``i``'s slot may be overwritten once the compute
        stream has passed this point."""
        slot = self._live.pop(i, None)
        if slot is not None and self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._released[slot] = ev

    def close(self) -> None:
        """Deterministic teardown: drain every outstanding copy and release
        live slots.  Idempotent; also the context-manager exit."""
        self._drain()
        for i in list(self._live):
            self.release(i)
        if self.cuda:
            self.copy_stream.synchronize()

    # ------------------------------------------------------------------ stats
    @property
    def lane_health(self) -> str:
        """"healthy" | "degraded" — degraded clears at the next ``begin``."""
        return "degraded" if self.degraded else "healthy"

    @property
    def fault_counters(self) -> Dict[str, int]:
        return dict(self.counters)
