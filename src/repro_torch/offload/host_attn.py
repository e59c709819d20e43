"""CPU-compute attention lane: host flash attention over spilled KV blocks
(a copy of ``repro.offload.host_attn``).

The two placements for a KV block under memory pressure both pay a link
cost: keep it on device, or spill it and either re-upload it every step
(PCIe down) or regenerate it from an ACT checkpoint (KV Gen FLOPs).  This
module adds the third lane: leave the block in the pinned host arena and
run its share of the attention *on the CPU*, shipping only the
per-partition softmax statistics back — O(H·D) per request instead of
O(S·KVH·D) per step.

Flash-attention partials make the split exact.  Each partition computes

    m = max_j s_j          (masked score max, NEG_INF basis)
    l = sum_j exp(s_j - m)
    o = sum_j exp(s_j - m) v_j / l

and two partitions merge associatively:

    m* = max(m_a, m_b);  w_i = l_i * exp(m_i - m*)
    o  = (w_a o_a + w_b o_b) / (w_a + w_b);   l* = w_a + w_b

so host partition = arena KV rows ``[0, kv_len)`` and device partition =
recomputed ACT region + the new token's own row reproduce exactly the
valid set a hybrid layer step attends over.  The device partial's ``(m, l)``
come from the hybrid kernel's ``return_lse`` mode.  An empty host partition
is the identity element (m = NEG_INF, l = 0).

A quantized arena's planes are ``QuantPlane``s: int8 codes and float16
scales, read as ``code * scale`` rounded to the cache dtype, then widened to
float32 (the reference's ``_dequant_rows``), so the host reads the values the
device kernels read.

``HostAttnExecutor`` runs the host partition on a dedicated worker thread:
submit right after the query reaches the host, overlap with the device
partial, collect at the merge point — with the fault/watchdog ladder
(injected stall/slow/copy_fail at site ``"host_attn"``, watchdog timeout →
degraded inline fallback, bounded retries with exponential backoff).  Every
job records a ``cpu``-lane span on the shared ``MeasuredTimeline``.
"""
from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

# the merge lives beside the kernel's plain version, below the model layer
# that also merges; re-exported here for the lane's callers
from repro_torch.kernels.hybrid_attention.ref import (  # noqa: F401
    NEG_INF, merge_partials_torch)
from repro_torch.models.quant_ops import dequantize
from repro_torch.obs.metrics import CounterDictView, MetricsRegistry
from repro_torch.offload.faults import (MAX_COPY_RETRIES, FaultPlan,
                                        TransientCopyError)
from repro_torch.offload.streamer import FAULT_COUNTER_KEYS
from repro_torch.offload.timeline import MeasuredTimeline

#: fault-injection site consulted once per submitted job
HOST_ATTN_SITE = "host_attn"


class QuantPlane(NamedTuple):
    """One layer's spilled K or V plane of a quantized arena: codes (B, cap,
    KVH, D) int8, scales (B, cap, KVH, 1) float16, and the cache dtype the
    codes dequantize to."""
    codes: torch.Tensor
    scales: torch.Tensor
    dtype: torch.dtype


def _rows(plane, bound: int) -> Tuple[np.ndarray, int]:
    """First ``bound`` rows of one arena plane (B, cap, KVH, D) as float32
    numpy, plus the bytes read.  A float32 plane is read in place; a
    ``QuantPlane`` is dequantized through its cache dtype."""
    if isinstance(plane, QuantPlane):
        q, s = plane.codes[:, :bound], plane.scales[:, :bound]
        return (dequantize(q, s, plane.dtype).float().numpy(),
                q.numel() * q.element_size() + s.numel() * s.element_size())
    if isinstance(plane, torch.Tensor):
        rows = plane[:, :bound]
        return rows.float().numpy(), rows.numel() * rows.element_size()
    rows = plane[:, :bound]
    return rows.astype(np.float32), rows.nbytes


def host_flash_attention(q: np.ndarray, hk, hv, kv_len: np.ndarray, *,
                         chunk: int = 256
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Flash-style masked attention over host-arena KV rows ``[0, kv_len)``.

    q:      (B, KVH, G, D) f32 — roped query, grouped per KV head.
    hk/hv:  arena planes, (B, cap, KVH, D) each (torch CPU tensor, numpy, or
            ``QuantPlane``).
    kv_len: (B,) int — valid host rows per request (0 = empty partition).
    -> (o (B,KVH,G,D) f32 normalised, m (B,KVH,G,1) f32, l (B,KVH,G,1) f32,
        bytes read from the arena).

    Single pass over kv chunks with a running (m, l, acc) — the numpy
    mirror of the kernel's inner loop, so the returned partial obeys the
    same NEG_INF conventions ``merge_partials_torch`` expects.
    """
    B, KVH, G, D = q.shape
    scale = 1.0 / math.sqrt(D)
    m = np.full((B, KVH, G), NEG_INF, np.float32)
    l = np.zeros((B, KVH, G), np.float32)
    acc = np.zeros((B, KVH, G, D), np.float32)
    kv_len = np.asarray(kv_len)
    bound = int(kv_len.max()) if kv_len.size else 0
    k_rows, nbytes_k = _rows(hk, bound)
    v_rows, nbytes_v = _rows(hv, bound)
    q32 = np.asarray(q, np.float32)
    for c0 in range(0, bound, chunk):
        c1 = min(c0 + chunk, bound)
        kc = k_rows[:, c0:c1]                               # (B, C, KVH, D)
        vc = v_rows[:, c0:c1]
        s = np.einsum("bhgd,bchd->bhgc", q32, kc,
                      optimize=True) * scale
        valid = np.arange(c0, c1)[None, :] < kv_len[:, None]    # (B, C)
        vmask = valid[:, None, None, :]
        s = np.where(vmask, s, NEG_INF)
        m_new = np.maximum(m, s.max(axis=-1))
        alpha = np.exp(m - m_new)
        e = np.where(vmask, np.exp(s - m_new[..., None]), 0.0)
        acc = acc * alpha[..., None] + np.einsum(
            "bhgc,bchd->bhgd", e, vc, optimize=True)
        l = l * alpha + e.sum(axis=-1)
        m = m_new
    o = acc / np.maximum(l, 1e-30)[..., None]
    return (o.astype(np.float32), m[..., None], l[..., None],
            nbytes_k + nbytes_v)


# =========================================================== worker executor
class _HostJob:
    """One submitted host-partition job: the future plus everything needed
    to retry or recompute it inline after a fault."""

    __slots__ = ("q", "hk", "hv", "kv_len", "after", "fut", "retries")

    def __init__(self, q, hk, hv, kv_len, after):
        self.q, self.hk, self.hv, self.kv_len = q, hk, hv, kv_len
        self.after = after
        self.fut = None
        self.retries = 0


class HostAttnExecutor:
    """Dedicated CPU attention worker — the ``WeightStreamer`` of the cpu
    lane.

    ``submit`` enqueues a host partition on the single worker thread and
    returns immediately (the caller's device partial runs meanwhile);
    ``collect`` joins with the robustness ladder:

      * injected ``copy_fail`` → ``TransientCopyError`` → bounded retries
        with exponential backoff (``copy_retries``), then give-up
        (``copy_failures``) → degrade + inline fallback,
      * watchdog timeout (``fut.result(timeout=watchdog_s)``) →
        ``watchdog_timeouts`` → degrade + inline fallback,
      * degraded lane: every job computes inline on the caller thread,
        bypassing injection (``sync_fallbacks``) — correctness is never
        traded, only overlap.  ``begin()`` re-arms the lane.

    A job may carry ``after``, a CUDA event the host rows it reads depend on
    (the previous step's store-back into the arena); the worker waits on it
    before reading.
    """

    def __init__(self, *, timeline: Optional[MeasuredTimeline] = None,
                 faults: Optional[FaultPlan] = None,
                 watchdog_s: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.timeline = timeline if timeline is not None else MeasuredTimeline()
        self.faults = faults
        self.watchdog_s = watchdog_s
        self.degraded = False
        self._closed = False
        self._worker = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="host-attn")
        # a live view over ``host_attn_faults{key=...}`` counters with a
        # registry, a plain dict without one
        if metrics is None:
            self.counters: Dict[str, int] = {k: 0 for k in FAULT_COUNTER_KEYS}
        else:
            self.counters = CounterDictView(metrics, "host_attn_faults",
                                            keys=FAULT_COUNTER_KEYS)

    # ------------------------------------------------------------------ work
    def _attend(self, job: _HostJob, *, inject: bool):
        """The host partition; optionally consults the fault plan first
        (worker thread only — the inline fallback never injects)."""
        if inject and self.faults is not None:
            ev = self.faults.draw(HOST_ATTN_SITE,
                                  kinds=("stall", "copy_fail", "slow"))
            if ev is not None:
                if ev.kind == "copy_fail":
                    self.timeline.record_event("copy_fail_injected")
                    raise TransientCopyError(
                        f"injected host-attn fault at {HOST_ATTN_SITE}")
                if ev.kind == "stall":
                    self.counters["stalls_injected"] += 1
                self.timeline.record_event(f"{ev.kind}_injected")
                time.sleep(ev.seconds)
        if job.after is not None:
            job.after.synchronize()
        t0 = time.perf_counter()
        o, m, l, nbytes = host_flash_attention(job.q, job.hk, job.hv,
                                               job.kv_len)
        self.timeline.record("cpu", "cpu", t0, time.perf_counter(), nbytes)
        return o, m, l

    def submit(self, q: np.ndarray, hk, hv, kv_len: np.ndarray,
               after=None) -> _HostJob:
        """Enqueue one host partition.  ``q`` must already be host-side.  A
        degraded lane defers the inline compute to ``collect`` so the
        caller's dispatch pattern stays identical either way."""
        assert not self._closed, "submit() after close()"
        job = _HostJob(np.asarray(q), hk, hv, np.asarray(kv_len), after)
        if not self.degraded:
            job.fut = self._worker.submit(self._attend, job, inject=True)
        return job

    def collect(self, job: _HostJob):
        """Join one job through the watchdog/retry ladder; always returns a
        correct ``(o, m, l)`` partial."""
        while True:
            if job.fut is None:                        # degraded: inline sync
                self.counters["sync_fallbacks"] += 1
                self.timeline.record_event("sync_fallback")
                return self._attend(job, inject=False)
            try:
                return job.fut.result(timeout=self.watchdog_s)
            except FuturesTimeout:
                self.counters["watchdog_timeouts"] += 1
                self.timeline.record_event("watchdog_timeout")
                self.degraded = True
                job.fut = None
            except TransientCopyError:
                job.retries += 1
                if job.retries > MAX_COPY_RETRIES:
                    self.counters["copy_failures"] += 1
                    self.timeline.record_event("copy_give_up")
                    self.degraded = True
                    job.fut = None
                else:
                    self.counters["copy_retries"] += 1
                    self.timeline.record_event("copy_retry")
                    time.sleep(min(0.001 * (2 ** (job.retries - 1)), 0.05))
                    job.fut = self._worker.submit(self._attend, job,
                                                  inject=True)

    # ------------------------------------------------------------- lifecycle
    def begin(self) -> None:
        """Re-arm the lane at dispatch-window granularity (mirrors
        ``WeightStreamer.begin``)."""
        self.degraded = False

    def close(self) -> None:
        """Deterministic teardown; idempotent (context-manager exit)."""
        if not self._closed:
            self._closed = True
            self._worker.shutdown(wait=True)

    def __enter__(self) -> "HostAttnExecutor":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def lane_health(self) -> str:
        return "degraded" if self.degraded else "healthy"

    @property
    def fault_counters(self) -> Dict[str, int]:
        return dict(self.counters)
