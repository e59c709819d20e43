"""Layer-granular offload executor for one device: weight streaming
overlapped with KV Gen.  Counterpart of ``repro.offload.executor``.

The device-resident engine keeps every weight on the card.  When the weights
do not fit — HybridServe's actual regime — each layer's weights cross the
host link every step, and the schedulable unit is the layer.  This executor
is that regime: a Python loop at layer granularity where

  * the ``WeightStreamer`` copies layer ``l+1``'s weights on the copy stream
    while layer ``l``'s kernels (KV Gen from ACT checkpoints, attention, FFN)
    run on the compute stream,
  * an optionally *spilled* KV region lives in the pinned ``HostBlockPool``
    between steps: each layer's region rides the same copy stream up, and
    the new token's K/V row is copied back down into the arena,
  * with the CPU lane (``host_attn``) a spilled region never crosses the
    link: the host attends over it in place while the device attends over
    [recomputed ACT ; the new token's own row] with the hybrid kernel's
    ``return_lse`` mode, and the two partials merge,
  * every task is timed into a ``MeasuredTimeline`` whose per-step results
    share ``simulate_steps``'s schema; on the card the spans are CUDA events,
    so timing adds no host sync.  A ``tracer`` rides that timeline (each
    span reaches it once resolved) and a ``metrics`` registry backs the
    lanes' fault counters; neither adds a call or a sync.

Exactness: each layer runs the functions the device-resident path runs
(``models.model``'s prefill and decode stages and ``_hybrid_layer_step``),
so the same kernels launch and the tokens equal the device-resident path's
at any prefetch depth, with or without spill.

Quantized cache (``quant``): the regions already hold int8 codes and float16
scales on the device, so the spill, the per-step upload and the store-back
move those bytes as they are, and the uploaded slot feeds the kernels' int8
modes directly.  Unlike the reference, which keeps fake-quantized values on
the device, no host requantization (its ``np_quantize`` store-back) and no
dequantization on upload are needed; the CPU lane dequantizes the arena's
rows through the cache dtype, as the kernels do.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.kernels.hybrid_attention.ref import merge_partials_torch
from repro_torch.offload.host_attn import HostAttnExecutor, QuantPlane
from repro_torch.offload.host_pool import HostWeightPool, Region
from repro_torch.offload.streamer import WeightStreamer, timing_event
from repro_torch.offload.timeline import MeasuredTimeline

Cache = Dict[str, Any]
PAGE = M.PAGE


class OffloadExecutor:
    """Executes hybrid-cache inference with host-streamed layer weights.

    ``params``: the port's params dict (any device), or a ``HostWeightPool``
    already built from it, which several executors may share."""

    def __init__(self, cfg: ModelConfig, params, *, prefetch_depth: int = 1,
                 faults=None, watchdog_s: Optional[float] = None,
                 tracer=None, metrics=None, quant=None, device="cuda"):
        T.check_supported(cfg, "engine")
        self.cfg = cfg
        self.quant = quant
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.timeline = MeasuredTimeline(tracer=tracer)
        self.faults = faults
        self._watchdog_s = watchdog_s
        self._metrics = metrics
        # cpu attention lane: created on the first host-attend decode
        self.host_lane: Optional[HostAttnExecutor] = None
        self.pool = params if isinstance(params, HostWeightPool) else \
            HostWeightPool(cfg, params, device=self.device)
        if self.pool.device != self.device:
            raise ValueError(f"weight pool serves {self.pool.device}, "
                             f"executor runs on {self.device}")
        self.streamer = WeightStreamer(
            self.pool, prefetch_depth=prefetch_depth, timeline=self.timeline,
            faults=faults, watchdog_s=watchdog_s, metrics=metrics)
        self.resident = self.pool.resident
        self._mirror: Dict[str, torch.Tensor] = {}   # decode_chunk's host mirror
        self.dispatches = 0                     # stages issued (as the reference)
        # blocking host waits on the device: the final tokens, a spill-out or
        # a chunk's mirror pull, and the query of each host-attended layer
        self.blocking_syncs = 0

    def _now(self):
        """A timeline stamp: an event on the compute stream, or host time."""
        return timing_event() if self.cuda else time.perf_counter()

    def _as_dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

    # ================================================================ prefill
    def prefill_batched(self, tokens, kv_keep, last_pos, *, kv_cap: int,
                        act_cap: int) -> Tuple[torch.Tensor, Cache]:
        """Layer-streamed batched hybrid prefill: ``M.hybrid_prefill_batched``
        with each layer's weights arriving over the copy stream; the full
        parameter set is never device-resident.  -> (first token (B,), cache)."""
        cfg = self.cfg
        self.timeline.begin_step("prefill", now=self._now())
        pre = M.hybrid_prefill_begin(self.resident, cfg, self._as_dev(tokens),
                                     kv_cap, act_cap, kv_keep, last_pos,
                                     self.quant)
        self.dispatches += 1
        h = pre.h
        self.streamer.begin(range(cfg.num_layers))
        for l in range(cfg.num_layers):
            lp = self.streamer.acquire(l)
            t0 = self._now()
            h = M.hybrid_prefill_layer(lp, cfg, h, pre, l)
            self.timeline.record("gpu", "fwd", t0, self._now())
            self.dispatches += 1
            self.streamer.release(l)
        lg, cache = M.hybrid_prefill_end(self.resident, cfg, h, pre)
        self.dispatches += 1
        self.timeline.end_step(now=self._now())
        return lg[:, -1].argmax(-1).int(), cache

    # ============================================================ spill lane
    def _spill_out(self, cache: Cache, region: Region):
        """Move the whole KV region device→host into the arena and free the
        device copy.  -> the arena's planes [hk, hv] (L, B, kv_cap, KVH, D),
        with [hk_s, hv_s] (L, B, kv_cap, KVH, 1) after them for a quantized
        cache (codes first, then scales, in one region), and the KV lengths
        on the host."""
        planes, at, t0 = [], 0, self._now()
        for key in M.kv_planes(cache):
            t = cache[key]
            plane = region.view(tuple(t.shape), t.dtype, at)
            plane.copy_(t, non_blocking=True)
            planes.append(plane)
            at += t.numel() * t.element_size()
            cache[key] = None
        self.timeline.record("pcie_up", "st", t0, self._now(), at)
        kv_len = cache["kv_len"].cpu().numpy().copy()   # waits for the copies
        self.blocking_syncs += 1
        return planes, kv_len

    def _kv_bufs(self, slot: Optional[int]):
        """The device copies of one layer's arena planes for a weight slot
        (None: the degraded spare)."""
        key = "spare" if slot is None else slot
        if key not in self._kv_dev:
            self._kv_dev[key] = [torch.empty_like(p[0], device=self.device)
                                 for p in self._planes]
        return self._kv_dev[key]

    def _kv_stage(self, i: int, slot: Optional[int]) -> None:
        """The streamer's side copy for schedule position ``i``, issued on
        the copy stream just before its weights.  Skipped when the previous
        step's store-back of that layer is not issued yet (prefetch deeper
        than a step), and for the copies the streamer arms before the first
        decode step opens, so that every upload falls inside a step of the
        timeline, as the reference's do; ``_kv_for`` then uploads it in
        order."""
        if self._in_step and i - self.cfg.num_layers <= self._stored_upto:
            self._kv_upload(i, slot)

    def _kv_upload(self, i: int, slot: Optional[int]) -> None:
        """Layer ``i % L``'s spilled region (codes and scales when quantized)
        into the slot's buffers, on the current stream, after the layer's
        last store-back."""
        l = i % self.cfg.num_layers
        bufs = self._kv_bufs(slot)
        if self.cuda and self._stored_ev[l] is not None:
            torch.cuda.current_stream().wait_event(self._stored_ev[l])
        t0 = self._now()
        for buf, plane in zip(bufs, self._planes):
            buf.copy_(plane[l], non_blocking=True)
        self.timeline.record("pcie", "kv", t0, self._now(),
                             sum(b.numel() * b.element_size() for b in bufs))
        self._kv_staged[i] = slot

    def _kv_for(self, i: int):
        """Position ``i``'s uploaded KV pair; uploads it now, ordered on the
        compute stream, when the side copy was skipped."""
        if i not in self._kv_staged:
            self._kv_upload(i, self.streamer._live[i])
        return self._kv_bufs(self._kv_staged.pop(i))

    def _store_back(self, rows, l: int, kv_idx: np.ndarray,
                    store_np: np.ndarray) -> None:
        """Copy each KV-bound request's new row of every arena plane
        (``rows[p][b]``, device (KVH, D), or (KVH, 1) scales) into its arena
        slot: the per-step store traffic, D2H, asynchronous into pinned
        memory.  The event after it is what the next step's upload or host
        job of the layer waits on."""
        cap = self._planes[0].shape[2]
        t0 = self._now()
        nbytes = 0
        for b in range(len(store_np)):
            if not store_np[b]:                 # KV-bound token: row is new
                row = min(int(kv_idx[b]), cap - 1)
                for plane, r in zip(self._planes, rows):
                    plane[l, b, row].copy_(r[b], non_blocking=True)
                    nbytes += r[b].numel() * r[b].element_size()
        end = self._now()
        self.timeline.record("pcie_up", "st", t0, end, nbytes)
        self._stored_ev[l] = end if self.cuda else None

    # ------------------------------------------------- host-attend layer path
    def _ensure_host_lane(self) -> HostAttnExecutor:
        """Create (once) and re-arm the cpu attention lane, sharing the
        executor's timeline, fault plan, watchdog and metrics registry."""
        if self.host_lane is None:
            self.host_lane = HostAttnExecutor(
                timeline=self.timeline, faults=self.faults,
                watchdog_s=self._watchdog_s, metrics=self._metrics)
        self.host_lane.begin()
        return self.host_lane

    def _host_planes(self, l: int):
        """Layer ``l``'s K and V arena planes as the host lane reads them."""
        if len(self._planes) == 2:
            return self._planes[0][l], self._planes[1][l]
        dt = T.torch_dtype(self.cfg)
        return (QuantPlane(self._planes[0][l], self._planes[2][l], dt),
                QuantPlane(self._planes[1][l], self._planes[3][l], dt))

    def _ha_buffers(self, cache: Cache, keys, B: int):
        """The host-attend path's per-call buffers: the query's pinned host
        copy, a zero length per request, and -> the new token's own KV page
        of each KV plane ``keys``, in its format."""
        cfg = self.cfg
        self._zeros_b = torch.zeros((B,), dtype=torch.int32, device=self.device)
        if self.cuda:
            self._q_host = torch.empty((B, 1, cfg.num_heads, cfg.head_dim),
                                       dtype=T.torch_dtype(cfg), pin_memory=True)
        return [torch.zeros((B, PAGE) + cache[k].shape[3:], dtype=cache[k].dtype,
                            device=self.device) for k in keys]

    def _ha_layer(self, lane, lp, x, ac, act_s, act_len, store, store_np,
                  plan, ha_tables, own, l: int, kv_len_np, dev_kv=None):
        """One host-attend layer against the spilled arena.  The region
        never crosses the link: the query goes D2H, the host partial's
        statistics H2D, the new row D2H.  The device partial attends over
        [the new token's own row ; the ACT region] — the own row is a
        one-token KV page valid only for a KV-bound token, the ACT region
        holds the checkpoint of an ACT-bound one — so with the host's rows
        [0, kv_len) the two partitions are exactly the one-pool valid set.
        Quantized, ``own`` holds codes and scales (the KV-bound row is read
        back dequantized), and the ACT-bound token attends to its exact K/V
        as on the device-resident path.  ``dev_kv`` (the scheduler's chunk):
        the layer's device KV planes and lengths, ``(planes, kv_len)``; the
        new row is written there too, as ``_hybrid_layer_step`` writes it,
        and the arena planes are the chunk's host mirror."""
        cfg = self.cfg
        B = x.shape[0]
        t0 = self._now()
        q, k, v = M._layer_qkv(lp, cfg, x, plan.act_kv)
        if self.cuda:
            self._q_host.copy_(q, non_blocking=True)
            q_ready = timing_event()
        scales = M.plane_scales(own, act_s)
        M._write_new(own[0], own[1], ac, k, v, x[:, 0], self._zeros_b, act_len,
                     store, scales)
        if dev_kv is not None:
            planes, kv_len = dev_kv
            ar = torch.arange(B, device=self.device)
            ki = kv_len.clamp(max=planes[0].shape[1] - 1).long()
            on = plan.write_on[0].view(B, 1, 1)
            for plane, row in zip(planes, own):
                plane[ar, ki] = torch.where(on, row[:, 0], plane[ar, ki])
        exact = M.OwnRow(k, v, act_len, store) \
            if scales is not None and plan.exact_own else None
        o_d, m_d, l_d = M._hybrid_attend(lp, cfg, q, own[0], own[1], ac,
                                         ha_tables, plan.act_kv, return_lse=True,
                                         scales=scales, own=exact)
        self.timeline.record("gpu", "fwd", t0, self._now())
        self.dispatches += 2                    # projections, device partial
        if self.cuda:
            q_ready.synchronize()               # the partial runs on meanwhile
            q_np = self._q_host.float().numpy()
        else:
            q_np = q.float().numpy()
        self.blocking_syncs += 1
        G = cfg.num_heads // cfg.num_kv_heads
        job = lane.submit(q_np.reshape(B, cfg.num_kv_heads, G, cfg.head_dim),
                          *self._host_planes(l), kv_len_np,
                          after=self._stored_ev[l])
        o_h, m_h, l_h = (torch.from_numpy(a).to(self.device)
                         for a in lane.collect(job))
        t0 = self._now()
        o, _, _ = merge_partials_torch(o_d.float(), m_d, l_d, o_h, m_h, l_h)
        x = M._layer_out(lp, cfg, x, o.to(x.dtype))
        self.timeline.record("gpu", "fwd", t0, self._now())
        self.dispatches += 1
        self._store_back([p[:, 0] for p in own], l, kv_len_np, store_np)
        return x

    # ================================================================= decode
    def decode_loop(self, cur, cache: Cache, store_sched, *,
                    spill_region: Optional[Region] = None,
                    host_attn: bool = False, pages_bound=None,
                    act_pages_bound=None) -> Tuple[np.ndarray, Cache]:
        """Layer-streamed greedy generation, token-exact vs
        ``M.hybrid_decode_loop``.

        cur:          (B,) int32 — first token to emit.
        store_sched:  (n_steps, B) bool — per-step store_act flags.
        spill_region: when given, the KV region lives in this pinned host
                      region between steps: every layer's region is uploaded
                      per step and the new token's row stored back.
        host_attn:    spill mode only — instead of uploading the region
                      every step, the cpu lane attends over it in place:
                      only softmax statistics and the new row cross the link.
        pages_bound, act_pages_bound: as for ``M.hybrid_decode_step``.

        The cache is updated in place (its KV region is freed in spill
        mode).  Returns ``(tokens (B, n_steps) int32 numpy, final cache)``.
        """
        cfg = self.cfg
        L = cfg.num_layers
        sched = np.asarray(store_sched, bool)
        n_steps, B = sched.shape
        spill = spill_region is not None
        if host_attn and not spill:
            raise ValueError("host_attn requires a spilled KV region")
        lane = self._ensure_host_lane() if host_attn else None
        sched_dev = torch.from_numpy(np.ascontiguousarray(sched)).to(self.device)
        kv_len_np = None
        self._stored_ev: List[Optional[object]] = [None] * L
        self._stored_upto = -1
        self._kv_staged: Dict[int, Optional[int]] = {}
        self._kv_dev: Dict[Any, List[torch.Tensor]] = {}
        quant = self.quant is not None
        keys = M.kv_planes(cache)
        side = None
        if spill:
            self._planes, kv_len_np = self._spill_out(cache, spill_region)
            # the arena stands in for the region (its shape sizes the tables)
            cache = dict(cache, **dict(zip(keys, self._planes)))
            if not host_attn:
                side = self._kv_stage
        if host_attn:
            own = self._ha_buffers(cache, keys, B)
            act_cap = cache["act"].shape[2]
        toks: List[torch.Tensor] = []
        self._in_step = False
        self.streamer.begin([l for _ in range(n_steps) for l in range(L)],
                            side=side)
        seq = 0
        for s in range(n_steps):
            self.timeline.begin_step("decode", now=self._now())
            self._in_step = True
            store = sched_dev[s]
            plan = M.hybrid_decode_begin(self.resident, cfg, cur[:, None],
                                         cache, store, pages_bound=pages_bound,
                                         act_pages_bound=act_pages_bound,
                                         quant=self.quant,
                                         any_act=bool(sched[s].any()))
            self.dispatches += 1
            if host_attn:
                n_act = plan.act_stride // PAGE if plan.act_kv is not None \
                    else act_cap // PAGE if act_pages_bound is None \
                    else min(int(act_pages_bound), act_cap // PAGE)
                ha_tables = M.hybrid_page_table((~store).int(), plan.act_read,
                                                PAGE, plan.act_stride, 1 + n_act)
            x = plan.x
            for l in range(L):
                lp = self.streamer.acquire(seq)
                ac = cache["act"][l]
                act_s = cache["act_s"][l] if quant else None
                if host_attn:
                    x = self._ha_layer(lane, lp, x, ac, act_s, cache["act_len"],
                                       store, sched[s], plan, ha_tables, own, l,
                                       kv_len_np)
                else:
                    bufs = self._kv_for(seq) if spill else \
                        [cache[key][l] for key in keys]
                    t0 = self._now()
                    x = M._hybrid_layer_step(lp, cfg, x, bufs[0], bufs[1], ac,
                                             cache["kv_len"], cache["act_len"],
                                             store, plan.tables, plan.act_kv,
                                             M.plane_scales(bufs, act_s),
                                             plan.exact_own)
                    self.timeline.record("gpu", "fwd", t0, self._now())
                    self.dispatches += 1
                    if spill:
                        ar = torch.arange(B, device=self.device)
                        ki = cache["kv_len"].clamp(max=bufs[0].shape[1] - 1).long()
                        self._store_back([b[ar, ki] for b in bufs], l, kv_len_np,
                                         sched[s])
                if spill:
                    self._stored_upto = seq
                self.streamer.release(seq)
                seq += 1
            toks.append(cur)
            lg = M.hybrid_decode_end(self.resident, cfg, x, cache, store)
            cur = lg[:, -1].argmax(-1).int()
            self.dispatches += 1
            if spill:
                kv_len_np = kv_len_np + (~sched[s]).astype(kv_len_np.dtype)
            self.timeline.end_step(now=self._now())
        out = (torch.stack(toks, 1).cpu().numpy() if toks
               else np.zeros((B, 0), np.int32))
        self.blocking_syncs += 1
        if spill:
            cache = dict(cache, **{key: None for key in keys})
            self._planes = None
        self._kv_dev = {}
        return out, dict(cache, spilled=spill)

    # ========================================= the scheduler's decode paths
    def _mirror_out(self, cache: Cache, kv_b: int):
        """The chunk's host mirror of the KV region: rows [0, kv_b) of every
        KV plane (codes and scales when quantized), in one bulk device→host
        pull into host buffers the executor keeps across chunks (pinned on
        the card), timed as a span of its own (tag "mirror" on the link
        lane).  The device cache stays the source of truth.  -> (the
        mirror's planes (L, B, kv_b, ...), the KV lengths on the host)."""
        t0 = self._now()
        planes, nbytes = [], 0
        for key in M.kv_planes(cache):
            t = cache[key]
            buf = self._mirror.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
                self._mirror[key] = buf
            plane = buf[:, :, :kv_b]
            plane.copy_(t[:, :, :kv_b], non_blocking=True)
            planes.append(plane)
            nbytes += plane.numel() * plane.element_size()
        self.timeline.record("pcie", "mirror", t0, self._now(), nbytes)
        kv_len = cache["kv_len"].cpu().numpy().copy()   # waits for the copies
        self.blocking_syncs += 1
        return planes, kv_len

    def decode_chunk(self, cur, cache: Cache, store_sched, active_sched, *,
                     kv_bound: Optional[int] = None,
                     act_bound: Optional[int] = None, host_attn: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray, Cache]:
        """Chunked layer-streamed decode over the server's slot cache,
        token-exact vs ``M.hybrid_decode_chunk``: the continuous-batching
        server's offload hot path.

        The cache is one tensor per plane with the layer axis first, updated
        in place, so nothing is unstacked or restacked.  The streamer's
        prefetch window spans the whole chunk's layer sequence, so the copy
        stream rolls from step s's last layers into step s+1's first ones.

        cur:          (B,) int32 (host or device) — next token per slot.
        store_sched:  (n_steps, B) bool — store_act flags.
        active_sched: (n_steps, B) bool — inactive slots keep their carried
                      token and frozen lengths and emit -1.
        kv_bound / act_bound: token bounds on the regions' occupancy, page
                      multiples covering every active slot's lengths within
                      the chunk (the page tables' widths derive from them).
        host_attn:    each layer's KV-region attention runs on the cpu lane
                      over the chunk's host mirror of the region up to
                      ``kv_bound`` (one bulk pull; each step's new rows are
                      appended to it), while the device attends over [the new
                      row ; the ACT region] (``return_lse``) and the two
                      partials merge.
        -> (tokens (B, n_steps) int32 numpy with -1 at inactive entries,
            next cur (B,) int32 numpy, cache)."""
        cfg = self.cfg
        L = cfg.num_layers
        act_np = np.asarray(active_sched, bool)
        sched = np.asarray(store_sched, bool) & act_np
        n_steps, B = sched.shape
        kv_cap, act_cap = cache["k"].shape[2], cache["act"].shape[2]
        kv_b = kv_cap if kv_bound is None else min(int(kv_bound), kv_cap)
        act_b = act_cap if act_bound is None else min(int(act_bound), act_cap)
        bounds = dict(pages_bound=kv_b // PAGE + act_b // PAGE,
                      act_pages_bound=act_b // PAGE)
        sched_dev = torch.from_numpy(np.ascontiguousarray(sched)).to(self.device)
        act_dev = torch.from_numpy(np.ascontiguousarray(act_np)).to(self.device)
        cur = torch.as_tensor(np.asarray(cur, np.int32)).to(self.device)
        keys = M.kv_planes(cache)
        quant = self.quant is not None
        lane = None
        self._stored_ev: List[Optional[object]] = [None] * L
        if host_attn:
            lane = self._ensure_host_lane()
            self.timeline.begin_step("mirror", now=self._now())
            self._planes, kv_len_np = self._mirror_out(cache, kv_b)
            self.timeline.end_step(now=self._now())
            own = self._ha_buffers(cache, keys, B)
        toks: List[torch.Tensor] = []
        self.streamer.begin([l for _ in range(n_steps) for l in range(L)])
        seq = 0
        for s in range(n_steps):
            self.timeline.begin_step("decode", now=self._now())
            store, active = sched_dev[s], act_dev[s]
            kv_len, act_len = cache["kv_len"], cache["act_len"]
            plan = M.hybrid_decode_begin(self.resident, cfg, cur[:, None],
                                         cache, store, quant=self.quant,
                                         any_act=bool(sched[s].any()),
                                         **bounds)
            self.dispatches += 1
            if host_attn:
                n_act = plan.act_stride // PAGE if plan.act_kv is not None \
                    else bounds["act_pages_bound"]
                ha_tables = M.hybrid_page_table((~store).int(), plan.act_read,
                                                PAGE, plan.act_stride, 1 + n_act)
                # an inactive slot's host partition is empty, and its row
                # is not appended to the mirror
                lane_len = np.where(act_np[s], kv_len_np, 0)
                skip = sched[s] | ~act_np[s]
            x = plan.x
            for l in range(L):
                lp = self.streamer.acquire(seq)
                ac = cache["act"][l]
                act_s = cache["act_s"][l] if quant else None
                bufs = [cache[key][l] for key in keys]
                if host_attn:
                    x = self._ha_layer(lane, lp, x, ac, act_s, act_len, store,
                                       skip, plan, ha_tables, own, l, lane_len,
                                       dev_kv=(bufs, kv_len))
                else:
                    t0 = self._now()
                    x = M._hybrid_layer_step(lp, cfg, x, bufs[0], bufs[1], ac,
                                             kv_len, act_len, store,
                                             plan.tables, plan.act_kv,
                                             M.plane_scales(bufs, act_s),
                                             plan.exact_own, plan.write_on)
                    self.timeline.record("gpu", "fwd", t0, self._now())
                    self.dispatches += 1
                self.streamer.release(seq)
                seq += 1
            toks.append(torch.where(active, cur, -1))
            lg = M.hybrid_decode_end(self.resident, cfg, x, cache, store)
            M._freeze_inactive(cache, active, kv_len, act_len)
            cur = torch.where(active, lg[:, -1].argmax(-1).int(), cur)
            self.dispatches += 1
            if host_attn:
                kv_len_np = kv_len_np + (~sched[s] & act_np[s])
            self.timeline.end_step(now=self._now())
        out = torch.cat([M._stack(toks, cur), cur[:, None]], 1).cpu().numpy()
        self.blocking_syncs += 1
        self._planes = None
        return out[:, :n_steps], out[:, n_steps], cache

    # ================================================================== misc
    def drain_timeline(self, tag: Optional[str] = "decode"):
        """Collect-and-reset the measured per-step ``TimelineResult``s."""
        return self.timeline.drain(tag)

    def close(self) -> None:
        """Deterministic teardown: drains the copy stream and joins the cpu
        attention lane's worker.  Also the context-manager exit."""
        self.streamer.close()
        if self.host_lane is not None:
            self.host_lane.close()

    def __enter__(self) -> "OffloadExecutor":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def lane_health(self) -> str:
        """"healthy" | "degraded" — the weight lane's current state."""
        return self.streamer.lane_health

    @property
    def fault_counters(self) -> Dict[str, int]:
        """Cumulative robustness counters of the weight lane."""
        return self.streamer.fault_counters
