"""Chunked continuous batching on the hybrid KV/ACT cache (counterpart of
``repro.serving.scheduler``).

Orca-style scheduling: a fixed pool of ``slots`` decode slots; finished
requests leave and queued arrivals are admitted at CHUNK boundaries.

  * every chunk of ``chunk_steps`` iterations is ONE call,
    ``M.hybrid_decode_chunk`` (greedy sampling, per-slot store flags and
    active masks all on the device, the slot cache updated in place), then
    ONE readback of the chunk's tokens and next tokens, not one per token,
  * all arrivals queued at a chunk boundary are coalesced into ONE batched
    prefill (``M.hybrid_prefill_batched``) whose rows are scattered into the
    free slots, every plane of the region (int8 codes and their scales),
  * the per-slot store schedule is precomputed on the host
    (``core.policy.store_act_schedule``) and replayed after the call
    through the ``BlockManager`` for block accounting,
  * TTFT / TBT are reconstructed per step from ``simulate_steps``,
  * the per-slot lengths the host mirrors bound both regions' occupancy; the
    bounds, page-aligned, set the width of the decode kernels' page tables.

``chunk_steps=1`` is the classic step server.  Pressure recovery (preempt,
park, resume through a re-prefill) is ``serving.recovery``'s.

``adaptive=True`` runs the hybrid-cache controller between chunks;
``tracer=``/``metrics=`` record each request's lifecycle, the server's
admission and chunk spans, the lane timelines and the counters, with TTFT and
TBT histograms.  Both are host-side, on results the chunk already read.

``plan=`` serves tensor-parallel over a ``ShardPlan``'s mesh
(``models.sharded``): the slot cache is laid out under ``plan.cache_spec``
(slots over 'data' where they divide), an admission batch is prefilled by
the data rows that own its slots (an MoE model's rows each prefill all of
it: its dispatch groups span the batch), and the chunk structure (one call
and one readback per admission batch and per chunk) holds on every mesh.
"""
from __future__ import annotations

from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.blocks import BLOCK_TOKENS, BlockManager, BlockType
from repro_torch.core.controller import ControllerConfig, HybridCacheController
from repro_torch.core.pipeline import MiniBatchSpec, simulate_steps
from repro_torch.core.policy import (HostAllocation, device_act_blocks,
                                     host_block_allocation,
                                     store_act_schedule)
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import Request
from repro_torch.models import model as M
from repro_torch.models import sharded as SHD
from repro_torch.models import transformer as T
from repro_torch.obs import (NULL_TRACER, DriftMonitor, fold_timeline_metrics,
                             register_busy_fraction_collector)
from repro_torch.serving.recovery import (CapacityError, ParkedRequest,
                                          RecoveryConfig, RecoveryStats,
                                          blocks_for_tokens, resume_cost)
from repro_torch.serving.util import (bucket, collect_block_metrics, kv_keep_for,
                                     pack_group, retag_toward, trace_ctx)
from repro_torch.sharding import collectives as C


@dataclass
class SlotState:
    rid: int = -1
    remaining: int = 0
    kv_tokens: int = 0          # host mirror of this slot's device kv_len
    act_tokens: int = 0         # host mirror of this slot's device act_len
    generated: List[int] = field(default_factory=list)
    preempts: int = 0           # times this request has been preempted
    request: Optional[Request] = None   # original request (resume prefix)

    @property
    def active(self) -> bool:
        return self.rid >= 0


@dataclass
class ServeStats:
    steps: int = 0              # decode iterations executed (sub-chunk)
    chunks: int = 0             # chunked decode calls
    admission_batches: int = 0  # coalesced prefill calls
    admitted: int = 0           # requests admitted across all batches
    generated_tokens: int = 0
    device_calls: int = 0       # device-resident: one per admission batch
    #                             and per chunk; offload: the executor's stages
    # blocking device->host readbacks.  Device-resident: one per chunk and
    # one per admission batch.  Offload: the executor's own count
    # (OffloadExecutor.blocking_syncs)
    host_syncs: int = 0
    sim_time: float = 0.0
    measured_time: float = 0.0  # offload: the measured decode steps (else 0)
    ttft: Dict[int, float] = field(default_factory=dict)
    tbt: Dict[int, float] = field(default_factory=dict)
    completed_at: Dict[int, int] = field(default_factory=dict)  # rid -> step

    @property
    def throughput(self) -> float:
        return self.generated_tokens / self.sim_time if self.sim_time else 0.0

    @property
    def dispatches_per_token(self) -> float:
        return (self.device_calls / self.generated_tokens
                if self.generated_tokens else 0.0)


def scatter_rows(cache, new, slot_idx) -> None:
    """Write an admission batch's prefill cache ``new`` into rows
    ``slot_idx`` (k,) of the server's ``cache``, in place: every region plane
    (layer axis first; int8 codes and their scales), then the per-slot
    ``act_pos`` and lengths."""
    for key in M.region_planes(cache):
        cache[key][:, slot_idx] = new[key]
    for key in ("act_pos", "kv_len", "act_len"):
        cache[key][slot_idx] = new[key]


class ContinuousBatchingServer:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 kv_cap: int = 256, act_cap: int = 256,
                 chunk_steps: int = 1,
                 hw: cm.HardwareSpec = cm.H100_SXM, generalized: bool = True,
                 offload: bool = False, prefetch_depth: int = 1,
                 adaptive: bool = False,
                 ctl: Optional[ControllerConfig] = None, plan=None,
                 recovery: Optional[RecoveryConfig] = None,
                 faults=None, watchdog_s: Optional[float] = None,
                 host_kv_blocks: Optional[int] = None,
                 host_act_blocks: Optional[int] = None,
                 dev_kv_blocks: Optional[int] = None,
                 dev_act_blocks: Optional[int] = None,
                 tracer=None, metrics=None,
                 quant: Optional[QuantConfig] = None,
                 host_attn: bool = False, device="cuda"):
        """``params`` must live on ``device`` (the admission prefill runs the
        resident weights, under ``offload`` too).

        chunk_steps: decode iterations per call.  1 is the step server; S > 1
        runs S masked steps per call, admitting and retiring only at chunk
        boundaries: calls per generated token fall toward 1/S while an
        arrival may wait up to S steps.

        generalized: the Algorithm-1 variant of the allocation and of the
        adaptive controller's retarget (True: the byte-ratio-aware balance;
        False: the paper's).

        offload=True decodes through the layer-streamed ``OffloadExecutor``
        (``prefetch_depth`` layers of weights in flight ahead of compute):
        weights stream from pinned host memory each iteration, with the
        prefetch window spanning the whole chunk; ``measured_steps`` holds
        the measured per-iteration timelines.  Admission still runs the
        batched prefill on the resident ``params``, as the reference's does,
        so this mode keeps a device copy of the weights.  Tokens are the
        device-resident server's.

        recovery=RecoveryConfig(...) arms pressure recovery (on by default):
        pool exhaustion preempts victims (KV demoted to ACT checkpoints when
        ACT capacity exists, else dropped to token IDs) into a bounded
        re-admission queue; resumes re-prefill over prompt + generated
        prefix.  ``RecoveryConfig(max_parked=0)`` fails loud
        (``CapacityError``).

        host_kv_blocks / host_act_blocks / dev_kv_blocks / dev_act_blocks
        override the Algorithm-1 pool sizes (the pressure tests' knob).

        quant=QuantConfig() keeps the slot cache as int8 codes with float16
        scales; the policy and block accounting price those bytes.

        host_attn=True (offload only): each chunk's KV-region attention runs
        on the cpu lane over a host mirror of the region.

        faults / watchdog_s: the offload lanes' ``FaultPlan`` and watchdog
        deadline, handed to the ``OffloadExecutor`` (offload only).

        adaptive=True runs the ``HybridCacheController`` between chunks:
        each chunk's timelines (measured under offload, simulated
        otherwise) refit the cost model, and the ACT:KV target that drives
        the per-slot store schedule follows the refit allocation, mirrored
        onto the host pools by bounded capacity retags.  ``ctl`` defaults
        to ``ControllerConfig(update_every=4)``.

        tracer / metrics: an ``obs.Tracer`` (request roots with admit,
        prefill, decode, preempt, park, resume and complete; admit and
        chunk server spans; the executor's lane spans) and an
        ``obs.MetricsRegistry`` (``RecoveryStats`` as ``recovery_*``
        counters, ``ttft_s``/``tbt_s`` histograms, timeline folds; read
        with ``snapshot()``).  Tokens, calls and syncs are those of a run
        without.

        plan=ShardPlan: tensor-parallel over the plan's mesh (``params`` on
        any device; laid out on the positions').  The slot cache follows
        ``plan.cache_spec``, the policy stack prices
        ``scale_for_shards(hw, plan.shard_factor)``, and under ``offload``
        each position streams its own weight slice.  Every combination
        above serves under a plan: the int8 cache (its scale planes laid
        out with their payloads), the CPU lane (a host mirror per
        position), MoE (each data row prefills the whole admission batch,
        whose dispatch groups it shares)."""
        T.check_supported(cfg, "server")
        plan, self.device, hw, shards = SHD.resolve_plan(
            cfg, plan, device, hw, quant)
        self.plan = plan
        if host_attn and not offload:
            raise ValueError("host_attn rides the offload runtime's host mirror")
        self.host_attn = bool(host_attn)
        self.quant = quant
        self.cfg, self.params, self.hw = cfg, params, hw
        self.n_slots, self.kv_cap, self.act_cap = slots, kv_cap, act_cap
        self.chunk_steps = max(int(chunk_steps), 1)
        # telemetry, host-side only: NULL_TRACER is off
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.drift = DriftMonitor(registry=metrics)
        if metrics is not None:
            register_busy_fraction_collector(metrics)
            metrics.register_collector(self._collect_metrics)
        dev_act = device_act_blocks(cfg, hw, quant=quant)
        self.alloc = host_block_allocation(cfg, hw, dev_act,
                                           generalized=generalized, quant=quant)
        self.act_frac = self.alloc.act_fraction
        self.controller: Optional[HybridCacheController] = None
        if adaptive:
            self.controller = HybridCacheController(
                cfg, hw, self.alloc, dev_act, generalized=generalized,
                ctl=ctl if ctl is not None else
                ControllerConfig(update_every=4), drift=self.drift,
                quant=quant, cpu=host_attn)
        # physical block accounting, replayed per chunk from the precomputed
        # store schedule: host pools in the Algorithm-1 split, device pools
        # as the engine sizes them
        self.blockman = BlockManager(
            cfg,
            host_kv_blocks=(host_kv_blocks if host_kv_blocks is not None
                            else max(self.alloc.kv_blocks, 1)),
            host_act_blocks=(host_act_blocks if host_act_blocks is not None
                             else max(self.alloc.act_blocks, 1)),
            dev_kv_blocks=(dev_kv_blocks if dev_kv_blocks is not None
                           else 64),
            dev_act_blocks=(dev_act_blocks if dev_act_blocks is not None
                            else dev_act),
            shard_factor=shards, quant=quant)
        self.recovery = recovery if recovery is not None else RecoveryConfig()
        self.recovery_stats = RecoveryStats(metrics)
        self.parked: List[ParkedRequest] = []
        self.fits = cm.profile_cost_fns(cfg, hw, quant=quant)
        # offload: per-iteration timelines drained out of the executor per
        # chunk (keeping its span store bounded), kept for measured_steps
        self._measured: List = []
        if plan is None:
            self.cache = M.init_hybrid_cache(cfg, slots, kv_cap, act_cap,
                                             device=self.device, quant=quant)
        else:
            self._layout = SHD.Layout(plan, quant)
            self._rows = SHD.rows_for(plan, slots)
            self.cache = SHD.init_cache(self._layout, slots, kv_cap, act_cap)
        self.slots = [SlotState() for _ in range(slots)]
        self.executor = None
        if offload:
            from repro_torch.offload import OffloadExecutor
            self.executor = OffloadExecutor(
                cfg, params, prefetch_depth=prefetch_depth, faults=faults,
                watchdog_s=watchdog_s,
                tracer=tracer, metrics=metrics, quant=quant, plan=plan,
                device=self.device)
        if plan is not None:
            # admission runs the resident weights, under offload too
            self.params = plan.place_params(params)
        self._cur_tok = np.zeros((slots,), np.int32)

    @property
    def measured_steps(self):
        """Measured per-iteration timelines (offload mode; else empty)."""
        if self.executor is None:
            return []
        return self._measured + self.executor.timeline.results("decode")

    def snapshot(self) -> Dict[str, object]:
        """One-call observability read: TTFT/TBT percentiles, lane busy
        fractions, fault and recovery counters, block occupancy and per-lane
        predictor drift (the registry's snapshot with its collectors run,
        and the drift monitor's summary; the summary alone without a
        registry)."""
        out: Dict[str, object] = (self.metrics.snapshot()
                                  if self.metrics is not None else {})
        out["predictor_drift"] = self.drift.summary()
        return out

    def _collect_metrics(self, reg) -> None:
        """Pull-style collector: occupancy by tag, retags, parked depth and
        controller state, read at ``snapshot()`` time, never on the hot
        path."""
        collect_block_metrics(reg, self.blockman, self.act_frac,
                              self.controller)
        reg.gauge("parked_requests").set(len(self.parked))
        if self.plan is not None:
            C.record(reg)

    def close(self) -> None:
        """Shut down the offload executor (no-op device-resident): it owns a
        copy stream's buffers and a cpu-lane worker thread."""
        if self.executor is not None:
            self.executor.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _as_dev(self, a) -> torch.Tensor:
        return M.upload(a, self.device)

    # ------------------------------------------------------------- admission
    def _admit(self, tokens, kv_keep, last_pos, slot_idx) -> np.ndarray:
        """ONE call per admission batch: the group-batched prefill, greedy
        sample of its logits, and the scatter of the new rows into the free
        slots of the server cache; the first tokens reach the host in one
        readback.  -> (k,) int32."""
        if self.plan is not None:
            return self._admit_sharded(tokens, kv_keep, last_pos, slot_idx)
        lg, new = M.hybrid_prefill_batched(
            self.params, self.cfg, self._as_dev(tokens), self.kv_cap,
            self.act_cap, kv_keep, last_pos, quant=self.quant)
        scatter_rows(self.cache, new, self._as_dev(slot_idx).long())
        return lg[:, -1].argmax(-1).int().cpu().numpy()

    def _admit_sharded(self, tokens, kv_keep, last_pos, slot_idx) -> np.ndarray:
        """``_admit`` over the plan's mesh: each data row prefills the
        admitted requests whose slots it holds and scatters them into its
        slots; the rows' first tokens are gathered for the one readback.
        An MoE model's rows each prefill the whole admission batch (its
        dispatch groups span the batch, fault N) and scatter their own."""
        rows, order, ins = [], [], []
        whole = self.cfg.is_moe and self.plan.batch_split(self.n_slots)
        for row in self._rows:
            sel = np.nonzero(np.isin(slot_idx, row.bidx))[0]
            if not len(sel):
                continue
            rows.append(row)
            order.append(sel)
            ins.append((tokens, kv_keep, last_pos) if whole else
                       (tokens[sel], kv_keep[sel], last_pos[sel]))
        with trace_ctx(self.plan):
            curs, caches, _ = SHD.prefill_rows(
                self._layout, self.params, rows, *zip(*ins),
                kv_cap=self.kv_cap, act_cap=self.act_cap)
            for row, sel, new in zip(rows, order, caches):
                if whole:
                    new = [SHD.select_rows(n, M.upload(sel, d).long())
                           for n, d in zip(new, row.devs)]
                local = M.upload(slot_idx[sel] - row.bidx[0], row.devs[0])
                SHD.scatter_rows(self.cache, row, new, local.long())
        if whole:
            return curs[0].cpu().numpy()
        if not self.plan.batch_split(self.n_slots):
            return curs[0].cpu().numpy()
        dev = self.plan.mesh.devices[0]
        got = C.all_gather(curs, 0, [dev], kind="batch")[0].cpu().numpy()
        out = np.empty_like(got)
        out[np.concatenate(order)] = got
        return out

    def _admission_split(self, pb: int) -> Tuple[int, int]:
        """(kv_tokens, act_tokens) the admission prefill will use for a
        ``pb``-token prefix: ``pack_group``'s clamped Eq. 11 split, for
        pre-admission capacity forecasting."""
        kk = kv_keep_for(pb, self.act_frac, self.kv_cap, self.act_cap,
                         clamp=True)
        return kk, pb - kk

    def _plan_admission(self, queue: List[Request]
                        ) -> List[Tuple[int, Request,
                                        Optional[ParkedRequest]]]:
        """Chunk-boundary admission plan: parked resumes strictly first, then
        queued arrivals, each checked against the free block pools so that
        admission cannot cause the exhaustion it exists to relieve.  What
        does not fit stays parked or queued.  Mutates ``self.parked`` and
        ``queue`` for what it admits."""
        free_slots = [i for i, s in enumerate(self.slots) if not s.active]
        free_kv = self.blockman.free_blocks(BlockType.KV)
        free_act = self.blockman.free_blocks(BlockType.ACT)
        out: List[Tuple[int, Request, Optional[ParkedRequest]]] = []
        for slot in free_slots:
            if self.parked:
                pk = self.parked[0]
                kk, at = self._admission_split(bucket(pk.prefix_tokens))
                kb, ab = blocks_for_tokens(0, kk), blocks_for_tokens(0, at)
                # an "act" resume releases its parked holdings on admission
                credit = (self.blockman.counts(pk.rid)["act_blocks"]
                          if pk.mode == "act" else 0)
                if kb <= free_kv and ab <= free_act + credit:
                    free_kv -= kb
                    free_act += credit - ab
                    out.append((slot, pk.request, self.parked.pop(0)))
                    continue
                break           # head-of-line blocked: hold all admissions
            if not queue:
                break
            kk, at = self._admission_split(bucket(len(queue[0].prompt)))
            kb, ab = blocks_for_tokens(0, kk), blocks_for_tokens(0, at)
            if kb > free_kv or ab > free_act:
                break           # backpressure: wait for blocks to free
            free_kv -= kb
            free_act -= ab
            out.append((slot, queue.pop(0), None))
        return out

    def _admit_batch(self, assignments: List[Tuple[int, Request,
                                                   Optional[ParkedRequest]]],
                     stats: ServeStats) -> None:
        """Admit every planned candidate in ONE batched prefill.  A resume
        rides the same call: its prefix is the bucket-padded prompt plus the
        generated tokens, its parked holdings are released first, and its
        simulated cost is added to sim_time."""
        k = len(assignments)
        reqs: List[Request] = []
        lens: List[int] = []      # true prefill lengths (-1: the bucket)
        rstats = self.recovery_stats
        for _, r, pk in assignments:
            if pk is None:
                # a fresh admission opens the request's root span; a resume
                # re-enters the root its first admission opened
                self.tracer.request_begin(r.rid, prompt_tokens=len(r.prompt),
                                          max_new=r.max_new_tokens)
                reqs.append(r)
                lens.append(-1)
                continue
            self.tracer.request_event(r.rid, "resume", mode=pk.mode,
                                      generated=len(pk.generated))
            if pk.mode == "act":
                self.blockman.free_request(pk.rid)
                rstats.resume_from_act += 1
            else:
                rstats.resume_from_tokens += 1
            rstats.resumes += 1
            cost = resume_cost(self.cfg, self.hw, self.fits,
                               pk.prefix_tokens, pk.mode)
            rstats.resume_cost_s += cost
            stats.sim_time += cost
            # the resume prefix: the prompt as admitted (padded to its bucket
            # with its last token) plus every generated token; its true
            # length is this row's last_pos, so the padding of the re-prefill
            # cannot shift the resumed positions
            pp = np.asarray(r.prompt, np.int32)
            pad = bucket(len(pp)) - len(pp)
            prefix = np.concatenate([pp, np.full((pad,), pp[-1], np.int32),
                                     np.asarray(pk.generated, np.int32)])
            reqs.append(Request(rid=r.rid, prompt=prefix,
                                max_new_tokens=pk.remaining))
            lens.append(len(prefix))
        try:
            toks, kv_keep, pbs = pack_group(reqs, self.act_frac, self.kv_cap,
                                            self.act_cap, clamp=True)
        except ValueError as e:
            raise CapacityError(
                f"admission prefix does not fit the cache regions: {e}",
                rids=[r.rid for r in reqs], resource="cache region",
                hint="raise kv_cap/act_cap or shorten prompts") from e
        lens = [pbs[j] if lens[j] < 0 else lens[j] for j in range(k)]
        kv_keep = np.asarray(kv_keep, np.int32).copy()
        for j, tl in enumerate(lens):
            if tl != pbs[j]:
                # resume row: the bucket's split re-clamped into the true
                # prefix length's window (ACT span <= act_cap, KV <= kv_cap)
                kv_keep[j] = min(max(int(kv_keep[j]),
                                     max(tl - self.act_cap, 0)),
                                 min(self.kv_cap, tl))
        slot_idx = np.asarray([i for i, _, _ in assignments], np.int32)
        with ExitStack() as tspans:
            tspans.enter_context(self.tracer.server_span("admit", batch=k))
            for j, (_, _, pk) in enumerate(assignments):
                tspans.enter_context(self.tracer.request_span(
                    reqs[j].rid,
                    "resume_prefill" if pk is not None else "prefill"))
            cur_np = self._admit(toks, kv_keep, np.asarray(lens, np.int32),
                                 slot_idx)
        stats.device_calls += 1
        stats.admission_batches += 1
        stats.admitted += k
        stats.host_syncs += 1
        stats.sim_time += self.hw.dispatch_overhead
        try:
            for j, (i, orig, pk) in enumerate(assignments):
                r = reqs[j]
                st = self.slots[i]
                st.rid, st.remaining = r.rid, r.max_new_tokens
                st.generated = list(pk.generated) if pk is not None else []
                st.preempts = pk.preempts if pk is not None else 0
                st.request = orig
                st.kv_tokens = int(kv_keep[j])
                st.act_tokens = lens[j] - int(kv_keep[j])
                self._cur_tok[i] = cur_np[j]
                self.blockman.new_request(r.rid)
                if self.host_attn:
                    self.blockman.tag_host_attend(r.rid, True)
                for t in range(lens[j]):
                    kind = BlockType.KV if t < kv_keep[j] else BlockType.ACT
                    if self.blockman.append_token(r.rid, kind) is None:
                        raise CapacityError(
                            f"{kind.value} block pool exhausted during "
                            f"prefill of request {r.rid}",
                            rids=[rr.rid for rr in reqs],
                            resource=f"{kind.value} blocks",
                            hint="grow the host pools or lower concurrency")
        except Exception:
            # a raise must not leak the batch's rids and blocks
            self._release_slots([i for i, _, _ in assignments])
            raise

    # --- adaptive controller hook (between chunks) ----------------------------
    def _apply_alloc(self, new_alloc: HostAllocation) -> None:
        """Commit the retag toward ``new_alloc`` that actually moved."""
        self.alloc = retag_toward(self.blockman, self.alloc, new_alloc)
        self.act_frac = self.alloc.act_fraction
        if self.controller is not None:
            self.controller.alloc = self.alloc

    def _release_slots(self, slot_idx) -> None:
        """Failure-path cleanup: free the given slots' requests (tables
        included) and reset their states (``free_request`` is a no-op for
        unknown rids)."""
        for i in slot_idx:
            st = self.slots[i]
            if st.active:
                self.blockman.free_request(st.rid)
                self.tracer.request_end(st.rid, "fail")
            self.slots[i] = SlotState()

    # ---------------------------------------------------- pressure recovery
    def _release_parked(self) -> List[int]:
        """Drop every parked request's holdings; -> their rids.  After a
        ``CapacityError`` the server must be admissible again."""
        rids = []
        for pk in self.parked:
            if pk.mode == "act":
                self.blockman.free_request(pk.rid)
            self.tracer.request_end(pk.rid, "fail")
            rids.append(pk.rid)
        self.parked.clear()
        return rids

    def _degrade_parked(self) -> bool:
        """Backpressure relief: drop the YOUNGEST parked "act" holding to
        token-ID mode, freeing its ACT blocks.  True if one was degraded."""
        for pk in reversed(self.parked):
            if pk.mode == "act":
                self.blockman.free_request(pk.rid)
                pk.mode = "tokens"
                self.recovery_stats.parked_degraded += 1
                return True
        return False

    def _preempt_slot(self, v: int, active: np.ndarray,
                      sched_t: np.ndarray, allow_demote: bool) -> None:
        """Evict slot ``v`` before the call: demote its KV blocks to ACT
        checkpoints when allowed, else drop everything to token IDs; park it
        for re-admission and mask it out of this chunk."""
        st = self.slots[v]
        c = self.blockman.counts(st.rid)
        rstats = self.recovery_stats
        mode = "tokens"
        if allow_demote:
            demoted = self.blockman.demote_request_kv(st.rid)
            if demoted == c["kv_blocks"]:
                mode = "act"
                rstats.demoted_blocks += demoted
        if mode == "tokens":
            self.blockman.free_request(st.rid)
            rstats.dropped_blocks += c["kv_blocks"] + c["act_blocks"]
            rstats.preempt_to_tokens += 1
        else:
            rstats.preempt_to_act += 1
        rstats.preemptions += 1
        self.tracer.request_event(st.rid, "preempt", mode=mode,
                                  generated=len(st.generated))
        self.parked.append(ParkedRequest(
            request=st.request, generated=list(st.generated), mode=mode,
            preempts=st.preempts + 1))
        self.tracer.request_event(st.rid, "park", depth=len(self.parked))
        rstats.parked_peak = max(rstats.parked_peak, len(self.parked))
        active[:, v] = False
        sched_t[:, v] = False
        self.slots[v] = SlotState()

    def _relieve_pressure(self, active: np.ndarray, sched_t: np.ndarray,
                          kt0: np.ndarray, at0: np.ndarray) -> None:
        """Forecast the new blocks of each kind this chunk needs and, while a
        pool cannot cover its forecast, free capacity: first by degrading
        parked ACT holdings (ACT pressure), then by preempting the slot that
        holds the most blocks.  After this the replay cannot exhaust.

        Raises ``CapacityError`` (slots and parked released) when preemption
        cannot help: recovery off, the queue full, every candidate past its
        progress guard, or one runnable slot left."""
        B = self.n_slots

        def forecast() -> Tuple[int, int]:
            kv_need = act_need = 0
            for i in range(B):
                if not self.slots[i].active:
                    continue
                col = active[:, i]
                kv_end = int(kt0[i]) + int((~sched_t[:, i] & col).sum())
                act_end = int(at0[i]) + int((sched_t[:, i] & col).sum())
                kv_need += blocks_for_tokens(int(kt0[i]), kv_end)
                act_need += blocks_for_tokens(int(at0[i]), act_end)
            return kv_need, act_need

        while True:
            kv_need, act_need = forecast()
            free_kv = self.blockman.free_blocks(BlockType.KV)
            free_act = self.blockman.free_blocks(BlockType.ACT)
            if kv_need <= free_kv and act_need <= free_act:
                return
            if act_need > free_act and self._degrade_parked():
                continue
            runnable = [i for i in range(B) if self.slots[i].active]
            victims = [i for i in runnable if self.slots[i].preempts <
                       self.recovery.max_preempts_per_request]
            if (self.recovery.max_parked <= 0
                    or len(self.parked) >= self.recovery.max_parked
                    or not victims or len(runnable) < 2):
                rids = [self.slots[i].rid for i in runnable]
                self._release_slots(range(B))
                rids += self._release_parked()
                raise CapacityError(
                    f"block pools exhausted mid-chunk and preemption "
                    f"cannot relieve the pressure (need kv={kv_need}/"
                    f"{free_kv} act={act_need}/{free_act} free blocks)",
                    rids=rids, resource="blocks",
                    hint="grow the host pools, raise max_parked, or lower "
                         "concurrency")

            def held(i: int) -> int:
                c = self.blockman.counts(self.slots[i].rid)
                return c["kv_blocks"] + c["act_blocks"]

            v = max(victims, key=lambda i: (held(i), i))
            c_kv = self.blockman.counts(self.slots[v].rid)["kv_blocks"]
            # demote only under KV pressure with ACT slack left after the
            # chunk's own ACT forecast
            allow = (self.recovery.prefer_act
                     and c_kv <= free_act - act_need)
            self._preempt_slot(v, active, sched_t, allow)

    # ------------------------------------------------------------- one chunk
    def _decode(self, sched_t: np.ndarray, active: np.ndarray, kv_bound: int,
                act_bound: int, stats: ServeStats):
        """The chunk's decode: ONE call and ONE readback device-resident
        (the schedule uploaded before it), the executor's stages under
        offload.  -> (tokens (B, S), next cur (B,)) int32 numpy."""
        if self.executor is not None:
            d0, b0 = self.executor.dispatches, self.executor.blocking_syncs
            toks, cur, self.cache = self.executor.decode_chunk(
                self._cur_tok, self.cache, sched_t, active,
                kv_bound=kv_bound, act_bound=act_bound,
                host_attn=self.host_attn)
            stats.device_calls += self.executor.dispatches - d0
            stats.host_syncs += self.executor.blocking_syncs - b0
            return toks, cur
        bounds = dict(pages_bound=kv_bound // BLOCK_TOKENS
                      + act_bound // BLOCK_TOKENS,
                      act_pages_bound=act_bound // BLOCK_TOKENS)
        if self.plan is not None:
            store, act = self._as_dev(sched_t), self._as_dev(active)
            curs = [M.upload(self._cur_tok[r.bidx], r.devs[0])
                    for r in self._rows]
            with trace_ctx(self.plan):
                both, _ = SHD.decode_chunk(self.plan, self.params, curs,
                                           self.cache, store, act,
                                           any_act=sched_t.any(1),
                                           lay=self._layout, **bounds)
            both = both.cpu().numpy()
            stats.device_calls += 1
            stats.host_syncs += 1
            return both[:, :-1], both[:, -1]
        cur, store, act = (self._as_dev(a) for a in (self._cur_tok, sched_t,
                                                      active))
        toks, cur, self.cache = M.hybrid_decode_chunk(
            self.params, self.cfg, cur, self.cache, store, act,
            pages_bound=kv_bound // BLOCK_TOKENS + act_bound // BLOCK_TOKENS,
            act_pages_bound=act_bound // BLOCK_TOKENS, quant=self.quant,
            any_act=sched_t.any(1))
        both = torch.cat([toks, cur[:, None]], 1).cpu().numpy()
        stats.device_calls += 1
        stats.host_syncs += 1           # the chunk's ONE blocking readback
        return both[:, :-1], both[:, -1]

    def _run_chunk(self, n_steps: int, step_idx: int,
                   out: Dict[int, np.ndarray], stats: ServeStats) -> None:
        """ONE decode call for ``n_steps`` masked iterations, then the host
        replay: block accounting, per-step pipeline simulation, and per-step
        TTFT/TBT/completion bookkeeping."""
        B = self.n_slots
        remaining = np.asarray([s.remaining if s.active else 0
                                for s in self.slots])
        active = np.zeros((n_steps, B), bool)           # (S, B)
        for i in range(B):
            active[:min(int(remaining[i]), n_steps), i] = True
        at0 = np.asarray([s.act_tokens for s in self.slots], np.int64)
        kt0 = np.asarray([s.kv_tokens for s in self.slots], np.int64)
        sched = store_act_schedule(self.alloc, at0, kt0, n_steps)  # (B, S)
        sched_t = (sched.T & active).copy()                        # (S, B)
        # a region overflow inside the chunk would drop writes silently while
        # the lengths keep claiming them.  First remedy: clamp the store
        # schedule toward the region with room (token-exact by the hybrid
        # equivalence).  A slot whose context fits neither region is
        # infeasible: release it and fail, structured.
        doomed: List[int] = []
        for i in range(B):
            if not self.slots[i].active:
                continue
            kv, act = int(kt0[i]), int(at0[i])
            for s in range(n_steps):
                if not active[s, i]:
                    continue
                store = bool(sched_t[s, i])
                if store and act + 1 > self.act_cap:
                    if kv + 1 > self.kv_cap:
                        doomed.append(i)
                        break
                    sched_t[s, i] = store = False
                    self.recovery_stats.sched_clamps += 1
                elif not store and kv + 1 > self.kv_cap:
                    if act + 1 > self.act_cap:
                        doomed.append(i)
                        break
                    sched_t[s, i] = store = True
                    self.recovery_stats.sched_clamps += 1
                if store:
                    act += 1
                else:
                    kv += 1
        if doomed:
            rids = [self.slots[i].rid for i in doomed]
            self._release_slots(doomed)
            raise CapacityError(
                f"cache region would overflow within this chunk "
                f"(kv_cap={self.kv_cap}, act_cap={self.act_cap}) for "
                f"requests {rids}",
                rids=rids, resource="cache region",
                hint="raise the caps or cap max_new_tokens")
        # second remedy: pool pressure, preempting victims until the
        # forecast fits (may mask slots out of this chunk)
        self._relieve_pressure(active, sched_t, kt0, at0)
        if not active.any():
            return
        # a preempted victim may have been the slot that set the chunk's
        # length: drop the trailing steps no slot takes part in (the
        # reference runs them, and its step simulation fails on them)
        n_steps = int(np.nonzero(active.any(1))[0][-1]) + 1
        active, sched_t = active[:n_steps], sched_t[:n_steps]
        act_run = at0[None, :] + np.cumsum(sched_t, 0)   # lengths AFTER step s
        kv_run = kt0[None, :] + np.cumsum((~sched_t) & active, 0)
        # region bounds from the host mirrors, page multiples; the clamp
        # above keeps every active slot inside them.  A retired slot's
        # frozen device lengths may exceed them (its mirror reads 0)
        kv_bound = min(self.kv_cap, bucket(int(kt0.max()) + n_steps))
        act_bound = min(self.act_cap, bucket(int(at0.max()) + n_steps))
        with ExitStack() as tspans:
            tspans.enter_context(self.tracer.server_span(
                "chunk", steps=n_steps, idx=stats.chunks))
            for i, st in enumerate(self.slots):
                if st.active and active[:, i].any():
                    tspans.enter_context(self.tracer.request_span(
                        st.rid, "decode", chunk=stats.chunks,
                        steps=int(active[:, i].sum())))
            toks_np, cur_np = self._decode(sched_t, active, kv_bound,
                                           act_bound, stats)
        self._cur_tok = np.array(cur_np, np.int32)
        stats.chunks += 1
        stats.sim_time += self.hw.dispatch_overhead

        kv_tok = [int(kv_run[s][active[s]].sum()) for s in range(n_steps)]
        act_tok = [int(act_run[s][active[s]].sum()) for s in range(n_steps)]
        # host_attn: the KV region attends on the cpu lane
        use_cpu = self.host_attn
        specs = [[MiniBatchSpec(int(active[s].sum()),
                                0 if use_cpu else kv_tok[s], act_tok[s],
                                0, ctx_tokens=int(
                                    (kv_run[s] + act_run[s])[active[s]].mean()),
                                cpu_host_tokens=kv_tok[s] if use_cpu else 0)]
                 for s in range(n_steps)]
        sim_results = simulate_steps(self.cfg, self.hw, specs,
                                     quant=self.quant)

        # per-step bookkeeping: tokens, block replay, TTFT/TBT, retirement.
        # A raise mid-replay releases every slot (the mirrors are no longer
        # trustworthy) instead of leaking their blocks
        try:
            for s in range(n_steps):
                stats.sim_time += sim_results[s].total
                stats.steps += 1
                for i, st in enumerate(self.slots):
                    if not active[s, i]:
                        continue
                    st.generated.append(int(toks_np[i, s]))
                    st.remaining -= 1
                    stats.generated_tokens += 1
                    if sched_t[s, i]:
                        st.act_tokens += 1
                    else:
                        st.kv_tokens += 1
                    kind = BlockType.ACT if sched_t[s, i] else BlockType.KV
                    if self.blockman.append_token(st.rid, kind) is None:
                        # unreachable: _relieve_pressure forecast the
                        # chunk's exact block needs before the call
                        raise CapacityError(
                            f"{kind.value} block pool exhausted at decode "
                            f"step {step_idx + s} of request {st.rid}; the "
                            "precomputed store_act schedule requires "
                            "allocation to succeed",
                            rids=[st.rid], resource=f"{kind.value} blocks",
                            hint="grow the host pools or lower concurrency")
                    if st.rid not in stats.ttft:
                        stats.ttft[st.rid] = stats.sim_time
                        if self.metrics is not None:
                            self.metrics.histogram("ttft_s").observe(
                                stats.ttft[st.rid])
                    if st.remaining == 0:
                        out[st.rid] = np.asarray(st.generated, np.int32)
                        stats.tbt[st.rid] = stats.sim_time / max(
                            len(st.generated), 1)
                        stats.completed_at[st.rid] = step_idx + s
                        if self.metrics is not None:
                            self.metrics.histogram("tbt_s").observe(
                                stats.tbt[st.rid])
                        self.tracer.request_end(
                            st.rid, "complete", tokens=len(st.generated),
                            step=step_idx + s)
                        self.blockman.free_request(st.rid)
                        self.slots[i] = SlotState()
        except Exception:
            self._release_slots(range(self.n_slots))
            self._release_parked()
            raise
        meas: List = []
        if self.executor is not None:
            # the chunk's steps, resolved once (the span store stays bounded)
            meas = self.executor.drain_timeline("decode")
            self._measured.extend(meas)
            stats.measured_time += sum(m.total for m in meas)
        if self.metrics is not None:
            fold_timeline_metrics(self.metrics, sim_results, source="sim")
            fold_timeline_metrics(self.metrics, meas, source="measured")
            self.metrics.counter("serve_generated_tokens").inc(
                int(active.sum()))
            self.metrics.counter("serve_chunks").inc()
        if self.controller is not None:
            # per-chunk batch: the measured steps under offload, the
            # simulated predictions otherwise; a host-attended chunk's KV
            # tokens fed the cpu lane, not the link
            self.controller.observe(
                meas if meas else sim_results,
                [0] * n_steps if use_cpu else kv_tok, act_tok,
                sim=sim_results, cpu_tokens=kv_tok if use_cpu else None)
            self._apply_alloc(self.controller.update())
        elif self.executor is not None:
            # no controller to route through: the drift monitor takes its
            # (measured, predicted) pairs directly
            self.drift.observe_steps(meas, sim_results)

    # ---------------------------------------------------------------- serving
    def run(self, requests: List[Request],
            arrival_steps: Optional[List[int]] = None
            ) -> Tuple[Dict[int, np.ndarray], ServeStats]:
        """Serve ``requests`` through the slot pool.

        arrival_steps: per-request admission step, aligned with ``requests``:
        request i joins the queue once the iteration index reaches
        ``arrival_steps[i]`` (open-loop traffic).  Omitted, every request is
        queued up front."""
        if arrival_steps is None:
            pending: List = []
            queue = list(requests)
        else:
            assert len(arrival_steps) == len(requests)
            order = sorted(range(len(requests)),
                           key=lambda i: (arrival_steps[i], i))
            pending = [(int(arrival_steps[i]), requests[i]) for i in order]
            queue = []
        out: Dict[int, np.ndarray] = {}
        stats = ServeStats()
        step_idx = 0
        while (queue or pending or self.parked
               or any(s.active for s in self.slots)):
            while pending and pending[0][0] <= step_idx:
                queue.append(pending.pop(0)[1])
            # chunk-boundary admission: parked resumes first, then every due
            # arrival that fits, coalesced into one batched prefill
            assignments = self._plan_admission(queue)
            if assignments:
                self._admit_batch(assignments, stats)
            if not any(s.active for s in self.slots):
                if pending:                  # idle gap before the next arrival
                    step_idx = pending[0][0]
                    continue
                if not (self.parked or queue):
                    break
                # stalled: nothing runs, nothing fits.  Degrade parked ACT
                # holdings and retry; a stall that survives every degradation
                # is overcommit
                if self._degrade_parked():
                    continue
                rids = self._release_parked() + [r.rid for r in queue]
                raise CapacityError(
                    "server stalled: no admission fits the free block "
                    "pools even with every parked holding degraded",
                    rids=rids, resource="blocks",
                    hint="grow the host pools or shorten prompts")
            n_steps = min(self.chunk_steps,
                          max(s.remaining for s in self.slots if s.active))
            self._run_chunk(n_steps, step_idx, out, stats)
            step_idx += n_steps
        return out, stats
