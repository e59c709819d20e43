"""HybridServe engine of the port: end-to-end serving with the KV/ACT hybrid
cache (counterpart of ``repro.serving.engine``).

The policy stack is the reference's, copied into ``repro_torch.core``:

  1. Algorithm 1 fixes the host ACT:KV ratio for the model + hardware.
  2. Each request's prompt is split KV-prefix / ACT-suffix at that ratio
     (Eq. 11); generated tokens keep the running ratio via the precomputed
     store_act schedule.
  3. Mini-batches are formed by the F_b bin packer; each group runs ONE
     batched prefill (flash-attention kernel) and ONE greedy decode loop
     (hybrid paged-attention kernel, KV-Gen fused for learned positions, or
     the KV-Gen kernel then the second-pool attention for RoPE models),
     argmax on the device.
  4. The BlockManager accounts physical blocks; the pipeline simulator
     reports what the schedule would cost on the target hardware.

Baselines: mode="kv" and mode="act" pin the ratio.

Two executors share the policy stack: the default device-resident path (one
batched prefill + one decode loop per group, every weight on the card), and
the ``offload=True`` host-offload runtime, which streams layer weights from
pinned host memory over a copy stream, spills KV regions to a pinned host
arena when the config-driven budget demands, optionally attends over a
spilled region on the CPU (``host_attn=True``), and reports MEASURED lane
timelines next to the simulated predictions — token-exact against each other.

``quant=QuantConfig()`` stores both cache regions as int8 codes with float16
scales on the device, read by the kernels' int8 modes; Algorithm 1, the block
manager, the spill arena and the simulator price the quantized bytes, so the
split re-balances as the reference's does.

``adaptive=True`` refits the cost model between groups from their lane
timelines (``core.controller``) and retags free host capacity toward the
refit split; ``tracer=``/``metrics=`` record the request and server spans,
the lane timelines and the counters (``obs``).  All of it is host-side, on
results already read: no call and no sync is added.

``plan=make_shard_plan(cfg, mesh, params)`` serves tensor-parallel over the
plan's mesh (``models.sharded``): the weights laid out under the serve
specs, the cache under ``plan.cache_spec``, each position's attention on the
kernels at its head counts, and the policy stack pricing the aggregate
machine (``costmodel.scale_for_shards``).  A group is still one prefill call
and one decode call with one readback.  Every combination the single-device
engine serves, a plan serves: the int8 cache, the offload runtime with its
CPU lane, the MoE models (expert parallel where the experts divide the
model axis) and every head layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.offload import OffloadBudget, offload_budget
from repro_torch.core import costmodel as cm
from repro_torch.core.blocks import (BLOCK_TOKENS, BlockManager, BlockType,
                                     Location)
from repro_torch.core.controller import ControllerConfig, HybridCacheController
from repro_torch.core.minibatch import RequestBlocks, form_minibatches
from repro_torch.core.pipeline import (MiniBatchSpec, TimelineResult,
                                       simulate_steps)
from repro_torch.core.quant import QuantConfig
from repro_torch.core.policy import (HostAllocation, device_act_blocks,
                                     host_block_allocation,
                                     store_act_schedule)
from repro_torch.core.costmodel import profile_cost_fns
from repro_torch.data.pipeline import Request
from repro_torch.models import model as M
from repro_torch.models import sharded as SHD
from repro_torch.models import transformer as T
from repro_torch.obs import (NULL_TRACER, DriftMonitor, ScalarStatsView,
                             fold_timeline_metrics,
                             register_busy_fraction_collector)
from repro_torch.serving.recovery import CapacityError
from repro_torch.serving.util import (bucket, collect_block_metrics, pack_group,
                                     retag_toward, trace_ctx)
from repro_torch.sharding import collectives


class GenStats(ScalarStatsView):
    """Per-call generation stats: plain attributes, or, constructed with a
    ``MetricsRegistry``, live views over its ``gen_*`` counters (each view
    reads zero at construction while the registry keeps the engine's
    totals)."""

    _FIELDS = {
        "generated_tokens": 0,
        "steps": 0,
        "sim_time": 0.0,
        "sim_gpu_busy": 0.0,
        "device_calls": 0,     # prefill + decode dispatches (2 per group)
        # measured (offload runtime; zero device-resident)
        "measured_time": 0.0,
        "measured_gpu_busy": 0.0,
        "measured_cpu_busy": 0.0,    # cpu attention lane
    }

    def __init__(self, registry=None):
        super().__init__(registry, prefix="gen")
        self.traffic: Dict[str, float] = {}

    @property
    def sim_throughput(self) -> float:
        return self.generated_tokens / self.sim_time if self.sim_time else 0.0

    @property
    def sim_gpu_util(self) -> float:
        return self.sim_gpu_busy / self.sim_time if self.sim_time else 0.0

    @property
    def measured_gpu_util(self) -> float:
        return (self.measured_gpu_busy / self.measured_time
                if self.measured_time else 0.0)


class HybridServeEngine:
    def __init__(self, cfg: ModelConfig, params, *,
                 hw: cm.HardwareSpec = cm.H100_SXM, mode: str = "hybrid",
                 max_minibatch: int = 4, kv_cap: int = 512, act_cap: int = 512,
                 generalized: bool = False, offload: bool = False,
                 budget: Optional[OffloadBudget] = None,
                 host_attn: bool = False, faults=None,
                 watchdog_s: Optional[float] = None, adaptive: bool = False,
                 ctl: Optional[ControllerConfig] = None, tracer=None,
                 metrics=None, quant: Optional[QuantConfig] = None,
                 plan=None, device="cuda"):
        """``params`` must already live on ``device`` (under ``offload`` they
        may live anywhere, or be a ``HostWeightPool`` shared between
        engines).

        generalized=True uses the byte-ratio-aware Algorithm-1 variant
        (recommended for GQA models), in the allocation and in the adaptive
        controller's retarget; False reproduces the paper's policy exactly.

        offload=True runs the host-offload runtime: layer weights stream from
        pinned host memory through the copy stream, and a group's KV region
        spills to the host arena whenever the config-driven ``budget`` can't
        hold its KV blocks device-side.  The engine then keeps no device copy
        of the layer weights.  Stats additionally carry measured lane times.

        host_attn=True (offload only) enables the cpu attention lane: groups
        that physically spill attend over their KV region ON THE HOST, over
        the pinned arena, while the device attends over the rest; only
        softmax statistics and the new row cross the link.

        faults / watchdog_s: a ``FaultPlan`` and the lanes' watchdog
        deadline; an arena denial (real or injected) serves the group
        device-resident instead of failing it.

        adaptive=True (hybrid mode) runs the ``HybridCacheController``
        between groups: it refits the cost model from the group's lane
        timelines (measured under offload, else the simulated predictions),
        re-runs Algorithm 1 (in the ``generalized`` form) and
        retags up to its migration bound of free host capacity toward the
        refit split.  ``ctl``: its ``ControllerConfig``.  Tokens stay exact
        at any split.

        tracer / metrics: an ``obs.Tracer`` (request roots, the server's
        prefill and decode spans, the executor's lane spans) and an
        ``obs.MetricsRegistry`` (``GenStats`` as ``gen_*`` counters, the
        timeline folds, occupancy and controller gauges; ``snapshot()``).
        Host-side only: tokens, calls and syncs are those of a run without.

        quant=QuantConfig() keeps both cache regions as int8 codes with
        float16 scales, on the device and in the spill arena; the policy,
        block manager and simulator price those bytes.  None: the config
        dtype."""
        if mode not in ("hybrid", "kv", "act"):
            raise ValueError(f"mode={mode!r}: one of hybrid, kv, act")
        if host_attn and not offload:
            raise ValueError("host_attn rides the offload runtime's spill arena")
        if adaptive and mode != "hybrid":
            raise ValueError("the adaptive controller re-balances the hybrid "
                             "split; the kv and act baselines pin the ratio")
        T.check_supported(cfg, "engine")
        plan, self.device, hw, shards = SHD.resolve_plan(
            cfg, plan, device, hw, quant)
        self.plan = plan
        self.cfg, self.params, self.hw, self.mode = cfg, params, hw, mode
        self.quant = quant
        self.host_attn = bool(host_attn)
        self.offload = offload
        self.budget = budget if budget is not None else offload_budget(cfg)
        self.max_minibatch = max_minibatch
        self.kv_cap, self.act_cap = kv_cap, act_cap
        # telemetry, host-side only: NULL_TRACER is off
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.drift = DriftMonitor(registry=metrics)
        if metrics is not None:
            register_busy_fraction_collector(metrics)
            metrics.register_collector(self._collect_metrics)
        self.fits = profile_cost_fns(cfg, hw, quant=quant)
        dev_act = device_act_blocks(cfg, hw, quant=quant)
        self.alloc = host_block_allocation(cfg, hw, dev_act,
                                           generalized=generalized, quant=quant)
        if mode == "kv":
            self.alloc = dataclasses.replace(self.alloc, act_blocks=0, kv_blocks=max(
                self.alloc.kv_blocks, 1))
        elif mode == "act":
            self.alloc = dataclasses.replace(self.alloc, kv_blocks=0, act_blocks=max(
                self.alloc.act_blocks, 1))
        self.act_frac = self.alloc.act_fraction
        self.controller: Optional[HybridCacheController] = None
        self._last_obs = None
        if adaptive:
            self.controller = HybridCacheController(
                cfg, hw, self.alloc, dev_act, fits=self.fits,
                generalized=generalized,
                ctl=ctl if ctl is not None else ControllerConfig(),
                drift=self.drift, quant=quant, cpu=host_attn)
        # device KV pool: generous when device-resident; budget-derived under
        # offload, so tight budgets force real spill to the host arena
        self.blockman = BlockManager(
            cfg, host_kv_blocks=max(self.alloc.kv_blocks, 1),
            host_act_blocks=max(self.alloc.act_blocks, 1),
            dev_kv_blocks=self.budget.dev_kv_blocks(cfg) if offload else 64,
            dev_act_blocks=dev_act, shard_factor=shards, quant=quant)
        self.executor = None
        self.measured_steps: List[TimelineResult] = []
        self.faults = faults
        self.arena_denials = 0
        if offload:
            from repro_torch.offload import OffloadExecutor, make_spill_pool
            self.executor = OffloadExecutor(
                cfg, params, prefetch_depth=self.budget.prefetch_depth,
                faults=faults, watchdog_s=watchdog_s, tracer=tracer,
                metrics=metrics, quant=quant, plan=plan, device=self.device)
            self.spill_kv_pool = make_spill_pool(
                cfg, max_requests=max_minibatch, kv_cap=kv_cap, quant=quant,
                shards=shards, device=self.device)
            # the executor owns the host copy of the layer weights and the
            # resident tree; the engine holds no reference to the caller's
            # parameters, so they can be freed from the device
            self.params = None
        elif plan is not None:
            self.params = plan.place_params(params)
            self._layout = SHD.Layout(plan, quant)

    def close(self) -> None:
        """Drain the offload executor's copy stream and join its cpu-lane
        worker (no-op for the device-resident engine)."""
        if self.executor is not None:
            self.executor.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- public API ----------------------------------------------------------
    def plan_groups(self, requests: List[Request]) -> List[List[Request]]:
        """Deterministic group plan: Eq. 11 request split + F_b mini-batch
        packing over block counts, chunked to ``max_minibatch``.  Each group
        costs exactly two device dispatches (prefill + decode loop)."""
        reqs_blocks = []
        for r in requests:
            blocks = (len(r.prompt) + r.max_new_tokens + BLOCK_TOKENS - 1) // BLOCK_TOKENS
            n_act = int(round(blocks * self.act_frac))
            reqs_blocks.append(RequestBlocks(r.rid, n_act, blocks - n_act))
        mbs = form_minibatches(
            reqs_blocks, *self.fits,
            act_max=max(self.max_minibatch * (self.act_cap // BLOCK_TOKENS), 1),
            kv_max=max(self.max_minibatch * (self.kv_cap // BLOCK_TOKENS), 1))
        by_rid = {r.rid: r for r in requests}
        groups: List[List[Request]] = []
        for mb in mbs:
            batch_reqs = [by_rid[rb.rid] for rb in mb.requests]
            for i in range(0, len(batch_reqs), self.max_minibatch):
                groups.append(batch_reqs[i: i + self.max_minibatch])
        return groups

    def snapshot(self) -> Dict[str, object]:
        """One-call observability read: the registry's snapshot (collectors
        run, so occupancy, busy-fraction and drift gauges are fresh) plus the
        drift monitor's summary; the summary alone without a registry."""
        out: Dict[str, object] = (self.metrics.snapshot()
                                  if self.metrics is not None else {})
        out["predictor_drift"] = self.drift.summary()
        return out

    def _collect_metrics(self, reg) -> None:
        """Pull-style collector: occupancy by tag, retags and controller
        state, read at ``snapshot()`` time, never on the hot path."""
        collect_block_metrics(reg, self.blockman, self.act_frac,
                              self.controller)
        reg.counter("arena_denials").set(self.arena_denials)
        if self.plan is not None:
            collectives.record(reg)

    def generate(self, requests: List[Request]) -> Tuple[Dict[int, np.ndarray], GenStats]:
        stats = GenStats(self.metrics)
        outputs: Dict[int, np.ndarray] = {}
        for group in self.plan_groups(requests):
            out, st = self._run_group(group)
            self._controller_step()
            outputs.update(out)
            stats.generated_tokens += st.generated_tokens
            stats.steps += st.steps
            stats.sim_time += st.sim_time
            stats.sim_gpu_busy += st.sim_gpu_busy
            stats.device_calls += st.device_calls
            stats.measured_time += st.measured_time
            stats.measured_gpu_busy += st.measured_gpu_busy
            stats.measured_cpu_busy += st.measured_cpu_busy
            for k, v in st.traffic.items():
                stats.traffic[k] = stats.traffic.get(k, 0.0) + v
        return outputs, stats

    # --- adaptive controller hook (between groups) ---------------------------
    def _controller_step(self) -> None:
        """Feed the last group's lane timelines to the controller and apply
        its bounded re-balance, on host data the group already read."""
        if self.controller is None or self._last_obs is None:
            return
        results, sim, kv_tok, act_tok, cpu_tok = self._last_obs
        self._last_obs = None
        self.controller.observe(results, kv_tok, act_tok, sim=sim,
                                cpu_tokens=cpu_tok)
        self._apply_alloc(self.controller.update())

    def _apply_alloc(self, new_alloc: HostAllocation) -> None:
        """Commit the retag toward ``new_alloc`` that actually moved."""
        self.alloc = retag_toward(self.blockman, self.alloc, new_alloc)
        self.act_frac = self.alloc.act_fraction
        if self.controller is not None:
            self.controller.alloc = self.alloc

    def group_schedule(self, group: List[Request]):
        """Host-side plan of one group, as ``_run_group`` runs it.

        -> (tokens (B, Smax) int32, kv_keep (B,), buckets, store schedule
        (B, max_new) bool, pages_bound, act_pages_bound): ``pages_bound`` is
        the most pages any request uses at any decode step (lengths only
        grow, so the last step's), the width of every step's page table;
        ``act_pages_bound`` the most ACT pages, the prefix ``kv_gen``
        recomputes per request for RoPE models.  Raises ``CapacityError``
        when a decode would outgrow a region."""
        toks, kv_keep, pbs = pack_group(group, self.act_frac, self.kv_cap,
                                        self.act_cap, mode=self.mode)
        max_new = max(r.max_new_tokens for r in group)
        act0 = np.asarray(pbs) - kv_keep
        sched = store_act_schedule(self.alloc, act0, kv_keep, max_new)
        kv_end = np.minimum(kv_keep, min(toks.shape[1], self.kv_cap)) \
            + (~sched).sum(1)
        act_end = np.minimum(act0, self.act_cap) + sched.sum(1)
        if kv_end.max() > self.kv_cap or act_end.max() > self.act_cap:
            raise CapacityError(
                f"decode needs {int(kv_end.max())} KV and {int(act_end.max())} "
                f"ACT slots, regions hold {self.kv_cap} and {self.act_cap}",
                rids=[r.rid for r in group], resource="region slots",
                hint="raise kv_cap/act_cap or lower max_new_tokens")
        act_pages = -(-act_end // BLOCK_TOKENS)
        pages = -(-kv_end // BLOCK_TOKENS) + act_pages
        return (toks, kv_keep, pbs, sched, max(int(pages.max()), 1),
                int(act_pages.max()))

    # --- one group of requests ----------------------------------------------
    def _run_group(self, group: List[Request]) -> Tuple[Dict[int, np.ndarray], GenStats]:
        """ONE batched prefill + ONE greedy decode loop; tokens reach the host
        once, at the end.  Block accounting replays the schedule afterwards.
        Under offload both run layer by layer with streamed weights, and the
        group's KV region stays on the device or spills to the host arena."""
        cfg, dev = self.cfg, self.device
        stats = GenStats()
        B = len(group)
        for r in group:
            self.tracer.request_begin(r.rid, prompt_tokens=len(r.prompt),
                                      max_new=r.max_new_tokens)
        region = None
        try:
            toks, kv_keep, pbs, sched, pages_bound, act_bound = \
                self.group_schedule(group)
            max_new = sched.shape[1]
            with self.tracer.server_span("prefill", batch=B):
                if self.executor is not None:
                    d0 = self.executor.dispatches
                    cur, cache = self.executor.prefill_batched(
                        toks, kv_keep, pbs, kv_cap=self.kv_cap,
                        act_cap=self.act_cap)
                    stats.device_calls += self.executor.dispatches - d0
                elif self.plan is not None:
                    with trace_ctx(self.plan):
                        cur, cache = SHD.prefill(
                            self.plan, self.params, toks, self.kv_cap,
                            self.act_cap, kv_keep, pbs, lay=self._layout)
                        cache = self.plan.constrain_cache(cache)
                    stats.device_calls += 1
                else:
                    lg, cache = M.hybrid_prefill_batched(
                        self.params, cfg, torch.from_numpy(toks).to(dev),
                        self.kv_cap, self.act_cap, kv_keep, pbs,
                        quant=self.quant)
                    cur = lg[:, -1].argmax(-1).int()
                    stats.device_calls += 1
            for i, r in enumerate(group):
                self.blockman.new_request(r.rid)
                for t in range(pbs[i]):
                    kind = BlockType.KV if t < kv_keep[i] else BlockType.ACT
                    if self.blockman.append_token(r.rid, kind) is None:
                        raise CapacityError(
                            f"{kind.value} block pool exhausted during "
                            f"prefill of request {r.rid}",
                            rids=[rr.rid for rr in group],
                            resource=f"{kind.value} blocks",
                            hint="grow the host pools or shrink the group")

            measured: List[TimelineResult] = []
            # offload: decide residency for the group's KV blocks up front.
            # If the device pool (sized by the budget) can hold the group's
            # final KV block count, migrate prefill blocks to DEVICE;
            # otherwise the region physically spills to the pinned host
            # arena and every block stays HOST.
            spilled = False
            if self.executor is not None and max_new:
                from repro_torch.offload import kv_region_blocks
                kv_end = kv_keep + (~sched).sum(1)
                need = int(np.sum(-(-kv_end // BLOCK_TOKENS)))
                free = self.blockman.pools[
                    (BlockType.KV, Location.DEVICE)].free_blocks
                spilled = need > free
                if spilled:
                    # fault site "arena": an injected deny models transient
                    # host-arena exhaustion; a real None is the same for real
                    deny = (self.faults is not None and
                            self.faults.draw("arena", kinds=("deny",))
                            is not None)
                    region = None if deny else self.spill_kv_pool.alloc(
                        kv_region_blocks(B, self.kv_cap))
                    if region is None:
                        # degraded mode: serve the group device-resident
                        # (tokens are exact either way) instead of failing
                        spilled = False
                        self.arena_denials += 1
                        self.executor.timeline.record_event("arena_denied")
                if not spilled:
                    for r in group:
                        self.blockman.migrate(r.rid, BlockType.KV,
                                              Location.DEVICE)

            # the cpu lane engages only for groups that physically spilled:
            # their arena KV blocks are attended in place
            use_cpu = self.host_attn and region is not None
            if use_cpu:
                for r in group:
                    self.blockman.tag_host_attend(r.rid, True)

            if max_new:
                with self.tracer.server_span("decode", batch=B,
                                             steps=max_new):
                    if self.executor is not None:
                        d0 = self.executor.dispatches
                        gen, _ = self.executor.decode_loop(
                            cur, cache, sched.T, spill_region=region,
                            host_attn=use_cpu, pages_bound=pages_bound,
                            act_pages_bound=act_bound)
                        stats.device_calls += self.executor.dispatches - d0
                        measured = self.executor.drain_timeline("decode")
                        self.measured_steps += measured
                        stats.measured_time += sum(m.total for m in measured)
                        stats.measured_gpu_busy += sum(m.gpu_busy
                                                       for m in measured)
                        stats.measured_cpu_busy += sum(m.cpu_busy
                                                       for m in measured)
                    elif self.plan is not None:
                        sched_dev = M.upload(np.ascontiguousarray(sched.T),
                                             dev)
                        with trace_ctx(self.plan):
                            both, _ = SHD.decode_chunk(
                                self.plan, self.params, cur, cache, sched_dev,
                                pages_bound=pages_bound,
                                act_pages_bound=act_bound,
                                any_act=sched.any(0), lay=self._layout)
                        gen = both[:, :-1].cpu().numpy()
                        stats.device_calls += 1
                    else:
                        sched_dev = torch.from_numpy(
                            np.ascontiguousarray(sched.T)).to(dev)
                        gen_dev, _ = M.hybrid_decode_loop(
                            self.params, cfg, cur, cache, sched_dev,
                            pages_bound=pages_bound, act_pages_bound=act_bound,
                            quant=self.quant, any_act=sched.any(0))
                        gen = gen_dev.cpu().numpy()
                        stats.device_calls += 1
            else:
                gen = np.zeros((B, 0), np.int32)
            stats.steps += max_new
            stats.generated_tokens += sum(r.max_new_tokens for r in group)

            for step in range(max_new):
                for bi, r in enumerate(group):
                    kind = BlockType.ACT if sched[bi, step] else BlockType.KV
                    blk = self.blockman.append_token(r.rid, kind)
                    if blk is None:
                        raise CapacityError(
                            f"{kind.value} block pool exhausted at decode "
                            f"step {step} of request {r.rid}; the precomputed "
                            "store_act schedule requires allocation to succeed",
                            rids=[rr.rid for rr in group],
                            resource=f"{kind.value} blocks",
                            hint="grow the host pools or shrink the group")
                    if (self.executor is not None and not spilled
                            and kind == BlockType.KV
                            and blk.location == Location.HOST):
                        # device-resident group: keep appended KV on device
                        self.blockman.move_block(
                            r.rid, self.blockman.tables[r.rid].index(blk),
                            Location.DEVICE)

            # cost of every step on the target hardware (vectorized
            # reporting); host-attended groups move their KV tokens off the
            # pcie lane and onto the cpu lane
            steps_ahead = np.arange(1, max_new + 1)
            act0 = np.asarray(pbs) - kv_keep
            kv_tok = int(kv_keep.sum()) + np.cumsum((~sched).sum(0))
            act_tok = int(act0.sum()) + np.cumsum(sched.sum(0))
            specs = [[MiniBatchSpec(
                B, 0 if use_cpu else int(kv_tok[s]), int(act_tok[s]), 0,
                ctx_tokens=int(np.mean(np.asarray(pbs) + steps_ahead[s])),
                cpu_host_tokens=int(kv_tok[s]) if use_cpu else 0)]
                for s in range(max_new)]
            sim_results = simulate_steps(cfg, self.hw, specs, quant=self.quant)
            for res in sim_results:
                stats.sim_time += res.total
                stats.sim_gpu_busy += res.gpu_busy
                for k, v in res.traffic.items():
                    stats.traffic[k] = stats.traffic.get(k, 0.0) + v
            if self.metrics is not None:
                fold_timeline_metrics(self.metrics, sim_results, source="sim")
                fold_timeline_metrics(self.metrics, measured,
                                      source="measured")
            if self.controller is not None:
                # controller food: measured lane times under offload, the
                # simulated prediction otherwise, with the schedule's
                # per-step host token counts; a host-attended group's KV
                # tokens fed the cpu lane, not the link
                self._last_obs = (measured if self.executor is not None
                                  else sim_results, sim_results,
                                  [0] * max_new if use_cpu
                                  else kv_tok.tolist(), act_tok.tolist(),
                                  kv_tok.tolist() if use_cpu else None)
            elif self.executor is not None:
                # no controller to route through: the drift monitor takes
                # its (measured, predicted) pairs directly
                self.drift.observe_steps(measured, sim_results)
            out = {}
            for bi, r in enumerate(group):
                out[r.rid] = gen[bi, : r.max_new_tokens]
                self.tracer.request_end(r.rid, "complete",
                                        tokens=int(len(out[r.rid])))
            return out, stats
        except BaseException:
            for r in group:
                self.tracer.request_end(r.rid, "fail")
            raise
        finally:
            if region is not None:
                region.free()               # the staging arena is reused per group
            for r in group:
                self.blockman.free_request(r.rid)


def exact_reference_generate(cfg, params, requests: List[Request],
                             device="cuda") -> Dict[int, np.ndarray]:
    """Oracle: plain full-KV incremental decode, one request at a time.
    ``params`` must live on ``device``."""
    out = {}
    for r in requests:
        plen = len(r.prompt)
        pb = bucket(plen)
        toks = np.zeros((1, pb), np.int32)
        toks[0, :plen] = r.prompt
        toks[0, plen:] = r.prompt[-1]
        lg, cache = M.prefill(params, cfg, torch.from_numpy(toks).to(device),
                              max_len=pb + r.max_new_tokens + 8)
        cur = lg[:, -1].argmax(-1).int()
        gen, _ = M.decode_loop(params, cfg, cur, cache, r.max_new_tokens)
        out[r.rid] = gen.cpu().numpy()[0]
    return out
