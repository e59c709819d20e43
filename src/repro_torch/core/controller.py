"""Adaptive hybrid-cache controller: measured timelines -> KV:ACT ratio
(a copy of ``repro.core.controller``).

The paper computes the host ACT:KV ratio once at startup from the analytic
cost model (Algorithm 1 + Eq. 11).  The offload runtime, however, produces
*measured* per-step lane timelines, and an analytic link model mispredicts
real scatter-gather traffic.  This module closes the loop:

  observe   per-step ``TimelineResult``s (measured or simulated) become
            per-lane ``LaneSample``s: (tokens, seconds) pairs for the KV-load
            lane ("kv" tag), the KV-regeneration lane ("gen" tag; a measured
            gpu span that fuses KV Gen into the layer is split by the
            simulator's gen:fwd share) and the host-attention lane ("cpu").
            The engine feeds one group's steps per call, the server one
            chunk's (``update_every`` counts calls, not tokens).
  refit     ``ewma_refit`` blends a least-squares fit of the window into the
            current ``LinearFit``s, clamped into a damped trust region around
            the analytic prior.
  retarget  Algorithm 1 re-runs with the refit fits; its ACT fraction is
            re-expressed on the FIXED host-block total (the pools are
            allocated: the controller retags roles, it does not resize host
            memory), so act+kv(+cpu) is conserved exactly.
  migrate   each update steps the applied allocation toward the target by
            at most the migration bound; the caller mirrors the step with
            ``BlockManager.retag_capacity`` (free capacity only).

Samples that match the analytic model leave the fits and the allocation
where they are: Algorithm 1 is a fixed point of the control law.  Everything
here is host-side numpy over timelines that are already resolved.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import LaneSample, LinearFit, ewma_refit
from repro_torch.core.pipeline import TimelineResult
from repro_torch.core.policy import (HostAllocation, host_block_allocation,
                               host_block_allocation_threeway)


@dataclass(frozen=True)
class ControllerConfig:
    """Control-law knobs (the reference's defaults)."""
    alpha: float = 0.25              # EW weight of each refit window
    damping: float = 4.0             # trust region around the analytic prior
    intercept_scale_tokens: float = 256.0
    min_samples: int = 4             # per lane, before the first refit
    max_samples: int = 512           # sliding sample window per lane
    migrate_frac: float = 0.10       # per-update retag bound (of total blocks)
    migrate_bound: Optional[int] = None   # absolute override of the bound
    deadband_frac: float = 0.01      # ignore smaller retarget deltas
    update_every: int = 1            # observe() calls between updates

    def bound_blocks(self, total: int) -> int:
        if self.migrate_bound is not None:
            return max(int(self.migrate_bound), 0)
        return max(int(total * self.migrate_frac), 1)

    def deadband_blocks(self, total: int) -> int:
        return max(int(total * self.deadband_frac), 1)


class HybridCacheController:
    """Feedback controller over one engine's host ACT:KV allocation.

    ``alloc`` is the *applied* allocation (the caller keeps it in sync with
    what it actually retagged); ``update()`` refits the cost model from the
    observed samples and returns the next bounded step toward the refit
    target.  All work is host-side numpy on already-materialised timeline
    results — the decode hot path never gains a device sync.
    """

    def __init__(self, cfg: ModelConfig, hw: cm.HardwareSpec,
                 alloc: HostAllocation, n_act_gpu_blocks: int, *,
                 fits: Optional[Tuple[LinearFit, ...]] = None,
                 generalized: bool = False,
                 ctl: ControllerConfig = ControllerConfig(), drift=None,
                 quant=None, cpu: bool = False):
        self.cfg, self.hw, self.ctl = cfg, hw, ctl
        # optional QuantConfig: retargeting prices the same (quantized) block
        # bytes the engine allocates
        self.quant = quant
        # optional obs.drift.DriftMonitor: every (measured, sim) pair that
        # flows through observe() also feeds the rolling lane residuals, so
        # a systematic simulate_steps error the damped refit keeps absorbing
        # becomes a visible metric
        self.drift = drift
        self.generalized = generalized
        self.n_act_gpu_blocks = n_act_gpu_blocks
        # ``cpu=True`` enables the three-way retarget: Algorithm 1 re-runs
        # with the cpu-attend lane fit and the target also carries
        # cpu_blocks.  False is the two-way paper control law.
        self.cpu = bool(cpu)
        prior = (fits if fits is not None
                 else cm.profile_cost_fns(cfg, hw, quant=quant, cpu=cpu))
        self.prior_gen, self.prior_load = prior[0], prior[1]
        self.fit_gen, self.fit_load = prior[0], prior[1]
        if self.cpu:
            pc = (prior[2] if len(prior) > 2
                  else cm.profile_cost_fns(cfg, hw, quant=quant, cpu=True)[2])
            self.prior_cpu = self.fit_cpu = pc
        else:
            self.prior_cpu = self.fit_cpu = None
        self.alloc = alloc
        self.total_host = alloc.total_blocks + alloc.cpu_blocks
        self._gen: Deque[LaneSample] = deque(maxlen=ctl.max_samples)
        self._load: Deque[LaneSample] = deque(maxlen=ctl.max_samples)
        self._cpu: Deque[LaneSample] = deque(maxlen=ctl.max_samples)
        self._since_update = 0
        self.updates = 0                 # refit+retarget passes run
        self.migrated_blocks = 0         # blocks stepped across all updates
        self.faulted_skipped = 0         # degraded steps not fit
        self.frac_history: List[float] = [alloc.act_fraction]

    # ---------------------------------------------------------------- observe
    def observe(self, results: Sequence[TimelineResult],
                kv_tokens: Sequence[float], act_tokens: Sequence[float],
                sim: Optional[Sequence[TimelineResult]] = None,
                cpu_tokens: Optional[Sequence[float]] = None) -> int:
        """Fold per-step timelines into the lane sample windows.

        kv_tokens / act_tokens: per-step host context token counts (batch
        aggregate, the units Algorithm 1's fits are in) aligned with
        ``results``.  ``sim`` carries the analytic prediction for the same
        steps: measured executors fuse KV Gen into the layer forward, so a
        result without a "gen" tag has its GPU time attributed by the
        simulator's gen:fwd share.  Returns samples added.

        Degraded steps — measured results carrying robustness events
        (watchdog timeouts, retries, lane fallbacks) — are
        substituted by their simulated prediction when available and
        skipped otherwise: a stalled lane's seconds are the fault's cost,
        not the hardware's, and fitting them would poison the cost model
        that every allocation downstream prices from.  Substitutions are
        counted in ``self.faulted_skipped``.
        """
        L = max(self.cfg.num_layers, 1)
        added = 0
        for i, res in enumerate(results):
            if self.drift is not None and sim is not None and i < len(sim):
                # fed the ORIGINAL measured result — the monitor itself
                # skips identity pairs and fault-degraded steps
                self.drift.observe(res, sim[i])
            if res.faulted:
                self.faulted_skipped += 1
                if sim is not None and i < len(sim) and sim[i] is not res:
                    res = sim[i]
                else:
                    continue
            nk = float(kv_tokens[i]) if i < len(kv_tokens) else 0.0
            na = float(act_tokens[i]) if i < len(act_tokens) else 0.0
            tb = res.tag_busy or {}
            t_kv = tb.get("kv", 0.0)
            if t_kv > 0.0 and nk > 0.0:
                self._load.append(LaneSample(nk, t_kv / L))
                added += 1
            t_gen = tb.get("gen", 0.0)
            if t_gen == 0.0 and res.gpu_busy > 0.0 and sim is not None \
                    and i < len(sim):
                stb = sim[i].tag_busy or {}
                s_gen, s_fwd = stb.get("gen", 0.0), stb.get("fwd", 0.0)
                if s_gen + s_fwd > 0.0:
                    t_gen = res.gpu_busy * s_gen / (s_gen + s_fwd)
            if t_gen > 0.0 and na > 0.0:
                self._gen.append(LaneSample(na, t_gen / L))
                added += 1
            # cpu-attend lane: host spans carry the "cpu" tag; cpu_tokens
            # aligns per step like the other lanes
            nc = (float(cpu_tokens[i]) if cpu_tokens is not None
                  and i < len(cpu_tokens) else 0.0)
            t_cpu = tb.get("cpu", 0.0)
            if t_cpu > 0.0 and nc > 0.0:
                self._cpu.append(LaneSample(nc, t_cpu / L))
                added += 1
        self._since_update += 1
        return added

    # ------------------------------------------------------------------ refit
    def refit(self) -> Tuple[LinearFit, LinearFit]:
        """One damped EW refit of both lanes from the current windows; lanes
        without ``min_samples`` observations keep their current fit (no
        signal, no drift)."""
        c = self.ctl
        if len(self._gen) >= c.min_samples:
            self.fit_gen = ewma_refit(
                self.fit_gen, self.prior_gen, list(self._gen), alpha=c.alpha,
                damping=c.damping,
                intercept_scale_tokens=c.intercept_scale_tokens)
        if len(self._load) >= c.min_samples:
            self.fit_load = ewma_refit(
                self.fit_load, self.prior_load, list(self._load),
                alpha=c.alpha, damping=c.damping,
                intercept_scale_tokens=c.intercept_scale_tokens)
        if self.cpu and len(self._cpu) >= c.min_samples:
            self.fit_cpu = ewma_refit(
                self.fit_cpu, self.prior_cpu, list(self._cpu),
                alpha=c.alpha, damping=c.damping,
                intercept_scale_tokens=c.intercept_scale_tokens)
        return self.fit_gen, self.fit_load

    # --------------------------------------------------------------- retarget
    def target_allocation(self) -> HostAllocation:
        """Algorithm 1 under the current (refit) fits, re-expressed on the
        fixed host-block total: the target conserves act+kv(+cpu) exactly."""
        if self.cpu:
            ref = host_block_allocation_threeway(
                self.cfg, self.hw, self.n_act_gpu_blocks,
                fits=(self.fit_gen, self.fit_load, self.fit_cpu),
                generalized=self.generalized, quant=self.quant)
            tot = ref.total_blocks + ref.cpu_blocks
            if tot <= 0:
                return self.alloc
            act = int(round(ref.act_blocks / tot * self.total_host))
            act = min(max(act, 0), self.total_host)
            cpu = int(round(ref.cpu_blocks / tot * self.total_host))
            cpu = min(max(cpu, 0), self.total_host - act)
            return dataclasses.replace(
                self.alloc, act_blocks=act, cpu_blocks=cpu,
                kv_blocks=self.total_host - act - cpu)
        ref = host_block_allocation(
            self.cfg, self.hw, self.n_act_gpu_blocks,
            fits=(self.fit_gen, self.fit_load), generalized=self.generalized,
            quant=self.quant)
        act = int(round(ref.act_fraction * self.total_host))
        act = min(max(act, 0), self.total_host)
        return dataclasses.replace(self.alloc, act_blocks=act,
                                   kv_blocks=self.total_host - act)

    def update(self) -> HostAllocation:
        """Refit, retarget, and return the next applied allocation: one
        bounded, deadbanded step from ``self.alloc`` toward the target.
        The caller mirrors the step onto its pools and assigns the result
        back to ``self.alloc`` (possibly truncated further if its free
        capacity could not cover the whole step)."""
        c = self.ctl
        if self._since_update < c.update_every:
            return self.alloc
        self._since_update = 0
        self.refit()
        self.updates += 1
        target = self.target_allocation()
        delta = target.act_blocks - self.alloc.act_blocks
        d_cpu = (target.cpu_blocks - self.alloc.cpu_blocks) if self.cpu else 0
        if max(abs(delta), abs(d_cpu)) <= c.deadband_blocks(self.total_host):
            self.frac_history.append(self.alloc.act_fraction)
            return self.alloc
        bound = c.bound_blocks(self.total_host)
        step = int(np.clip(delta, -bound, bound))
        act = self.alloc.act_blocks + step
        self.migrated_blocks += abs(step)
        cpu = self.alloc.cpu_blocks
        if self.cpu:
            # cpu-lane step shares the migration bound and may not push kv
            # negative: kv = total - act - cpu stays >= 0
            s_cpu = int(np.clip(d_cpu, -bound, bound))
            s_cpu = min(s_cpu, self.total_host - act - cpu)
            cpu = max(cpu + s_cpu, 0)
            self.migrated_blocks += abs(s_cpu)
        out = dataclasses.replace(self.alloc, act_blocks=act, cpu_blocks=cpu,
                                  kv_blocks=self.total_host - act - cpu)
        self.frac_history.append(out.act_fraction)
        return out
