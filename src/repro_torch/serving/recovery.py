"""Pressure recovery for the continuous-batching server (a copy of
``repro.serving.recovery``).

When the block pools exhaust mid-chunk, the server preempts victims instead
of failing: a victim's KV blocks are demoted to ACT checkpoints
(``BlockManager.demote_request_kv``), regenerable KV at d_model per token,
when ACT capacity exists; otherwise all of its blocks are dropped and it
resumes by recomputing from its token IDs.  Both resumes re-prefill over
prompt + generated prefix and are token-exact under greedy decoding.

This module is the bookkeeping: the structured capacity error, the
preemption and parking types, and the resume-cost pricing.  The mechanism
lives in ``ContinuousBatchingServer``.  Parked requests hold no blocks beyond
their demoted ACT prefix (none in token mode), resume at chunk boundaries
ahead of fresh arrivals, and are bounded by ``RecoveryConfig.max_parked``: a
genuinely overcommitted server still raises ``CapacityError``, with the
affected rids and a hint.

``RecoveryStats`` is a ``ScalarStatsView``: with a metrics registry its
fields are live views over ``recovery_*`` counters, without one plain
attributes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.blocks import BLOCK_TOKENS
from repro_torch.data.pipeline import Request
from repro_torch.obs.metrics import ScalarStatsView


class CapacityError(RuntimeError):
    """A capacity limit was hit and recovery could not absorb it.

    Carries the affected request ids and a hint naming the knob that would
    have prevented the raise.  The server releases every affected slot,
    table and parked holding before raising, so it stays admissible."""

    def __init__(self, message: str, *, rids: Sequence[int] = (),
                 resource: str = "blocks", hint: str = ""):
        self.rids = list(rids)
        self.resource = resource
        self.hint = hint
        full = message
        if rids:
            full += f" [rids={self.rids}]"
        if hint:
            full += f" (hint: {hint})"
        super().__init__(full)


@dataclass(frozen=True)
class RecoveryConfig:
    """Preemption and re-admission knobs.

    ``max_parked``: bound on the re-admission queue; 0 disables preemption
    (fail-loud, with ``CapacityError``).  ``max_preempts_per_request``:
    progress guard, a request preempted this often is no longer a victim.
    ``prefer_act``: demote victims' KV to ACT when ACT capacity exists;
    False always drops to token IDs."""
    max_parked: int = 16
    max_preempts_per_request: int = 8
    prefer_act: bool = True


@dataclass
class ParkedRequest:
    """A preempted request awaiting re-admission.

    ``generated``: tokens emitted before preemption (prompt + these form the
    resume prefix).  ``mode``: "act", the victim's KV was demoted to ACT
    blocks and its table is still live in the BlockManager; "tokens", all
    blocks were dropped.  ``preempts``: times this request was preempted."""
    request: Request
    generated: List[int] = field(default_factory=list)
    mode: str = "act"                     # "act" | "tokens"
    preempts: int = 1

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def remaining(self) -> int:
        return self.request.max_new_tokens - len(self.generated)

    @property
    def prefix_tokens(self) -> int:
        """The resume prefix's length: the prompt as it was served, padded
        to its block bucket, plus the generated tokens."""
        padded = -(-len(self.request.prompt) // BLOCK_TOKENS) * BLOCK_TOKENS
        return padded + len(self.generated)


class RecoveryStats(ScalarStatsView):
    """Preemption and degraded-mode counters, surfaced on the server: plain
    attributes, or, constructed with a ``MetricsRegistry``, live views over
    its ``recovery_*`` counters (one source of truth with ``snapshot()``)."""

    _FIELDS = {
        "preemptions": 0,
        "preempt_to_act": 0,              # victims demoted KV -> ACT
        "preempt_to_tokens": 0,           # victims dropped to token IDs
        "demoted_blocks": 0,
        "dropped_blocks": 0,
        "resumes": 0,
        "resume_from_act": 0,
        "resume_from_tokens": 0,
        "sched_clamps": 0,                # store flags flipped off a full region
        "parked_degraded": 0,             # parked ACT holdings dropped to tokens
        "resume_cost_s": 0.0,             # simulated seconds spent on resumes
        "parked_peak": 0,
    }

    def __init__(self, registry=None):
        super().__init__(registry, prefix="recovery")


def blocks_for_tokens(t0: int, t1: int) -> int:
    """New blocks needed to grow a region from ``t0`` to ``t1`` tokens (block
    boundaries every BLOCK_TOKENS)."""
    return -(-max(t1, 0) // BLOCK_TOKENS) - (-(-max(t0, 0) // BLOCK_TOKENS))


def resume_cost(cfg: ModelConfig, hw: cm.HardwareSpec,
                fits: Optional[Tuple[cm.LinearFit, cm.LinearFit]],
                prefix_tokens: int, mode: str) -> float:
    """Simulated seconds one resume costs, in the server's sim_time units:
    "act" regenerates KV over the prefix (the profiled KV-Gen fit per
    layer), "tokens" recomputes the full forward at prefill MFU."""
    n = max(int(prefix_tokens), 0)
    if n == 0:
        return 0.0
    if mode == "act":
        if fits is not None:
            per_layer = float(fits[0](n))
        else:
            per_layer = n * cm.kv_gen_flops_per_token(cfg) / (
                hw.flops * hw.gen_mfu)
        return per_layer * cfg.num_layers + hw.dispatch_overhead
    flops = n * cm.forward_flops_per_token(cfg, n) * cfg.num_layers
    return flops / (hw.flops * hw.mfu) + hw.dispatch_overhead
