"""Deterministic fault injection for the offload lanes (a copy of
``repro.offload.faults``; the draws are identical for the same seed and site).

The offload runtime's failure model is exercised, not assumed: a seeded
``FaultPlan`` decides — reproducibly — when a staging copy stalls, runs
slow, fails transiently, or when the host spill arena denies an
allocation.  Sites consult the plan at well-defined points:

  * ``WeightStreamer`` when it issues a layer's copy, site ``"stage:0"``
    (stall / slow / copy_fail — the PCIe lane misbehaving),
  * the CPU attention lane per submitted job, site ``"host_attn"``,
  * the engine's spill allocation, site ``"arena"``
    (deny — transient host-arena exhaustion).

Each site owns an independent seeded RNG stream, so the event sequence at
one site depends only on the seed and that site's call order, never on wall
clock or thread timing.  ``max_events`` bounds the number of injected events
per (site, kind), so a faulted run always has a fault-free tail: the
retry/fallback ladders terminate and tests can assert token-exact
completion.

The injected *amounts* are seconds: a stall is long enough to trip a
watchdog deadline, a slowdown is not.  The consumers (streamer watchdog,
host-lane watchdog, engine arena fallback) are the subject under test; this
module only decides *when*.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


class TransientCopyError(RuntimeError):
    """A staging copy failed in a retryable way (injected or real)."""


#: retries of a failed copy (weight slot or host-attend job) before the lane
#: gives up and degrades; the reference's default
MAX_COPY_RETRIES = 2


#: fault kinds a plan can draw, in evaluation priority order
FAULT_KINDS = ("stall", "copy_fail", "slow", "deny")


@dataclass(frozen=True)
class FaultEvent:
    kind: str                 # one of FAULT_KINDS
    seconds: float = 0.0      # sleep injected on the drawing thread


class FaultPlan:
    """Seeded, deterministic fault schedule.

    Probabilities are evaluated per ``draw`` in ``FAULT_KINDS`` priority
    order (a stall masks a slow at the same draw); at most one event is
    returned per draw.  ``max_events`` caps injections per (site, kind).

    ``injected`` counts what was actually drawn, keyed ``"site:kind"`` —
    tests assert against it, and a zero-probability plan is a sound no-op
    wrapper (every draw returns None and costs one RNG advance).
    """

    def __init__(self, seed: int = 0, *, stall_p: float = 0.0,
                 stall_s: float = 0.05, slow_p: float = 0.0,
                 slow_s: float = 0.005, copy_fail_p: float = 0.0,
                 arena_deny_p: float = 0.0, max_events: Optional[int] = 4):
        for p in (stall_p, slow_p, copy_fail_p, arena_deny_p):
            assert 0.0 <= p <= 1.0, p
        self.seed = int(seed)
        self.stall_p, self.stall_s = float(stall_p), float(stall_s)
        self.slow_p, self.slow_s = float(slow_p), float(slow_s)
        self.copy_fail_p = float(copy_fail_p)
        self.arena_deny_p = float(arena_deny_p)
        self.max_events = max_events
        self._rngs: Dict[str, np.random.Generator] = {}
        self.draws: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    # ------------------------------------------------------------------ draw
    def _rng(self, site: str) -> np.random.Generator:
        rng = self._rngs.get(site)
        if rng is None:
            rng = np.random.default_rng(
                [self.seed, zlib.crc32(site.encode())])
            self._rngs[site] = rng
        return rng

    def _capped(self, site: str, kind: str) -> bool:
        if self.max_events is None:
            return False
        return self.injected.get(f"{site}:{kind}", 0) >= self.max_events

    def _hit(self, site: str, kind: str, p: float, r: float) -> bool:
        return p > 0.0 and r < p and not self._capped(site, kind)

    def draw(self, site: str,
             kinds: tuple = FAULT_KINDS) -> Optional[FaultEvent]:
        """One deterministic decision for ``site``; None = no fault.

        ``kinds`` restricts which fault kinds the site can experience (an
        arena only ever sees ``deny``; a staging copy never does) without
        perturbing the RNG stream — one uniform per kind is consumed
        unconditionally, so the sequence at a site depends only on the seed
        and the site's call order."""
        rng = self._rng(site)
        self.draws[site] = self.draws.get(site, 0) + 1
        rs = rng.random(4)
        ev: Optional[FaultEvent] = None
        if "stall" in kinds and self._hit(site, "stall", self.stall_p, rs[0]):
            ev = FaultEvent("stall", self.stall_s)
        elif "copy_fail" in kinds and self._hit(site, "copy_fail",
                                                self.copy_fail_p, rs[1]):
            ev = FaultEvent("copy_fail")
        elif "slow" in kinds and self._hit(site, "slow", self.slow_p, rs[2]):
            ev = FaultEvent("slow", self.slow_s)
        elif "deny" in kinds and self._hit(site, "deny", self.arena_deny_p,
                                           rs[3]):
            ev = FaultEvent("deny")
        if ev is not None:
            key = f"{site}:{ev.kind}"
            self.injected[key] = self.injected.get(key, 0) + 1
        return ev

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())
