"""Cache management policy (paper §4.3, Algorithm 1 + Eq. 11).

A copy of ``repro.core.policy``: Algorithm 1 as the paper states it
(``generalized=False``, the engine's) or with the reference's
byte-ratio-aware balance (``generalized=True``, the continuous-batching
server's default); ``quant=`` prices blocks and the lane fits by the
quantized layout; ``fits=`` takes the adaptive controller's refit lanes; the
three-way law (``*_threeway``) adds the host-attention lane.

Step 1  initial_cache_allocation  — blocks needed to kill pipeline idleness
Step 2  alloc_remaining           — fill the rest of host memory balanced
Step 3  request ratio             — every request keeps #ACT:#KV = host ratio
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant as Q
from repro_torch.core.blocks import BLOCK_TOKENS, act_block_bytes, kv_block_bytes
from repro_torch.core.costmodel import HardwareSpec, LinearFit, profile_cost_fns, t_load_w

DEVICE_MEM_FRAC = 0.7          # share of device memory given to ACT blocks


@dataclass(frozen=True)
class HostAllocation:
    act_blocks: int
    kv_blocks: int
    act_init: int
    kv_init: int
    # host KV blocks placed on the cpu-attend lane: KV-shaped in the host
    # arena but attended on host cores instead of loaded over the link
    # (the three-way law); 0 keeps the two-way allocation
    cpu_blocks: int = 0

    @property
    def total_blocks(self) -> int:
        return self.act_blocks + self.kv_blocks

    @property
    def act_fraction(self) -> float:
        """#ACT_Host / (#ACT_Host + #KV_Host).  Total-relative, so it is
        finite at both corners (the old ``ratio`` property returned ``inf``
        for the all-ACT allocation and poisoned float plumbing downstream;
        ratio decisions now compare the (act_blocks, kv_blocks) pair in
        integer arithmetic — see ``store_act_schedule``)."""
        return self.act_blocks / self.total_blocks if self.total_blocks else 0.0


def _blocks_to_tokens(n_blocks: float) -> float:
    return n_blocks * BLOCK_TOKENS


def initial_cache_allocation(cfg: ModelConfig, hw: HardwareSpec,
                             fit_gen: LinearFit, fit_load: LinearFit,
                             n_act_gpu_blocks: int) -> Tuple[int, int]:
    """Algorithm 1 lines 10-18: eliminate idle time vs. weight loading."""
    T_w = t_load_w(cfg, hw)
    T_budget = T_w - fit_gen(_blocks_to_tokens(n_act_gpu_blocks))
    act_init = kv_init = 0
    if T_budget >= 0:
        act_init = int(fit_gen.inverse(T_budget) // BLOCK_TOKENS)
    else:
        kv_init = int(fit_load.inverse(-T_budget) // BLOCK_TOKENS)
    return act_init, kv_init


def alloc_remaining(cfg: ModelConfig, hw: HardwareSpec,
                    fit_gen: LinearFit, fit_load: LinearFit,
                    act_init: int, kv_init: int, generalized: bool = False,
                    quant=None) -> Tuple[int, int]:
    """Algorithm 1 lines 20-27: fill remaining host memory with the balanced
    2x2 linear system  {S_ACT*a + S_KV*k = M_rem ; T_gen(a) = T_load(k)}.

    ``generalized=True`` is the reference's byte-ratio-aware balance: the
    paper's Eq. 9 omits the link cost of loading the ACT blocks themselves,
    which cancels for MHA (ACT = KV/2) but misallocates under GQA, where an
    ACT block costs more link bytes than the KV block it replaces.  It moves
    T_load_act to the link side:  T_gen(a) = T_load_kv(k) - T_load_act(a)."""
    S_act = act_block_bytes(cfg, quant=quant)
    S_kv = kv_block_bytes(cfg, quant=quant)
    S_weight = cfg.num_params() * cfg.bytes_per_param()
    M_occ = S_act * act_init + S_kv * kv_init
    M_rem = hw.host_mem - S_weight - M_occ
    if M_rem <= 0:
        return 0, 0
    # T_gen(a_tokens) = T_load(k_tokens), per-block token scaling
    ga = fit_gen.slope * BLOCK_TOKENS
    lk = fit_load.slope * BLOCK_TOKENS
    c = fit_load.intercept - fit_gen.intercept
    if generalized:
        # ACT bytes per block over the same link, priced by the fitted
        # KV-load slope scaled by the ACT:KV byte ratio
        la = (fit_load.slope * BLOCK_TOKENS
              * Q.act_bytes_per_token(cfg, quant)
              / Q.kv_bytes_per_token(cfg, quant))
        ga = ga + la
    # solve: S_act*a + S_kv*k = M_rem ;  ga*a - lk*k = c
    A = np.array([[S_act, S_kv], [ga, -lk]], float)
    b = np.array([M_rem, c], float)
    try:
        a, k = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        a, k = 0.0, M_rem / S_kv
    if a < 0:                         # all-KV corner (GQA archs: ACT never pays)
        return 0, int(M_rem // S_kv)
    if k < 0:                         # all-ACT corner
        return int(M_rem // S_act), 0
    return int(a), int(k)


def host_block_allocation(cfg: ModelConfig, hw: HardwareSpec,
                          n_act_gpu_blocks: int,
                          fits: Tuple[LinearFit, LinearFit] = None,
                          generalized: bool = False,
                          quant=None) -> HostAllocation:
    """Algorithm 1 top level: -> #ACT_Host, #KV_Host.  ``fits``: (fit_gen,
    fit_load), profiled when None; ``quant`` reprices block sizes and the
    profiled fits, so the KV:ACT split re-balances; ``generalized`` as for
    ``alloc_remaining``."""
    fit_gen, fit_load = fits if fits is not None else \
        profile_cost_fns(cfg, hw, quant=quant)
    act_init, kv_init = initial_cache_allocation(
        cfg, hw, fit_gen, fit_load, n_act_gpu_blocks)
    act_rem, kv_rem = alloc_remaining(cfg, hw, fit_gen, fit_load, act_init,
                                      kv_init, generalized=generalized,
                                      quant=quant)
    return HostAllocation(act_blocks=act_init + act_rem,
                          kv_blocks=kv_init + kv_rem,
                          act_init=act_init, kv_init=kv_init)


def alloc_remaining_threeway(cfg: ModelConfig, hw: HardwareSpec,
                             fit_gen: LinearFit, fit_load: LinearFit,
                             fit_cpu: LinearFit,
                             act_init: int, kv_init: int,
                             generalized: bool = False,
                             quant=None) -> Tuple[int, int, int]:
    """Three-way Algorithm 1: fill the remaining host memory so that all
    three lanes finish together.

        S_ACT*a + S_KV*(k + c) = M_rem
        T_gen(a) = T_load(k)            (device regen vs link load)
        T_gen(a) = T_cpu(c)             (device regen vs host attend)

    ``c`` blocks stay KV-shaped in the host arena but are attended on host
    cores: no link bytes, no regen FLOPs.  A negative corner falls back to
    the best two-way split over the lanes that survive.
    -> (act_blocks, kv_blocks, cpu_blocks)."""
    S_act = act_block_bytes(cfg, quant=quant)
    S_kv = kv_block_bytes(cfg, quant=quant)
    S_weight = cfg.num_params() * cfg.bytes_per_param()
    M_occ = S_act * act_init + S_kv * kv_init
    M_rem = hw.host_mem - S_weight - M_occ
    if M_rem <= 0:
        return 0, 0, 0
    ga = fit_gen.slope * BLOCK_TOKENS
    lk = fit_load.slope * BLOCK_TOKENS
    cc = fit_cpu.slope * BLOCK_TOKENS
    c1 = fit_load.intercept - fit_gen.intercept
    c2 = fit_cpu.intercept - fit_gen.intercept
    if generalized:
        la = (fit_load.slope * BLOCK_TOKENS
              * Q.act_bytes_per_token(cfg, quant)
              / Q.kv_bytes_per_token(cfg, quant))
        ga = ga + la
    A = np.array([[S_act, S_kv, S_kv],
                  [ga, -lk, 0.0],
                  [ga, 0.0, -cc]], float)
    b = np.array([M_rem, c1, c2], float)
    try:
        a, k, c = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        a, k, c = -1.0, -1.0, -1.0        # degenerate: fall through to 2-way
    if a >= 0 and k >= 0 and c >= 0:
        return int(a), int(k), int(c)
    if c < 0:                             # the cpu lane never pays: 2-way
        a2, k2 = alloc_remaining(cfg, hw, fit_gen, fit_load, act_init,
                                 kv_init, generalized=generalized,
                                 quant=quant)
        return a2, k2, 0
    if a < 0:                             # regen never pays: link vs cpu
        tot = M_rem / S_kv
        d = fit_cpu.intercept - fit_load.intercept
        if lk + cc > 0:
            k2 = float(np.clip((cc * tot + d) / (lk + cc), 0.0, tot))
        else:
            k2 = 0.0
        return 0, int(k2), int(tot - k2)
    # k < 0: the link never pays: regen vs cpu
    A2 = np.array([[S_act, S_kv], [ga, -cc]], float)
    b2 = np.array([M_rem, c2], float)
    try:
        a2, c2b = np.linalg.solve(A2, b2)
    except np.linalg.LinAlgError:
        return 0, 0, int(M_rem // S_kv)
    if a2 < 0:
        return 0, 0, int(M_rem // S_kv)
    if c2b < 0:
        return int(M_rem // S_act), 0, 0
    return int(a2), 0, int(c2b)


def host_block_allocation_threeway(cfg: ModelConfig, hw: HardwareSpec,
                                   n_act_gpu_blocks: int,
                                   fits=None, generalized: bool = False,
                                   quant=None) -> HostAllocation:
    """Three-way Algorithm 1 -> ``HostAllocation`` with ``cpu_blocks``.
    ``fits``: (fit_gen, fit_load, fit_cpu), profiled with ``cpu=True`` when
    None.  The init step is the paper's; only the fill balances three
    lanes."""
    if fits is None:
        fits = profile_cost_fns(cfg, hw, quant=quant, cpu=True)
    fit_gen, fit_load, fit_cpu = fits
    act_init, kv_init = initial_cache_allocation(
        cfg, hw, fit_gen, fit_load, n_act_gpu_blocks)
    a, k, c = alloc_remaining_threeway(cfg, hw, fit_gen, fit_load, fit_cpu,
                                       act_init, kv_init,
                                       generalized=generalized, quant=quant)
    return HostAllocation(act_blocks=act_init + a, kv_blocks=kv_init + k,
                          act_init=act_init, kv_init=kv_init, cpu_blocks=c)


def request_block_split(alloc: HostAllocation, context_blocks: int) -> Tuple[int, int]:
    """Eq. 11: split one request's context blocks in the host ACT:KV ratio."""
    total = alloc.act_blocks + alloc.kv_blocks
    if total == 0:
        return 0, context_blocks
    n_act = int(round(context_blocks * alloc.act_blocks / total))
    return n_act, context_blocks - n_act


def device_act_blocks(cfg: ModelConfig, hw: HardwareSpec,
                      frac: float = DEVICE_MEM_FRAC, quant=None) -> int:
    """ACT blocks that fit the device-memory budget (weights stream)."""
    per_block = act_block_bytes(cfg, quant=quant)
    return int(hw.device_mem * frac / per_block)


def policy_act_ratio(cfg: ModelConfig, hw: HardwareSpec,
                     generalized: bool = False) -> float:
    """Fraction of HOST context tokens to keep as ACT, per Algorithm 1 +
    Eq. 11 — the knob the benchmarks compare against the brute-force best."""
    alloc = host_block_allocation(cfg, hw, device_act_blocks(cfg, hw),
                                  generalized=generalized)
    total = alloc.act_blocks + alloc.kv_blocks
    return alloc.act_blocks / total if total else 0.0


def store_act_schedule(alloc: HostAllocation, act_tokens0, kv_tokens0,
                       n_steps: int) -> np.ndarray:
    """Precompute the per-token ``store_act`` decisions for a whole decode.

    The running-ratio rule (Eq. 11: keep #ACT:#KV at the host ratio, as
    ``repro.core.policy.next_block_kind`` states it) is deterministic given
    the Algorithm-1 allocation and
    the running block counts, and block counts are a pure function of token
    counts (a new block opens exactly when the previous block of that kind is
    full), so the entire generation schedule is known before the first decode
    step.  The engine feeds the resulting (B, n_steps) bool array into the
    jitted ``lax.scan`` decode loop and replays it through the BlockManager
    afterwards — identical accounting with zero per-token host work on the
    hot path.

    act_tokens0 / kv_tokens0: (B,) token counts right after prefill.
    Returns (B, n_steps) bool — True where the token's checkpoint goes to the
    ACT region (assumes block allocation never fails, as the engine does).
    """
    at = np.asarray(act_tokens0, np.int64).copy()
    kt = np.asarray(kv_tokens0, np.int64).copy()
    B = at.shape[0]
    out = np.zeros((B, n_steps), bool)
    if alloc.kv_blocks == 0:
        out[:] = True
        return out
    if alloc.act_blocks == 0:
        return out
    A, K = alloc.act_blocks, alloc.kv_blocks
    for s in range(n_steps):                      # vectorized over B
        ab = -(-at // BLOCK_TOKENS)               # ceil: blocks of each kind
        kb = -(-kt // BLOCK_TOKENS)
        m = np.maximum(kb, 1)
        # |r_act - A/K| <= |r_kv - A/K| cross-multiplied to integers,
        # elementwise over the batch
        d_act = np.abs((ab + 1) * K - A * m) * (kb + 1)
        d_kv = np.abs(ab * K - A * (kb + 1)) * m
        store = d_act <= d_kv
        out[:, s] = store
        at += store
        kt += ~store
    return out
