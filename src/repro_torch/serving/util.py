"""Shared serving helpers (copied from ``repro.serving.util``), and the
adaptive controller's hooks that the engine and the server share."""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import List, Tuple

import numpy as np

from repro_torch.core.blocks import BLOCK_TOKENS, BlockType, Location


def trace_ctx(plan):
    """Context for the serving calls: installs the plan's mesh into the
    shardhints thread-local, so ``SH.constrain`` resolves against it.
    ``plan=None`` is a no-op: the single-device paths run as before."""
    if plan is None:
        return nullcontext()
    from repro_torch.models import shardhints as SH
    return SH.use_mesh(plan.mesh)


def bucket(n: int, mult: int = 16) -> int:
    """Round ``n`` up to the next multiple of ``mult`` (minimum one bucket).

    Prompt lengths are padded to these buckets so a group's prefill shares
    one shape; 16 matches ``BLOCK_TOKENS``, the page size.
    """
    return max(mult, (n + mult - 1) // mult * mult)


def kv_keep_for(pb: int, act_frac: float, kv_cap: int, act_cap: int, *,
                mode: str = "hybrid", clamp: bool = False) -> int:
    """KV tokens of a ``pb``-token prefix: the Eq. 11 split at ``act_frac``,
    block-aligned (``mode`` "kv": all of it, "act": none).

    ``clamp=True`` (the server's admission): a split that violates a per-slot
    cap is clamped into the feasible block-aligned window
    [pb − act_cap, kv_cap], which is token-exact by the hybrid equivalence.
    A prefix that fits neither region combined (pb > kv_cap + act_cap) is
    left as it is, for the caller to refuse.
    """
    kk = int(round(pb * (1 - act_frac) / BLOCK_TOKENS)) * BLOCK_TOKENS
    if mode == "kv":
        kk = pb
    if mode == "act":
        kk = 0
    if clamp and pb <= kv_cap + act_cap:
        lo = bucket(max(pb - act_cap, 0)) if pb > act_cap else 0
        kk = min(max(kk, lo), min(kv_cap, pb))
    return kk


def pack_group(requests, act_frac: float, kv_cap: int, act_cap: int, *,
               mode: str = "hybrid", clamp: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Pad a group of prompts to the common bucket and split each at the
    Eq. 11 ratio (block-aligned) — the preamble of the engine's group
    prefill and of the continuous-batching server's coalesced admission.

    -> (tokens (B, Smax) int32 padded with each prompt's last token,
        kv_keep (B,) int32, per-request buckets pbs).

    The batched prefill places per-request prefixes by masking, so an
    overfull region would truncate SILENTLY — fail loudly here instead.

    ``clamp=True`` (the server's admission): each split is clamped into its
    feasible window (``kv_keep_for``) instead of raising.  A prefix that fits
    neither region combined (pbs > kv_cap + act_cap) still raises.
    """
    plens = [len(r.prompt) for r in requests]
    pbs = [bucket(p) for p in plens]
    Smax = max(pbs)
    toks = np.zeros((len(requests), Smax), np.int32)
    kv_keep = np.zeros((len(requests),), np.int32)
    for i, r in enumerate(requests):
        toks[i, :plens[i]] = r.prompt
        toks[i, plens[i]:] = r.prompt[-1]       # pad with last token
        kv_keep[i] = kv_keep_for(pbs[i], act_frac, kv_cap, act_cap,
                                 mode=mode, clamp=clamp)
    if int(kv_keep.max()) > kv_cap:
        raise ValueError(f"kv_keep={int(kv_keep.max())} exceeds "
                         f"kv_cap={kv_cap}; raise kv_cap")
    if int((np.asarray(pbs) - kv_keep).max()) > act_cap:
        raise ValueError(
            f"ACT prefix {int((np.asarray(pbs) - kv_keep).max())} "
            f"exceeds act_cap={act_cap}; raise act_cap")
    return toks, kv_keep, pbs


def retag_toward(blockman, alloc, new_alloc):
    """Retag host pool capacity from ``alloc`` toward ``new_alloc``'s ACT
    blocks and -> the allocation that actually moved: free capacity only,
    so live blocks are never stranded."""
    delta = new_alloc.act_blocks - alloc.act_blocks
    if delta > 0:
        moved = blockman.retag_capacity(Location.HOST, BlockType.KV,
                                        BlockType.ACT, delta)
    elif delta < 0:
        moved = -blockman.retag_capacity(Location.HOST, BlockType.ACT,
                                         BlockType.KV, -delta)
    else:
        moved = 0
    return dataclasses.replace(alloc, act_blocks=alloc.act_blocks + moved,
                               kv_blocks=alloc.kv_blocks - moved)


def collect_block_metrics(reg, blockman, act_frac, controller) -> None:
    """The gauges the engine's and the server's collectors share, read at
    ``snapshot()`` time: occupancy by tag, retags, the ACT fraction and the
    controller's state."""
    for (kind, loc), pool in blockman.pools.items():
        labels = dict(kind=kind.value, tier=loc.value)
        reg.gauge("blocks_capacity", **labels).set(pool.capacity)
        reg.gauge("blocks_allocated", **labels).set(pool.allocated)
    for (loc, src, dst), n in blockman.retags.items():
        reg.counter("retagged_blocks", tier=loc.value, src=src.value,
                    dst=dst.value).set(n)
    reg.gauge("act_fraction").set(act_frac)
    if controller is not None:
        reg.gauge("controller_updates").set(controller.updates)
        reg.gauge("controller_migrated_blocks").set(controller.migrated_blocks)
        reg.gauge("controller_faulted_skipped").set(controller.faulted_skipped)
