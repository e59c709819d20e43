"""Shared serving helpers (copied from ``repro.serving.util``)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.blocks import BLOCK_TOKENS


def bucket(n: int, mult: int = 16) -> int:
    """Round ``n`` up to the next multiple of ``mult`` (minimum one bucket).

    Prompt lengths are padded to these buckets so a group's prefill shares
    one shape; 16 matches ``BLOCK_TOKENS``, the page size.
    """
    return max(mult, (n + mult - 1) // mult * mult)


def pack_group(requests, act_frac: float, kv_cap: int, act_cap: int, *,
               mode: str = "hybrid"
               ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Pad a group of prompts to the common bucket and split each at the
    Eq. 11 ratio (block-aligned) — the preamble of the engine's group
    prefill.

    -> (tokens (B, Smax) int32 padded with each prompt's last token,
        kv_keep (B,) int32, per-request buckets pbs).

    The batched prefill places per-request prefixes by masking, so an
    overfull region would truncate SILENTLY — fail loudly here instead.
    """
    plens = [len(r.prompt) for r in requests]
    pbs = [bucket(p) for p in plens]
    Smax = max(pbs)
    toks = np.zeros((len(requests), Smax), np.int32)
    kv_keep = np.zeros((len(requests),), np.int32)
    for i, r in enumerate(requests):
        toks[i, :plens[i]] = r.prompt
        toks[i, plens[i]:] = r.prompt[-1]       # pad with last token
        kk = int(round(pbs[i] * (1 - act_frac) / BLOCK_TOKENS)) * BLOCK_TOKENS
        if mode == "kv":
            kk = pbs[i]
        if mode == "act":
            kk = 0
        kv_keep[i] = kk
    if int(kv_keep.max()) > kv_cap:
        raise ValueError(f"kv_keep={int(kv_keep.max())} exceeds "
                         f"kv_cap={kv_cap}; raise kv_cap")
    if int((np.asarray(pbs) - kv_keep).max()) > act_cap:
        raise ValueError(
            f"ACT prefix {int((np.asarray(pbs) - kv_keep).max())} "
            f"exceeds act_cap={act_cap}; raise act_cap")
    return toks, kv_keep, pbs
