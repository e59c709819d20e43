"""Dynamic mini-batch formation (paper §4.3.3): greedy bin packing.

balance = T_kv_gen(#ACT_mb) / T_load_kv(#KV_mb)          (Eq. 12)
F_b     = max(balance, 1/balance)                        (Eq. 13)

Greedy: grow the current mini-batch with the request that (a) fits the GPU
buffer bounds (#ACT_max, #KV_max) and (b) does not worsen F_b; when no request
qualifies, close the mini-batch.  Layer-level scheduling of the resulting
mini-batches follows FlexGen's zig-zag order in the engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.blocks import BLOCK_TOKENS
from repro_torch.core.costmodel import LinearFit

TAU = 1.5                      # F_b a batch may always grow to


@dataclass(frozen=True)
class RequestBlocks:
    rid: int
    act_blocks: int
    kv_blocks: int


@dataclass
class MiniBatch:
    requests: List[RequestBlocks] = field(default_factory=list)
    act_blocks: int = 0
    kv_blocks: int = 0

    def add(self, r: RequestBlocks) -> None:
        self.requests.append(r)
        self.act_blocks += r.act_blocks
        self.kv_blocks += r.kv_blocks


def balance_metric(act_blocks: int, kv_blocks: int,
                   fit_gen: LinearFit, fit_load: LinearFit) -> float:
    t_gen = float(fit_gen(act_blocks * BLOCK_TOKENS))
    t_load = float(fit_load(kv_blocks * BLOCK_TOKENS))
    if t_load <= 0.0:
        return float("inf") if t_gen > 0 else 1.0
    return t_gen / t_load


def f_b(act_blocks: int, kv_blocks: int,
        fit_gen: LinearFit, fit_load: LinearFit) -> float:
    bal = balance_metric(act_blocks, kv_blocks, fit_gen, fit_load)
    if bal == 0.0 or bal == float("inf"):
        return float("inf")
    return max(bal, 1.0 / bal)


def form_minibatches(requests: Sequence[RequestBlocks],
                     fit_gen: LinearFit, fit_load: LinearFit,
                     act_max: int, kv_max: int) -> List[MiniBatch]:
    """Greedy packing minimising mini-batch count then F_b (paper §4.3.3).

    Interpretation note: the paper accepts a request iff it "reduces F_b
    relative to the current mini-batch state", but it simultaneously claims to
    minimise the NUMBER of mini-batches — with homogeneous requests a strictly
    decreasing F_b would force one request per batch.  We therefore accept a
    request when F_b stays within ``max(current F_b, TAU)``: batches fill to
    the capacity bounds while imbalance stays bounded, and each addition picks
    the candidate with the smallest resulting F_b (the paper's greedy choice).
    """
    pending = sorted(requests, key=lambda r: -(r.act_blocks + r.kv_blocks))
    batches: List[MiniBatch] = []
    while pending:
        mb = MiniBatch()
        progress = True
        while progress:
            progress = False
            best_i, best_f = None, None
            cur_f = (f_b(mb.act_blocks, mb.kv_blocks, fit_gen, fit_load)
                     if mb.requests else float("inf"))
            bound = max(cur_f * 1.05, TAU)   # 5% slack packs ratio-similar tails
            for i, r in enumerate(pending):
                if (mb.act_blocks + r.act_blocks > act_max or
                        mb.kv_blocks + r.kv_blocks > kv_max):
                    continue
                nf = f_b(mb.act_blocks + r.act_blocks,
                         mb.kv_blocks + r.kv_blocks, fit_gen, fit_load)
                if mb.requests and nf > bound * (1.0 + 1e-6):
                    continue
                if best_f is None or nf < best_f:
                    best_i, best_f = i, nf
            if best_i is not None:
                mb.add(pending.pop(best_i))
                progress = True
        if not mb.requests:           # nothing fits an empty batch: oversized
            r = pending.pop(0)
            mb.add(r)
        batches.append(mb)
    return batches
