"""Config-driven memory budgets for the host-offload runtime (a copy of
``repro.configs.offload``).

The offload executor needs to know how much *device* memory it may treat as
resident: weight double buffers plus however many KV blocks fit.  On the
real target the budget is the accelerator's HBM; on the reduced CPU configs
the budget is deliberately TIGHT so the runtime exercises real spill — KV
regions physically living in the host arena between decode steps — instead
of quietly keeping everything device-resident at smoke scale.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import kv_block_bytes
from repro_torch.core.costmodel import layer_weight_bytes


@dataclass(frozen=True)
class OffloadBudget:
    dev_bytes: int            # device memory for weight buffers + KV blocks
    prefetch_depth: int = 1   # dispatch-ahead window (1 = double buffering)

    def dev_kv_blocks(self, cfg: ModelConfig) -> int:
        """KV blocks that fit after the streamer's resident weight buffers."""
        weights = (self.prefetch_depth + 1) * layer_weight_bytes(cfg)
        return max(int((self.dev_bytes - weights) // kv_block_bytes(cfg)), 0)


def _tight(cfg: ModelConfig, kv_blocks: int = 2,
           prefetch_depth: int = 1) -> OffloadBudget:
    """Just the streamer's double buffers + ``kv_blocks`` KV blocks: any
    realistically sized group overflows the device KV pool and spills."""
    dev = ((prefetch_depth + 1) * layer_weight_bytes(cfg)
           + kv_blocks * kv_block_bytes(cfg))
    return OffloadBudget(dev_bytes=dev, prefetch_depth=prefetch_depth)


#: per-config overrides (name -> budget); anything absent falls through to
#: the rule in ``offload_budget``.
BUDGETS: Dict[str, OffloadBudget] = {}


def offload_budget(cfg: ModelConfig) -> OffloadBudget:
    """Budget for a config: explicit entry if registered, else reduced
    (smoke) configs get the spill-forcing tight budget and full-size configs
    get a 16 GiB device-class budget."""
    if cfg.name in BUDGETS:
        return BUDGETS[cfg.name]
    if cfg.name.endswith("-reduced"):
        return _tight(cfg)
    return OffloadBudget(dev_bytes=16 * 2**30)
