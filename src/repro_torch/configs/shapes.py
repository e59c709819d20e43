"""The four assigned input shapes and which step kind each one lowers
(copied from ``repro.configs.shapes``)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# long_500k runs only for the sub-quadratic, windowed and SSM-majority
# architectures; the pure full-attention ones are skipped
LONG_CONTEXT_ARCHS = frozenset({
    "gemma3-27b", "gemma3-1b", "jamba-1.5-large-398b", "mamba2-2.7b",
})


def applicable(arch_name: str, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True
