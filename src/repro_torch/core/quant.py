"""Block-granular cache quantization config + byte math (a copy of
``repro.core.quant``).

The paper's Algorithm-1 balance point is set by bytes moved per block over
the host link; quantizing KV and ACT blocks to 1-byte payloads with
absmax scales cuts those bytes 2-4x.  This module is the single source of
truth for WHAT a quantized block weighs:

  * KV block rows: int8 (or fp8) per (token, kv-head) over head_dim, one
    ``scale_dtype`` absmax scale per (token, kv-head).
  * ACT block rows: 1-byte payload per token over d_model with one scale
    per token.

``core.blocks`` block bytes, ``core.costmodel`` lane slopes,
``core.pipeline`` simulated traffic, the offload spill arena and
``BlockManager.explain()`` price blocks through the two helpers at the
bottom, so quant=None (the default) is the unquantized byte math.

Unlike the reference, whose hot path fake-quantizes every cache write and
keeps the cache in the model dtype, the port stores what fake quantization
stands for: int8 codes with float16 scale sidecars in the device regions,
dequantized on the tile by the kernels (``models.quant_ops``).
``SCALE_FLOOR`` is the f16-representable absmax-scale floor shared by every
quantizer.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig

#: absmax-scale floor, exactly representable in float16 (= f16 min NORMAL,
#: 2**-14 ≈ 6.1e-5): survives the f32 -> f16 scale cast with full mantissa
#: precision, so an all-zero slice stores a tiny-but-finite scale and
#: dequantizes back to exact zeros (codes are 0) instead of inf.
SCALE_FLOOR = 2.0 ** -14

#: supported 1-byte payload formats.  "fp8" is layout-ready only, as in the
#: reference: byte accounting and block metadata treat it as a 1-byte
#: payload with the same scale layout, but the numeric paths implement int8.
_PAYLOAD_BYTES = {"int8": 1, "fp8": 1}
_SCALE_BYTES = {"float16": 2, "bfloat16": 2, "float32": 4}


@dataclass(frozen=True)
class QuantConfig:
    """Cache-block quantization knobs.  Frozen (hashable); ``None`` in
    every engine signature means quant off: the config dtype's bytes and
    numerics."""
    kv_dtype: str = "int8"        # K/V payload: "int8" | "fp8"
    act_dtype: str = "int8"       # ACT payload: "int8" | "fp8"
    scale_dtype: str = "float16"  # absmax scales (fp8-ready layout)

    def __post_init__(self):
        for d in (self.kv_dtype, self.act_dtype):
            if d not in _PAYLOAD_BYTES:
                raise ValueError(f"unsupported payload dtype {d!r} "
                                 f"(supported: {sorted(_PAYLOAD_BYTES)})")
        if self.scale_dtype not in _SCALE_BYTES:
            raise ValueError(f"unsupported scale dtype {self.scale_dtype!r} "
                             f"(supported: {sorted(_SCALE_BYTES)})")

    # ------------------------------------------------------------ byte math
    @property
    def scale_bytes(self) -> int:
        return _SCALE_BYTES[self.scale_dtype]

    def kv_bytes_per_token(self, cfg: ModelConfig) -> int:
        """K + V payload bytes plus one scale per (token, kv-head) each."""
        payload = 2 * cfg.kv_dim * _PAYLOAD_BYTES[self.kv_dtype]
        scales = 2 * cfg.num_kv_heads * self.scale_bytes
        return payload + scales

    def act_bytes_per_token(self, cfg: ModelConfig) -> int:
        """ACT payload bytes plus one scale per token."""
        return cfg.d_model * _PAYLOAD_BYTES[self.act_dtype] + self.scale_bytes


def kv_bytes_per_token(cfg: ModelConfig, quant: "QuantConfig | None" = None
                       ) -> int:
    """Per-token KV bytes under ``quant`` (config dtype when None)."""
    if quant is None:
        return cfg.kv_bytes_per_token()
    return quant.kv_bytes_per_token(cfg)


def act_bytes_per_token(cfg: ModelConfig, quant: "QuantConfig | None" = None
                        ) -> int:
    """Per-token ACT bytes under ``quant`` (config dtype when None)."""
    if quant is None:
        return cfg.act_bytes_per_token()
    return quant.act_bytes_per_token(cfg)
