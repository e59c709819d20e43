"""Torch quantization primitives of the int8 cache (counterpart of
``repro.models.quant_ops``).

``quantize`` is the reference's op sequence, so codes and scales are equal
bit for bit: the absmax in float32, the scale floored at ``SCALE_FLOOR`` and
cast to float16 BEFORE the codes are computed against it, round half to
even, clip to +-127.  ``dequantize`` widens ``code * scale`` in float32 and
rounds it to the cache dtype: the value ``fake_quant`` stands for, and the
one the kernels' int8 modes read on the tile.

The reference keeps fake-quantized values in a cache of the model dtype; the
port stores the codes and scales themselves (``quantize`` at every region
write), so the cache's device bytes are the quantized bytes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import SCALE_FLOOR, QuantConfig


def quantize(x, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (int8 codes (..., D), float16 scales (..., 1)) with one
    absmax scale per slice along ``dim``."""
    scale = absmax_scale(x, dim)
    return quantize_at(x, scale), scale


def absmax_scale(x, dim: int = -1) -> torch.Tensor:
    """The float16 scale (..., 1) of each slice of ``x`` along ``dim``: its
    float32 absmax over 127, floored at ``SCALE_FLOOR``.  Monotone in the
    absmax, so the max of the scales of a row's pieces is the row's scale,
    bit for bit (the sharded path's shared ACT scale)."""
    amax = x.float().abs().amax(dim, keepdim=True)
    return torch.clamp(amax / 127.0, min=SCALE_FLOOR).to(torch.float16)


def quantize_at(x, scale) -> torch.Tensor:
    """The int8 codes of ``x`` against the float16 ``scale`` (broadcast):
    round half to even, clipped to +-127."""
    q = torch.clamp(torch.round(x.float() / scale.float()), -127, 127)
    return q.to(torch.int8)


def dequantize(q, scale, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def fake_quant(x, dim: int = -1) -> torch.Tensor:
    """Quantize then dequantize in the dtype of ``x``: the values an int8
    cache read back yields."""
    q, s = quantize(x, dim)
    return dequantize(q, s, x.dtype)


def check_supported(quant: Optional[QuantConfig]) -> None:
    """The numeric paths store int8 codes with float16 scales; the other
    formats ``QuantConfig`` prices are layout-only."""
    if quant is not None and (quant.kv_dtype, quant.act_dtype,
                              quant.scale_dtype) != ("int8", "int8", "float16"):
        raise ValueError(f"{quant}: the cache stores int8 codes with float16 "
                         "scales only (other formats are priced, not served)")

