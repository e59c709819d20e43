"""Plain PyTorch version of the KV-Gen kernel (paper Eq. 7).

Counterpart of ``repro.kernels.kv_gen.ref`` with three corrections that make
it follow the model path (``_hybrid_layer_step``) rather than the Pallas
kernel: it rounds where the model path rounds (the normed ACT, then the
projected K/V, to the ACT pool's dtype), LayerNorm applies its bias, and an
optional RoPE epilogue rotates K in float32 with the passed per-row tables
and rounds it again, after an optional K norm (the q/k-norm models', which
the Pallas kernel lacks).  In float32 with a zero bias and no RoPE it computes
what the JAX reference computes.  With ``act_scales`` (the int8 cache's ACT
region) the selected pages' int8 codes are dequantized first and rounded to
the weights' dtype, the cache dtype, as the model path's fake quantization
rounds them.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.quant_ops import dequantize

PAGE = 16


def kv_gen_ref(act_pages, norm_scale, norm_bias, wk, wv, *, page_index=None,
               sin=None, cos=None, act_scales=None, knorm=None,
               norm_type: str = "rmsnorm", eps: float = 1e-6):
    """-> (k, v), each (N, 16, KVH, hd) in the ACT pool's dtype.

    act_pages (P, 16, d); page_index (N,) int selects and orders the pages
    (None: all P); wk/wv (d, KVH, hd); sin/cos (N, 16, hd/2) float32 rotate
    K (half-split layout); act_scales (P, 16, 1) float16 with int8
    act_pages; knorm (hd,) norms K after the projection and before RoPE,
    as the q/k-norm models' ``_qk`` does.  norm_type: rmsnorm (scale as
    ``1 + scale``), layernorm (scale and bias) or none."""
    a = act_pages if page_index is None else act_pages[page_index.long()]
    if act_scales is not None:
        s = act_scales if page_index is None else act_scales[page_index.long()]
        a = dequantize(a, s, wk.dtype)
    if norm_type == "rmsnorm":
        a = L.rms_norm(a, norm_scale, eps)
    elif norm_type == "layernorm":
        a = L.layer_norm(a, norm_scale, norm_bias, eps)
    elif norm_type != "none":
        raise ValueError(f"kv_gen: norm_type {norm_type!r}")
    dt, x = a.dtype, a.float()
    k = torch.einsum("ntd,dhe->nthe", x, wk.float()).to(dt)
    v = torch.einsum("ntd,dhe->nthe", x, wv.float()).to(dt)
    if knorm is not None:
        k = L.rms_norm(k, knorm)
    if sin is not None:
        k = L.apply_rope(k, sin, cos)
    return k, v
