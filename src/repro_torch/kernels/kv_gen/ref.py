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

``kv_gen_split_ref`` is the card's algorithm (csrc/kv_gen.cu) in plain
PyTorch: the rows normed once, d_model cut into slices of 64-column chunks as
the blocks of a cluster take them, each slice's float32 partial of the
projection summed in slice order, then the same epilogue.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.quant_ops import dequantize

PAGE = 16
CHUNK = 64          # d_model columns per ring stage of the card's kernel


def _normed(act_pages, norm_scale, norm_bias, dtype, page_index, act_scales,
            norm_type, eps):
    """The selected ACT rows, dequantized (int8 mode), normed and rounded to
    the cache dtype: (N, 16, d)."""
    a = act_pages if page_index is None else act_pages[page_index.long()]
    if act_scales is not None:
        s = act_scales if page_index is None else act_scales[page_index.long()]
        a = dequantize(a, s, dtype)
    if norm_type == "rmsnorm":
        a = L.rms_norm(a, norm_scale, eps)
    elif norm_type == "layernorm":
        a = L.layer_norm(a, norm_scale, norm_bias, eps)
    elif norm_type != "none":
        raise ValueError(f"kv_gen: norm_type {norm_type!r}")
    return a


def _epilogue(k, v, dt, knorm, sin, cos):
    """The float32 projections rounded to ``dt``, K normed and rotated."""
    k, v = k.to(dt), v.to(dt)
    if knorm is not None:
        k = L.rms_norm(k, knorm)
    if sin is not None:
        k = L.apply_rope(k, sin, cos)
    return k, v


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
    a = _normed(act_pages, norm_scale, norm_bias, wk.dtype, page_index,
                act_scales, norm_type, eps)
    dt, x = a.dtype, a.float()
    k = torch.einsum("ntd,dhe->nthe", x, wk.float())
    v = torch.einsum("ntd,dhe->nthe", x, wv.float())
    return _epilogue(k, v, dt, knorm, sin, cos)


def d_slices(d_model: int, n_slices: int) -> list:
    """The column ranges of d_model that the ``n_slices`` blocks of a
    cluster take: d_model in chunks of 64 (the last may be short), block r
    the chunks [r nc / n_slices, (r + 1) nc / n_slices)."""
    nc = -(-d_model // CHUNK)
    return [(r * nc // n_slices * CHUNK,
             min((r + 1) * nc // n_slices * CHUNK, d_model))
            for r in range(n_slices)]


def kv_gen_split_ref(act_pages, norm_scale, norm_bias, wk, wv, *,
                     page_index=None, sin=None, cos=None, act_scales=None,
                     knorm=None, norm_type: str = "rmsnorm", eps: float = 1e-6,
                     n_slices: int = 8):
    """``kv_gen_ref``'s function by the card's algorithm: the rows normed
    and rounded once, each of ``n_slices`` d_model ranges (``d_slices``)
    projected apart into a float32 partial, the partials summed in range
    order, then the unchanged epilogue."""
    a = _normed(act_pages, norm_scale, norm_bias, wk.dtype, page_index,
                act_scales, norm_type, eps)
    dt, x = a.dtype, a.float()
    k = v = 0.0
    for lo, hi in d_slices(x.shape[-1], n_slices):
        k = k + torch.einsum("ntd,dhe->nthe", x[..., lo:hi], wk[lo:hi].float())
        v = v + torch.einsum("ntd,dhe->nthe", x[..., lo:hi], wv[lo:hi].float())
    return _epilogue(k, v, dt, knorm, sin, cos)
