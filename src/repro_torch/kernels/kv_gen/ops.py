"""Wrapper of the hand-written CUDA KV-Gen kernel (ACT pages -> K, V).

A CUDA tensor launches ``csrc/kv_gen.cu`` on PyTorch's current stream, or
raises; a CPU or ``meta`` tensor takes the plain version in ``ref.py``.
On the card one call runs two kernels: a norm pass (each selected ACT row
normed once, into a scratch of the cache dtype) and a projection pass on
the tensor cores, its d_model split across the blocks of a cluster
(``kv_gen_split_ref`` in ``ref.py`` is the same algorithm in plain
PyTorch).
``kv_gen.launches`` counts the kernel's launches, ``kv_gen.q8_launches``
again those of its int8 mode (``act_scales`` given: an int8 ACT pool with one
float16 scale per token, dequantized in the norm prologue), and
``kv_gen.knorm_launches`` those with the K norm epilogue (``knorm`` given).  The kernel takes
what the
RoPE models' decode path gives it: a page index, RoPE tables, and rmsnorm or
layernorm; the plain version also takes no index, no RoPE and no norm, the
cases the reference's Pallas kernel is compared in.

Layout (as ``repro.kernels.kv_gen.kernel``):
  act_pages    (P, 16, d)        ACT page pool (layer-input checkpoints)
  act_scales   (P, 16, 1) f16    int8 mode: the pool's per-token scales
  page_index   (N,) int32        pages to recompute, in output order
                                 (plain version: None for all)
  norm_scale/norm_bias (d,)      the layer's ln1 (bias only for layernorm)
  wk, wv       (d, KVH, hd)      the layer's K/V projections
  knorm        (hd,)             the q/k-norm models' K norm (None: none)
  sin, cos     (N, 16, hd/2) f32 per-row RoPE tables for K
                                 (plain version: None for no RoPE)
  -> k, v      (N, 16, KVH, hd)
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_gen.ref import PAGE, kv_gen_ref

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
NORM_TYPES = {"layernorm": 0, "rmsnorm": 1}
MAX_HD = 256
# planted faults of the card's kernels (``flags``; 0 on every model path)
FAULTS = {"drop_last_slice": 1}
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch(act_pages, act_scales, page_index, norm_scale, norm_bias, wk, wv,
            knorm, sin, cos, k, v, norm_type: str, eps: float,
            flags: int) -> None:
    """The card's two kernels on the current stream, the normed rows in a
    scratch of (N * 16, d_model) values of the cache dtype."""
    n, d = k.shape[0], act_pages.shape[-1]
    _, KVH, hd = wk.shape
    scratch = torch.empty((n * PAGE, d), dtype=wk.dtype, device=wk.device)
    lib, fn = _build.entry("kv_gen", "kv_gen_fwd", _ARGTYPES)
    idx = act_pages.device.index
    with _build.on_device(idx):
        err = fn(act_pages.data_ptr(),
                 None if act_scales is None else act_scales.data_ptr(),
                 page_index.data_ptr(), norm_scale.data_ptr(),
                 None if norm_bias is None else norm_bias.data_ptr(),
                 wk.data_ptr(), wv.data_ptr(),
                 None if knorm is None else knorm.data_ptr(), sin.data_ptr(),
                 cos.data_ptr(), k.data_ptr(), v.data_ptr(), scratch.data_ptr(),
                 n, d, KVH, hd, NORM_TYPES[norm_type], eps, DTYPES[wk.dtype],
                 flags, _build.current_stream(idx))
    _build.check(lib, err, "kv_gen_fwd")


def _validate(act_pages, page_index, norm_scale, norm_bias, wk, wv, sin, cos,
              out, norm_type, n, act_scales=None, knorm=None):
    dt, dev = wk.dtype, act_pages.device
    if dt not in DTYPES:
        raise ValueError(f"kv_gen: dtype {dt} (the kernel takes "
                         f"{sorted(map(str, DTYPES))})")
    d = act_pages.shape[-1]
    _, KVH, hd = wk.shape
    if act_pages.dim() != 3 or act_pages.shape[1] != PAGE or d % 8:
        raise ValueError(f"kv_gen: act_pages {tuple(act_pages.shape)} is not "
                         f"(P, {PAGE}, d) with d a multiple of 8")
    if hd % 32 or hd > MAX_HD:
        raise ValueError(f"kv_gen: head_dim {hd} not a multiple of 32 up to "
                         f"{MAX_HD}")
    if norm_type not in NORM_TYPES:
        raise ValueError(f"kv_gen: norm_type {norm_type!r} (the kernel takes "
                         f"{sorted(NORM_TYPES)})")
    if page_index is None or sin is None or cos is None:
        raise ValueError("kv_gen: the kernel needs page_index, sin and cos")
    shapes = {"act_pages": (act_pages, tuple(act_pages.shape),
                            dt if act_scales is None else torch.int8),
              "wk": (wk, (d, KVH, hd), dt), "wv": (wv, (d, KVH, hd), dt),
              "k out": (out[0], (n, PAGE, KVH, hd), dt),
              "v out": (out[1], (n, PAGE, KVH, hd), dt),
              "norm_scale": (norm_scale, (d,), dt),
              "page_index": (page_index, (n,), torch.int32),
              "sin": (sin, (n, PAGE, hd // 2), torch.float32),
              "cos": (cos, (n, PAGE, hd // 2), torch.float32)}
    if act_scales is not None:
        shapes["act_scales"] = (act_scales, (act_pages.shape[0], PAGE, 1),
                                torch.float16)
    if knorm is not None:
        shapes["knorm"] = (knorm, (hd,), dt)
    if norm_type == "layernorm":
        if norm_bias is None:
            raise ValueError("kv_gen: layernorm needs norm_bias")
        shapes["norm_bias"] = (norm_bias, (d,), dt)
    for name, (t, want, want_dt) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"kv_gen: {name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
        if t.dtype != want_dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"kv_gen: {name} must be a contiguous {want_dt} "
                             f"tensor on {dev}")
    for t in (act_pages, wk, wv, norm_scale, norm_bias):
        if t is not None and t.data_ptr() % 16:     # the kernel's 16-byte loads
            raise ValueError("kv_gen: act_pages, weights and norm parameters "
                             "must be 16-byte aligned")


def kv_gen(act_pages, norm_scale, norm_bias, wk, wv, *, page_index=None,
           sin=None, cos=None, act_scales=None, knorm=None,
           norm_type: str = "rmsnorm", eps: float = 1e-6, out=None):
    """-> (k, v) (N, 16, KVH, hd) in the weights' dtype: each selected ACT
    page (int8 codes times ``act_scales``, rounded, in the int8 mode) normed,
    rounded, projected by ``wk``/``wv``, rounded, K normed by ``knorm``
    (rmsnorm over each head's hd columns, rounded) when given, and K rotated
    by the RoPE tables (paper Eq. 7 as one GEMM).  ``out`` = (k, v) preallocated buffers
    to write into (the decode step's scratch pool).  Page indices are not
    range-checked on the card (that would sync with the host)."""
    return _kv_gen(act_pages, norm_scale, norm_bias, wk, wv,
                   page_index=page_index, sin=sin, cos=cos,
                   act_scales=act_scales, knorm=knorm, norm_type=norm_type,
                   eps=eps, out=out)


def _kv_gen(act_pages, norm_scale, norm_bias, wk, wv, *, page_index=None,
            sin=None, cos=None, act_scales=None, knorm=None,
            norm_type: str = "rmsnorm", eps: float = 1e-6, out=None,
            flags: int = 0):
    """``kv_gen`` with ``flags``, the card's planted faults (``FAULTS``;
    chip_smoke.py holds the kernels' limits against them)."""
    n = act_pages.shape[0] if page_index is None else page_index.shape[0]
    if _build.plain(act_pages):
        k, v = kv_gen_ref(act_pages, norm_scale, norm_bias, wk, wv,
                          page_index=page_index, sin=sin, cos=cos,
                          act_scales=act_scales, knorm=knorm,
                          norm_type=norm_type, eps=eps)
        if out is None:
            return k, v
        out[0].copy_(k)
        out[1].copy_(v)
        return out
    if act_pages.device.type != "cuda":
        raise ValueError(f"kv_gen: unsupported device {act_pages.device}")
    if out is None:
        shape = (n, PAGE) + tuple(wk.shape[1:])
        out = tuple(torch.empty(shape, dtype=wk.dtype,
                                device=act_pages.device) for _ in range(2))
    _validate(act_pages, page_index, norm_scale, norm_bias, wk, wv, sin, cos,
              out, norm_type, n, act_scales, knorm)
    if n == 0:
        return out
    _launch(act_pages, act_scales, page_index, norm_scale,
            norm_bias if norm_type == "layernorm" else None, wk, wv, knorm, sin,
            cos, out[0], out[1], norm_type, eps, flags)
    kv_gen.launches += 1
    kv_gen.q8_launches += act_scales is not None
    kv_gen.knorm_launches += knorm is not None
    return out


kv_gen.launches = 0
kv_gen.q8_launches = 0
kv_gen.knorm_launches = 0
