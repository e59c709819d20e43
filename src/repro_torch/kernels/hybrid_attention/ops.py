"""Wrappers of the hand-written CUDA hybrid paged-attention kernel (decode).

A CUDA tensor launches ``csrc/hybrid_attention.cu`` on PyTorch's current
stream, or raises; a CPU tensor takes the plain version in ``ref.py``.
``hybrid_paged_attention`` is the fused mode (ACT pages normed and projected
in the kernel, the learned-position models' path);
``hybrid_paged_attention_two_pool`` is the second-pool mode (type-1 entries
read K/V that ``kv_gen`` recomputed into a second pair of pools, the RoPE
models' path).  Each counts its launches in ``.launches``, and those made with
``return_lse=True`` (the CPU attention lane's device partial, which also
returns the softmax statistics ``(m, l)``) again in ``.lse_launches``.

Layout (as ``repro.kernels.hybrid_attention.kernel``):
  q            (B, KVH, G, D)     one query token per request
  k/v_pages    (P_kv, 16, KVH, D) KV page pools
  act_pages    (P_act, 16, d)     ACT page pool (layer-input checkpoints)
  norm_scale/norm_bias (d,)       the layer's ln1 (bias None for rmsnorm)
  wk, wv       (d, KVH, D)        the layer's K/V projections
  page_table, page_type, page_ntok  int32 (B, MAXP); type 0 KV, 1 ACT, 2 empty
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hybrid_attention.ref import (
    PAGE, hybrid_paged_attention_ref, hybrid_paged_attention_two_pool_ref)

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
NORM_TYPES = {"layernorm": 0, "rmsnorm": 1}
MAX_D, MAX_G = 128, 8
_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_TWO_POOL_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p]


def _lse_out(q, return_lse: bool):
    """The (m, l) outputs of the ``return_lse`` mode, float32 (B, KVH, G, 1),
    and their pointers (NULL without the mode)."""
    if not return_lse:
        return (), (None, None)
    m, l = (torch.empty(q.shape[:-1] + (1,), dtype=torch.float32,
                        device=q.device) for _ in range(2))
    return (m, l), (m.data_ptr(), l.data_ptr())


def _launch(lib, q, k_pages, v_pages, act_pages, norm_scale, norm_bias, wk,
            wv, page_table, page_type, page_ntok, out, lse_ptrs,
            norm_type: str, eps: float, stream) -> None:
    fn = lib.hybrid_paged_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    B, KVH, G, D = q.shape
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             act_pages.data_ptr(), norm_scale.data_ptr(),
             None if norm_bias is None else norm_bias.data_ptr(),
             wk.data_ptr(), wv.data_ptr(), page_table.data_ptr(),
             page_type.data_ptr(), page_ntok.data_ptr(), out.data_ptr(),
             *lse_ptrs, B, KVH, G, D, act_pages.shape[-1], page_table.shape[1],
             NORM_TYPES[norm_type], eps, DTYPES[q.dtype], stream)
    _build.check(lib, err, "hybrid_paged_attention_fwd")


def _validate_fused(q, k_pages, v_pages, act_pages, norm_scale, norm_bias, wk,
                    wv, page_table, page_type, page_ntok, norm_type):
    _, KVH, _, D = q.shape
    d = act_pages.shape[-1]
    shapes = {"act_pages": (act_pages, (act_pages.shape[0], PAGE, d)),
              "norm_scale": (norm_scale, (d,)),
              "wk": (wk, (d, KVH, D)), "wv": (wv, (d, KVH, D))}
    if norm_type not in NORM_TYPES:
        raise ValueError(f"hybrid_paged_attention: norm_type {norm_type!r}")
    if norm_type == "layernorm":
        if norm_bias is None:
            raise ValueError("hybrid_paged_attention: layernorm needs norm_bias")
        shapes["norm_bias"] = (norm_bias, (d,))
    _validate(q, {"k_pages": k_pages, "v_pages": v_pages}, shapes, page_table,
              page_type, page_ntok)


def _validate(q, kv_pools, shapes, page_table, page_type, page_ntok):
    """Shapes, dtypes and devices of every argument; ``kv_pools`` name the
    (P, 16, KVH, D) pools, ``shapes`` maps the rest to their shapes."""
    B, KVH, G, D = q.shape
    shapes = {**{name: (t, (t.shape[0], PAGE, KVH, D))
                 for name, t in kv_pools.items()}, **shapes}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"hybrid_paged_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"hybrid_paged_attention: {name} must be a "
                             f"contiguous {q.dtype} tensor on {q.device}")
    for t in (page_table, page_type, page_ntok):
        if t.dim() != 2 or t.shape[0] != B or t.shape != page_table.shape \
                or t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError("hybrid_paged_attention: page tables must be "
                             f"contiguous int32 (B, MAXP) on {q.device}")
    if q.dtype not in DTYPES or not q.is_contiguous():
        raise ValueError(f"hybrid_paged_attention: q dtype {q.dtype}")
    if D > MAX_D or G > MAX_G:
        raise ValueError(f"hybrid_paged_attention: D={D} (max {MAX_D}), "
                         f"G={G} (max {MAX_G})")


def hybrid_paged_attention(q, k_pages, v_pages, act_pages, norm_scale,
                           norm_bias, wk, wv, page_table, page_type,
                           page_ntok, *, norm_type: str = "layernorm",
                           eps: float = 1e-5, return_lse: bool = False):
    """-> (B, KVH, G, D) decode attention over the hybrid paged cache, with
    each ACT page's K/V recomputed inside the kernel (Eq. 7 fused); with
    ``return_lse`` -> (out, m, l).  The kernel walks every entry of each
    table row, so a caller that knows a bound on the pages in use passes
    tables that wide (the TPU kernel's ``pages_bound``)."""
    if q.device.type == "cpu":
        return hybrid_paged_attention_ref(
            q, k_pages, v_pages, act_pages, norm_scale, norm_bias, wk, wv,
            page_table, page_type, page_ntok, norm_type=norm_type, eps=eps,
            return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"hybrid_paged_attention: unsupported device {q.device}")
    _validate_fused(q, k_pages, v_pages, act_pages, norm_scale, norm_bias, wk,
                    wv, page_table, page_type, page_ntok, norm_type)
    out = torch.empty_like(q)
    lse, lse_ptrs = _lse_out(q, return_lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(_build.load("hybrid_attention"), q, k_pages, v_pages,
                act_pages, norm_scale, norm_bias, wk, wv, page_table,
                page_type, page_ntok, out, lse_ptrs, norm_type, eps, stream)
    hybrid_paged_attention.launches += 1
    hybrid_paged_attention.lse_launches += bool(return_lse)
    return (out, *lse) if return_lse else out


hybrid_paged_attention.launches = 0
hybrid_paged_attention.lse_launches = 0


def hybrid_paged_attention_two_pool(q, k_pages, v_pages, act_k_pages,
                                    act_v_pages, page_table, page_type,
                                    page_ntok, *, return_lse: bool = False):
    """-> (B, KVH, G, D) decode attention over the hybrid paged cache in the
    second-pool mode: type-0 entries index ``k_pages``/``v_pages``, type-1
    entries ``act_k_pages``/``act_v_pages`` (P_act, 16, KVH, D), which hold
    K/V that ``kv_gen`` recomputed from the ACT pages this step.  Tables as
    for ``hybrid_paged_attention``, built with the second pools' stride.
    With ``return_lse`` -> (out, m, l)."""
    if q.device.type == "cpu":
        return hybrid_paged_attention_two_pool_ref(
            q, k_pages, v_pages, act_k_pages, act_v_pages, page_table,
            page_type, page_ntok, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"hybrid_paged_attention: unsupported device {q.device}")
    _validate(q, {"k_pages": k_pages, "v_pages": v_pages,
                  "act_k_pages": act_k_pages, "act_v_pages": act_v_pages}, {},
              page_table, page_type, page_ntok)
    B, KVH, G, D = q.shape
    out = torch.empty_like(q)
    lse, lse_ptrs = _lse_out(q, return_lse)
    lib = _build.load("hybrid_attention")
    fn = lib.hybrid_paged_attention_two_pool_fwd
    fn.argtypes, fn.restype = _TWO_POOL_ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 act_k_pages.data_ptr(), act_v_pages.data_ptr(),
                 page_table.data_ptr(), page_type.data_ptr(),
                 page_ntok.data_ptr(), out.data_ptr(), *lse_ptrs, B, KVH, G,
                 D, page_table.shape[1], DTYPES[q.dtype], stream)
    _build.check(lib, err, "hybrid_paged_attention_two_pool_fwd")
    hybrid_paged_attention_two_pool.launches += 1
    hybrid_paged_attention_two_pool.lse_launches += bool(return_lse)
    return (out, *lse) if return_lse else out


hybrid_paged_attention_two_pool.launches = 0
hybrid_paged_attention_two_pool.lse_launches = 0
