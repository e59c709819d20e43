"""Wrappers of the hand-written CUDA hybrid paged-attention kernels (decode).

A CUDA tensor launches ``csrc/hybrid_attention.cu`` on PyTorch's current
stream, or raises; a CPU tensor takes the plain version in ``ref.py``.
``hybrid_paged_attention`` is the fused mode (ACT pages normed and projected
in the kernel, the learned-position models' path);
``hybrid_paged_attention_two_pool`` is the second-pool mode (type-1 entries
read K/V that ``kv_gen`` recomputed into a second pair of pools, the RoPE
models' path), split across blocks: a split pass over ``split_plan``'s
ranges of each table row, then a combine pass (two CUDA kernels, one call).
Each wrapper counts its calls in ``.launches``, those made with
``return_lse=True`` (the CPU attention lane's device partial, which also
returns the softmax statistics ``(m, l)``) again in ``.lse_launches``,
those of the int8 mode (scale sidecars given) again in ``.q8_launches``, and
those of both again in ``.lse_q8_launches``; the second-pool mode's calls
at a head_dim over 128 (gemma3's 256) again in ``.hd256_launches``.

Layout (as ``repro.kernels.hybrid_attention.kernel``):
  q            (B, KVH, G, D)     one query token per request
  k/v_pages    (P_kv, 16, KVH, D) KV page pools
  act_pages    (P_act, 16, d)     ACT page pool (layer-input checkpoints)
  norm_scale/norm_bias (d,)       the layer's ln1 (bias None for rmsnorm)
  wk, wv       (d, KVH, D)        the layer's K/V projections
  page_table, page_type, page_ntok  int32 (B, MAXP); type 0 KV, 1 ACT, 2 empty
int8 mode (as the reference's ``k_scales``/``v_scales``/``act_scales``, all
or none): k/v_pages and act_pages hold int8 codes, and
  k/v_scales   (P_kv, 16, KVH, 1) float16, one per (token, head)
  act_scales   (P_act, 16, 1)     float16, one per token
The second-pool mode takes ``k_scales``/``v_scales`` only: its second pools
hold recomputed K/V in the cache dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hybrid_attention.ref import (
    PAGE, hybrid_paged_attention_ref, hybrid_paged_attention_two_pool_ref,
    split_plan)

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
NORM_TYPES = {"layernorm": 0, "rmsnorm": 1}
# head_dim up to 128 in the fused mode; in the second-pool mode a multiple
# of 16 (its 16-byte page loads) up to 256
MAX_D, MAX_D_TWO_POOL, MAX_G = 128, 256, 8
_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_TWO_POOL_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + \
    [ctypes.c_void_p]


def _scales(names, scales):
    """The int8 mode's scale sidecars: all of ``names`` given, or none."""
    given = [s is not None for s in scales]
    if any(given) and not all(given):
        raise ValueError(f"hybrid_paged_attention: pass all of {names} "
                         "(int8 mode) or none")
    return all(given)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _lse_out(q, return_lse: bool):
    """The (m, l) outputs of the ``return_lse`` mode, float32 (B, KVH, G, 1),
    and their pointers (NULL without the mode)."""
    if not return_lse:
        return (), (None, None)
    m, l = (torch.empty(q.shape[:-1] + (1,), dtype=torch.float32,
                        device=q.device) for _ in range(2))
    return (m, l), (m.data_ptr(), l.data_ptr())


def _launch(lib, q, k_pages, v_pages, act_pages, scales, norm_scale,
            norm_bias, wk, wv, page_table, page_type, page_ntok, out, lse_ptrs,
            norm_type: str, eps: float, stream) -> None:
    fn = lib.hybrid_paged_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    B, KVH, G, D = q.shape
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             act_pages.data_ptr(), *map(_ptr, scales), norm_scale.data_ptr(),
             _ptr(norm_bias),
             wk.data_ptr(), wv.data_ptr(), page_table.data_ptr(),
             page_type.data_ptr(), page_ntok.data_ptr(), out.data_ptr(),
             *lse_ptrs, B, KVH, G, D, act_pages.shape[-1], page_table.shape[1],
             NORM_TYPES[norm_type], eps, DTYPES[q.dtype], stream)
    _build.check(lib, err, "hybrid_paged_attention_fwd")


def _validate_fused(q, k_pages, v_pages, act_pages, scales, norm_scale,
                    norm_bias, wk, wv, page_table, page_type, page_ntok,
                    norm_type):
    _, KVH, _, D = q.shape
    d = act_pages.shape[-1]
    q8 = scales[0] is not None
    pay = torch.int8 if q8 else q.dtype
    shapes = {"act_pages": (act_pages, (act_pages.shape[0], PAGE, d), pay),
              "norm_scale": (norm_scale, (d,), q.dtype),
              "wk": (wk, (d, KVH, D), q.dtype), "wv": (wv, (d, KVH, D), q.dtype)}
    if q8:
        shapes["act_scales"] = (scales[2], (act_pages.shape[0], PAGE, 1),
                                torch.float16)
    if norm_type not in NORM_TYPES:
        raise ValueError(f"hybrid_paged_attention: norm_type {norm_type!r}")
    if norm_type == "layernorm":
        if norm_bias is None:
            raise ValueError("hybrid_paged_attention: layernorm needs norm_bias")
        shapes["norm_bias"] = (norm_bias, (d,), q.dtype)
    _validate(q, {"k_pages": k_pages, "v_pages": v_pages}, scales[:2], shapes,
              page_table, page_type, page_ntok)


def _validate(q, kv_pools, kv_scales, shapes, page_table, page_type,
              page_ntok):
    """Shapes, dtypes and devices of every argument; ``kv_pools`` name the
    (P, 16, KVH, D) pools of type-0 pages (int8 with ``kv_scales`` (P, 16,
    KVH, 1) in the int8 mode), ``shapes`` maps the rest to their shapes and
    dtypes."""
    B, KVH, G, D = q.shape
    q8 = kv_scales[0] is not None
    shapes = {**{name: (t, (t.shape[0], PAGE, KVH, D),
                        torch.int8 if q8 else q.dtype)
                 for name, t in kv_pools.items()}, **shapes}
    if q8:
        for name, s in zip(("k_scales", "v_scales"), kv_scales):
            shapes[name] = (s, (kv_pools["k_pages"].shape[0], PAGE, KVH, 1),
                            torch.float16)
    for name, (t, want, dt) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"hybrid_paged_attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"hybrid_paged_attention: {name} must be a "
                             f"contiguous {dt} tensor on {q.device}")
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
                           page_ntok, *, k_scales=None, v_scales=None,
                           act_scales=None, norm_type: str = "layernorm",
                           eps: float = 1e-5, return_lse: bool = False):
    """-> (B, KVH, G, D) decode attention over the hybrid paged cache, with
    each ACT page's K/V recomputed inside the kernel (Eq. 7 fused); with
    ``return_lse`` -> (out, m, l).  The kernel walks every entry of each
    table row, so a caller that knows a bound on the pages in use passes
    tables that wide (the TPU kernel's ``pages_bound``).  The three scale
    sidecars select the int8 mode."""
    scales = (k_scales, v_scales, act_scales)
    q8 = _scales(("k_scales", "v_scales", "act_scales"), scales)
    if q.device.type == "cpu":
        return hybrid_paged_attention_ref(
            q, k_pages, v_pages, act_pages, norm_scale, norm_bias, wk, wv,
            page_table, page_type, page_ntok, k_scales=k_scales,
            v_scales=v_scales, act_scales=act_scales, norm_type=norm_type,
            eps=eps, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"hybrid_paged_attention: unsupported device {q.device}")
    _validate_fused(q, k_pages, v_pages, act_pages, scales, norm_scale,
                    norm_bias, wk, wv, page_table, page_type, page_ntok,
                    norm_type)
    out = torch.empty_like(q)
    lse, lse_ptrs = _lse_out(q, return_lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(_build.load("hybrid_attention"), q, k_pages, v_pages,
                act_pages, scales, norm_scale, norm_bias, wk, wv, page_table,
                page_type, page_ntok, out, lse_ptrs, norm_type, eps, stream)
    hybrid_paged_attention.launches += 1
    hybrid_paged_attention.lse_launches += bool(return_lse)
    hybrid_paged_attention.q8_launches += q8
    hybrid_paged_attention.lse_q8_launches += q8 and return_lse
    return (out, *lse) if return_lse else out


hybrid_paged_attention.launches = 0
hybrid_paged_attention.lse_launches = 0
hybrid_paged_attention.q8_launches = 0
hybrid_paged_attention.lse_q8_launches = 0


def _check_two_pool(q, k_pages, v_pages, act_k_pages, act_v_pages, scales,
                    tables):
    """What the second-pool kernels take: every tensor contiguous on q's
    device, pools (P, 16, KVH, D) (the KV pools int8 with (P, 16, KVH, 1)
    float16 scales in the int8 mode), int32 (B, MAXP) tables.  Kept lean:
    it runs on every decode step of every layer."""
    B, KVH, G, D = q.shape
    if q.dtype not in DTYPES or not q.is_contiguous():
        raise ValueError(f"hybrid_paged_attention_two_pool: q must be a "
                         f"contiguous float16/bfloat16 tensor, got {q.dtype}")
    if D > MAX_D_TWO_POOL or D % 16 or not 1 <= G <= MAX_G:
        raise ValueError(f"hybrid_paged_attention_two_pool: D={D} (a multiple "
                         f"of 16 up to {MAX_D_TWO_POOL}), G={G} (max {MAX_G})")
    row, dev = (PAGE, KVH, D), q.device
    kv_dt = q.dtype if scales[0] is None else torch.int8
    named = [("k_pages", k_pages, kv_dt, (k_pages.shape[0],) + row),
             ("v_pages", v_pages, kv_dt, (k_pages.shape[0],) + row),
             ("act_k_pages", act_k_pages, q.dtype, (act_k_pages.shape[0],) + row),
             ("act_v_pages", act_v_pages, q.dtype, (act_k_pages.shape[0],) + row)]
    if scales[0] is not None:
        sc = (k_pages.shape[0], PAGE, KVH, 1)
        named += [("k_scales", scales[0], torch.float16, sc),
                  ("v_scales", scales[1], torch.float16, sc)]
    for name, t, dt, shape in named:
        if t.shape != shape or t.dtype != dt or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"hybrid_paged_attention_two_pool: {name} must be "
                             f"a contiguous {dt} tensor of shape {shape} on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} {t.device}")
    maxp = tables[0].shape[-1]
    for t in tables:
        if t.shape != (B, maxp) or t.dtype != torch.int32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError("hybrid_paged_attention_two_pool: page tables must "
                             f"be contiguous int32 (B, MAXP) on {dev}")


def hybrid_paged_attention_two_pool(q, k_pages, v_pages, act_k_pages,
                                    act_v_pages, page_table, page_type,
                                    page_ntok, *, k_scales=None, v_scales=None,
                                    return_lse: bool = False):
    """-> (B, KVH, G, D) decode attention over the hybrid paged cache in the
    second-pool mode: type-0 entries index ``k_pages``/``v_pages``, type-1
    entries ``act_k_pages``/``act_v_pages`` (P_act, 16, KVH, D), which hold
    K/V that ``kv_gen`` recomputed from the ACT pages this step.  Tables as
    for ``hybrid_paged_attention``, built with the second pools' stride.
    With ``return_lse`` -> (out, m, l).  ``k_scales``/``v_scales`` select
    the int8 mode of the KV pools.  On the card each table row is split by
    ``split_plan`` and the partials merged by a second kernel; float32
    scratch of B * KVH * n_split * G * (D + 2) values holds them."""
    q8 = _scales(("k_scales", "v_scales"), (k_scales, v_scales))
    if q.device.type == "cpu":
        return hybrid_paged_attention_two_pool_ref(
            q, k_pages, v_pages, act_k_pages, act_v_pages, page_table,
            page_type, page_ntok, k_scales=k_scales, v_scales=v_scales,
            return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"hybrid_paged_attention: unsupported device {q.device}")
    tables = (page_table, page_type, page_ntok)
    _check_two_pool(q, k_pages, v_pages, act_k_pages, act_v_pages,
                    (k_scales, v_scales), tables)
    B, KVH, G, D = q.shape
    maxp = page_table.shape[1]
    n_split, pps = split_plan(B, KVH, maxp)
    out = torch.empty_like(q)
    lse, lse_ptrs = _lse_out(q, return_lse)
    scratch = torch.empty(B * KVH * n_split * G * (D + 2), dtype=torch.float32,
                          device=q.device)
    lib, fn = _build.entry("hybrid_attention",
                           "hybrid_paged_attention_two_pool_fwd",
                           _TWO_POOL_ARGTYPES)
    dev = q.device.index
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 _ptr(k_scales), _ptr(v_scales),
                 act_k_pages.data_ptr(), act_v_pages.data_ptr(),
                 page_table.data_ptr(), page_type.data_ptr(),
                 page_ntok.data_ptr(), out.data_ptr(), *lse_ptrs,
                 scratch.data_ptr(), B, KVH, G, D, maxp, n_split, pps,
                 DTYPES[q.dtype], _build.current_stream(dev))
    _build.check(lib, err, "hybrid_paged_attention_two_pool_fwd")
    hybrid_paged_attention_two_pool.launches += 1
    hybrid_paged_attention_two_pool.lse_launches += bool(return_lse)
    hybrid_paged_attention_two_pool.q8_launches += q8
    hybrid_paged_attention_two_pool.lse_q8_launches += q8 and return_lse
    hybrid_paged_attention_two_pool.hd256_launches += D > MAX_D
    return (out, *lse) if return_lse else out


hybrid_paged_attention_two_pool.launches = 0
hybrid_paged_attention_two_pool.hd256_launches = 0
hybrid_paged_attention_two_pool.lse_launches = 0
hybrid_paged_attention_two_pool.q8_launches = 0
hybrid_paged_attention_two_pool.lse_q8_launches = 0
