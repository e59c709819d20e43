"""Wrappers of the hand-written CUDA hybrid paged-attention kernels (decode).

A CUDA tensor launches ``csrc/hybrid_attention.cu`` on PyTorch's current
stream, or raises; a CPU tensor takes the plain version in ``ref.py``.
``hybrid_paged_attention`` is the fused mode (ACT pages normed and projected
on the card, the learned-position models' path): a norm pass (each ACT row
normed once), a tile pass over ``tile_plan``'s tiles of four table entries
(the ACT rows projected by ``wk``/``wv`` on the tensor cores, then
attended), then a combine pass (three CUDA kernels, one call);
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
    PAGE, TILE_PAGES, hybrid_paged_attention_ref,
    hybrid_paged_attention_two_pool_ref, split_plan, tile_plan)

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
NORM_TYPES = {"layernorm": 0, "rmsnorm": 1}
# head_dim a multiple of 16 (16-byte page loads; wgmma's k-step in the fused
# mode) up to 128 in the fused mode and 256 in the second-pool mode
MAX_D, MAX_D_TWO_POOL, MAX_G = 128, 256, 8
# the fused mode streams d_model through its projection in TMA boxes of 64
# columns, and its combine pass merges at most 264 tiles a row
D_MODEL_STEP, MAX_TILES = 64, 264
_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + \
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


def fused_scratch_bytes(B: int, KVH: int, G: int, D: int, d: int,
                        n_tiles: int, esz: int) -> tuple[int, int]:
    """-> (bytes, offset of the normed rows) of the fused kernels' scratch:
    the tile partials, float32 (B, KVH, n_tiles, G, D + 2), then from a
    256-byte boundary the normed ACT rows (B, n_tiles * 4, 16, d) in the
    cache dtype (``esz`` bytes each), as the C side lays them out."""
    off = -(-B * KVH * n_tiles * G * (D + 2) * 4 // 256) * 256
    return off + B * n_tiles * TILE_PAGES * PAGE * d * esz, off


def _check_tensors(what: str, named, tables, B: int, dev) -> None:
    """Each (name, tensor, dtype, shape) of ``named`` contiguous on ``dev``
    with that dtype and shape, and the page tables contiguous int32
    (B, MAXP) on ``dev``; else a ValueError naming ``what``."""
    for name, t, dt, shape in named:
        if t.shape != shape or t.dtype != dt or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} tensor "
                             f"of shape {shape} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    maxp = tables[0].shape[-1]
    for t in tables:
        if t.shape != (B, maxp) or t.dtype != torch.int32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what}: page tables must be contiguous int32 "
                             f"(B, MAXP) on {dev}")


def _check_fused(q, k_pages, v_pages, act_pages, scales, norm_scale,
                 norm_bias, wk, wv, tables, norm_type):
    """What the fused kernels take: every tensor contiguous on q's device,
    KV pools (P, 16, KVH, D), the ACT pool (P, 16, d) (int8 with float16
    scales in the int8 mode), int32 (B, MAXP) tables; D a multiple of 16 up
    to 128, d a multiple of 64, at most 264 tiles a row.  A shape outside
    that is refused here, never sent down another path.  Kept lean: it runs
    on every decode step of every layer."""
    B, KVH, G, D = q.shape
    if q.dtype not in DTYPES or not q.is_contiguous():
        raise ValueError(f"hybrid_paged_attention: q must be a contiguous "
                         f"float16/bfloat16 tensor, got {q.dtype}")
    d, maxp = act_pages.shape[-1], tables[0].shape[-1]
    if D > MAX_D or D % 16 or not 1 <= G <= MAX_G or d % D_MODEL_STEP \
            or tile_plan(maxp)[0] > MAX_TILES:
        raise ValueError(f"hybrid_paged_attention: D={D} (a multiple of 16 "
                         f"up to {MAX_D}), G={G} (max {MAX_G}), d_model={d} "
                         f"(a multiple of {D_MODEL_STEP}), MAXP={maxp} (at "
                         f"most {MAX_TILES * TILE_PAGES}): the kernels refuse it")
    if norm_type not in NORM_TYPES:
        raise ValueError(f"hybrid_paged_attention: norm_type {norm_type!r}")
    if norm_type == "layernorm" and norm_bias is None:
        raise ValueError("hybrid_paged_attention: layernorm needs norm_bias")
    row, dev = (PAGE, KVH, D), q.device
    pay = q.dtype if scales[0] is None else torch.int8
    named = [("k_pages", k_pages, pay, (k_pages.shape[0],) + row),
             ("v_pages", v_pages, pay, (k_pages.shape[0],) + row),
             ("act_pages", act_pages, pay, (act_pages.shape[0], PAGE, d)),
             ("norm_scale", norm_scale, q.dtype, (d,)),
             ("wk", wk, q.dtype, (d, KVH, D)), ("wv", wv, q.dtype, (d, KVH, D))]
    if norm_type == "layernorm":
        named.append(("norm_bias", norm_bias, q.dtype, (d,)))
    if scales[0] is not None:
        sc = (k_pages.shape[0], PAGE, KVH, 1)
        named += [("k_scales", scales[0], torch.float16, sc),
                  ("v_scales", scales[1], torch.float16, sc),
                  ("act_scales", scales[2], torch.float16,
                   (act_pages.shape[0], PAGE, 1))]
    _check_tensors("hybrid_paged_attention", named, tables, B, dev)


def hybrid_paged_attention(q, k_pages, v_pages, act_pages, norm_scale,
                           norm_bias, wk, wv, page_table, page_type,
                           page_ntok, *, k_scales=None, v_scales=None,
                           act_scales=None, norm_type: str = "layernorm",
                           eps: float = 1e-5, return_lse: bool = False):
    """-> (B, KVH, G, D) decode attention over the hybrid paged cache, with
    each ACT page's K/V recomputed on the card (Eq. 7 fused); with
    ``return_lse`` -> (out, m, l).  The kernels cover every entry of each
    table row, so a caller that knows a bound on the pages in use passes
    tables that wide (the TPU kernel's ``pages_bound``).  The three scale
    sidecars select the int8 mode.  On the card the scratch holds the
    normed rows and the tiles' partials (``fused_scratch_bytes``)."""
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
    tables = (page_table, page_type, page_ntok)
    _check_fused(q, k_pages, v_pages, act_pages, scales, norm_scale,
                 norm_bias, wk, wv, tables, norm_type)
    B, KVH, G, D = q.shape
    d, maxp = act_pages.shape[-1], page_table.shape[1]
    n_tiles, _ = tile_plan(maxp)
    out = torch.empty_like(q)
    lse, lse_ptrs = _lse_out(q, return_lse)
    scratch = torch.empty(fused_scratch_bytes(B, KVH, G, D, d, n_tiles,
                                              q.element_size())[0],
                          dtype=torch.uint8, device=q.device)
    lib, fn = _build.entry("hybrid_attention", "hybrid_paged_attention_fwd",
                           _ARGTYPES)
    dev = q.device.index
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 act_pages.data_ptr(), *map(_ptr, scales),
                 norm_scale.data_ptr(), _ptr(norm_bias), wk.data_ptr(),
                 wv.data_ptr(), page_table.data_ptr(), page_type.data_ptr(),
                 page_ntok.data_ptr(), out.data_ptr(), *lse_ptrs,
                 scratch.data_ptr(), B, KVH, G, D, d, maxp, n_tiles,
                 NORM_TYPES[norm_type], eps, DTYPES[q.dtype],
                 _build.current_stream(dev))
    _build.check(lib, err, "hybrid_paged_attention_fwd")
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
    _check_tensors("hybrid_paged_attention_two_pool", named, tables, B, dev)


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
