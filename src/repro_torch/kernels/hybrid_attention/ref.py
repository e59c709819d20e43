"""Plain PyTorch version of the hybrid paged-attention kernel.

Counterpart of ``repro.kernels.hybrid_attention.ref`` with the two
corrections the port's kernel makes to follow the model path: LayerNorm
applies its bias, and the normed ACT and the recomputed K/V are rounded to
the cache dtype (the ACT pool's) where ``_hybrid_layer_step`` rounds them.
In float32 with a zero bias it computes what the JAX reference computes.

``hybrid_paged_attention_two_pool_ref`` is the plain version of the second-pool
mode: type-1 entries index a second pair of K/V pools that already hold the
recomputed K/V (the RoPE models' path, KV-Gen run beforehand).

int8 mode (both): given scale sidecars, the gathered int8 pages are
dequantized densely before anything else, as the reference's ``ref.py``
dequantizes its pools, but each value is rounded to the cache dtype (q's), as the model path's fake quantization
rounds it; the second-pool mode's second pools stay in the cache dtype.

``return_lse=True`` (both modes) also returns the partial-softmax statistics
``(m, l)``, each (B, KVH, G, 1) float32 in the ``1/sqrt(D)``-scaled score
basis: m the masked score max (NEG_INF when the request attends over no
token), l the sum of exp(s - m) — what a disjoint partition's partial needs
to merge with this one (the CPU attention lane, and on the fused route the
int8 cache's ACT-bound token): ``merge_partials_torch``.

``split_plan`` is how the second-pool kernels cut each table row across
blocks, and ``hybrid_paged_attention_two_pool_split_ref`` their algorithm in
plain PyTorch (each range attended on its own, the partials merged), which
the tests hold to ``hybrid_paged_attention_two_pool_ref``.  Likewise
``tile_plan`` is how the fused mode's kernels cut each row into tiles of
``TILE_PAGES`` entries, and ``hybrid_paged_attention_tiled_ref`` their
algorithm: every ACT row normed once and rounded, each tile's ACT rows
projected as one block and rounded, each tile attended with its own (m, l),
the tiles merged.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.quant_ops import dequantize

PAGE = 16
#: the second-pool split pass aims at about two blocks per SM of the H100;
#: a split holds at most MAX_PAGES_PER_SPLIT entries (the kernel reads its
#: range of the table into shared memory)
SPLIT_TARGET = 264
MAX_PAGES_PER_SPLIT = 128
#: the fused mode's tile: four table entries, 64 rows, one wgmma M of 64
TILE_PAGES = 4
#: masked-score basis shared with the kernel (finite, so an empty partition
#: merges without nan: exp(NEG_INF - NEG_INF) = 1, l = 0)
NEG_INF = -1e30


def merge_partials_torch(o_a, m_a, l_a, o_b, m_b, l_b):
    """Fold two flash-attention partials into one (associative, exact).

    ``o_*`` are NORMALISED partition outputs (..., D); ``m_*``/``l_*`` are
    broadcastable against them with a trailing singleton (..., 1).  A
    partition with l = 0 (empty: m = NEG_INF) contributes weight 0 and
    drops out of the sum.  The executor merges the host lane's partial
    with the device's through it."""
    m_new = torch.maximum(m_a, m_b)
    w_a = l_a * torch.exp(m_a - m_new)
    w_b = l_b * torch.exp(m_b - m_new)
    tot = w_a + w_b
    o = (w_a * o_a + w_b * o_b) / tot.clamp_min(1e-30)
    return o, m_new, tot


def split_plan(B: int, KVH: int, maxp: int) -> tuple[int, int]:
    """The second-pool kernels' split of each table row, from host-known
    shapes alone (no tensor is read, so no sync): -> (n_split,
    pages_per_split).  Split s takes entries [s * pps, min((s + 1) * pps,
    maxp)); together the splits cover the row once, none is past its end,
    and n_split * B * KVH is about ``SPLIT_TARGET`` blocks where the table
    is wide enough, with at most ``MAX_PAGES_PER_SPLIT`` entries a split.
    A split whose entries hold no token writes an empty partial."""
    n = max(1, min(maxp, -(-SPLIT_TARGET // max(1, B * KVH))),
            -(-maxp // MAX_PAGES_PER_SPLIT))
    pps = max(1, -(-maxp // n))
    return max(1, -(-maxp // pps)), pps


def tile_plan(maxp: int) -> tuple[int, int]:
    """The fused mode's tiles of each table row, from the table's width
    alone (no tensor is read, so no sync): -> (n_tiles, pages_per_tile).
    Tile t takes entries [t * TILE_PAGES, min((t + 1) * TILE_PAGES, maxp));
    a row of no entry still gets one (empty) tile."""
    return max(1, -(-maxp // TILE_PAGES)), TILE_PAGES


def hybrid_paged_attention_ref(q, k_pages, v_pages, act_pages, norm_scale,
                               norm_bias, wk, wv, page_table, page_type,
                               page_ntok, *, k_scales=None, v_scales=None,
                               act_scales=None, norm_type: str = "layernorm",
                               eps: float = 1e-5, return_lse: bool = False):
    """-> (B, KVH, G, D) attention of q over the typed page table, and
    ``(m, l)`` with ``return_lse``.

    Every page is gathered densely; ACT pages are normed, rounded, projected
    by ``wk``/``wv`` (d_model, KVH, D) and rounded again (paper Eq. 7)."""
    if page_table.shape[1] == 0:        # nothing to attend: zeros, as the kernel
        return _empty(q, return_lse)
    dt = act_pages.dtype if act_scales is None else q.dtype   # the cache dtype
    pty = page_type.long()
    pt = page_table.long()
    kv_i, act_i = torch.where(pty == 0, pt, 0), torch.where(pty == 1, pt, 0)
    k_kv = _pages(k_pages, k_scales, kv_i, dt)                # (B,P,T,KVH,D)
    v_kv = _pages(v_pages, v_scales, kv_i, dt)
    a = _norm(_pages(act_pages, act_scales, act_i, dt), norm_scale, norm_bias,
              norm_type, eps, dt)                             # (B,P,T,d)
    k_act, v_act = (_project(a, w, dt) for w in (wk, wv))
    is_act = (pty == 1)[..., None, None, None]
    k = torch.where(is_act, k_act, k_kv)
    v = torch.where(is_act, v_act, v_kv)
    return _attend(q, k, v, page_type, page_ntok, return_lse)


def hybrid_paged_attention_two_pool_ref(q, k_pages, v_pages, act_k_pages,
                                        act_v_pages, page_table, page_type,
                                        page_ntok, *, k_scales=None,
                                        v_scales=None, return_lse: bool = False):
    """-> (B, KVH, G, D) attention of q over the typed page table, type-1
    entries read from ``act_k_pages``/``act_v_pages`` (P_act, 16, KVH, D);
    and ``(m, l)`` with ``return_lse``."""
    if page_table.shape[1] == 0:
        return _empty(q, return_lse)
    pty, pt = page_type.long(), page_table.long()
    is_act = (pty == 1)[..., None, None, None]
    kv_i, act_i = torch.where(pty == 0, pt, 0), torch.where(pty == 1, pt, 0)
    k = _pages(k_pages, k_scales, kv_i, q.dtype)
    v = _pages(v_pages, v_scales, kv_i, q.dtype)
    if act_k_pages.shape[0]:            # else no ACT pages at all (kv mode)
        k = torch.where(is_act, act_k_pages[act_i].float(), k)
        v = torch.where(is_act, act_v_pages[act_i].float(), v)
    return _attend(q, k, v, page_type, page_ntok, return_lse)


def hybrid_paged_attention_two_pool_split_ref(
        q, k_pages, v_pages, act_k_pages, act_v_pages, page_table, page_type,
        page_ntok, *, k_scales=None, v_scales=None, return_lse: bool = False,
        plan=None):
    """The second-pool kernels' algorithm in plain PyTorch, for the tests:
    each table row cut into ``plan`` (n_split, pps) ranges (default
    ``split_plan``'s), each range attended on its own with its (m, l), the
    partials folded in order with ``merge_partials_torch``.  Arguments and
    result as ``hybrid_paged_attention_two_pool_ref``."""
    B, KVH = q.shape[:2]
    maxp = page_table.shape[1]
    n_split, pps = split_plan(B, KVH, maxp) if plan is None else plan
    acc = None
    for s in range(n_split):
        cols = slice(s * pps, min((s + 1) * pps, maxp))
        o, m, l = hybrid_paged_attention_two_pool_ref(
            q, k_pages, v_pages, act_k_pages, act_v_pages, page_table[:, cols],
            page_type[:, cols], page_ntok[:, cols], k_scales=k_scales,
            v_scales=v_scales, return_lse=True)
        part = (o.float(), m, l)
        acc = part if acc is None else merge_partials_torch(*acc, *part)
    o, m, l = acc
    o = o.to(q.dtype)
    return (o, m, l) if return_lse else o


def hybrid_paged_attention_tiled_ref(
        q, k_pages, v_pages, act_pages, norm_scale, norm_bias, wk, wv,
        page_table, page_type, page_ntok, *, k_scales=None, v_scales=None,
        act_scales=None, norm_type: str = "layernorm", eps: float = 1e-5,
        return_lse: bool = False):
    """The fused mode's kernels in plain PyTorch, for the tests.  The norm
    pass: every ACT entry's rows normed once (not once per head) and
    rounded to the cache dtype, into a scratch of (B, n_tiles * pages, 16,
    d) rows, zeros elsewhere.  The tile pass: each of ``tile_plan``'s
    tiles projects its scratch rows by ``wk``/``wv`` as one block and
    rounds them, takes its KV
    entries from the pools, and attends with its own (m, l).  The combine
    pass: the partials folded in order with ``merge_partials_torch``.
    Arguments and result as ``hybrid_paged_attention_ref``."""
    B, maxp = page_table.shape
    n_tiles, ppt = tile_plan(maxp)
    dt = act_pages.dtype if act_scales is None else q.dtype
    pty, pt = page_type.long(), page_table.long()
    width = n_tiles * ppt
    pad = lambda x, v: torch.nn.functional.pad(x, (0, width - maxp), value=v)
    pty, pt, pn = pad(pty, 2), pad(pt, 0), pad(page_ntok.long(), 0)
    is_act = pty == 1
    act_i = torch.where(is_act, pt, 0)
    normed = _norm(_pages(act_pages, act_scales, act_i, dt), norm_scale,
                   norm_bias, norm_type, eps, dt)
    scratch = torch.where(is_act[..., None, None], normed, 0.0)
    kv_i = torch.where(pty == 0, pt, 0)
    acc = None
    for t in range(n_tiles):
        cols = slice(t * ppt, (t + 1) * ppt)
        a = scratch[:, cols]                                  # (B,ppt,T,d)
        k_act, v_act = (_project(a, w, dt) for w in (wk, wv))
        sel = is_act[:, cols, None, None, None]
        k = torch.where(sel, k_act, _pages(k_pages, k_scales, kv_i[:, cols], dt))
        v = torch.where(sel, v_act, _pages(v_pages, v_scales, kv_i[:, cols], dt))
        o, m, l = _attend(q, k, v, pty[:, cols], pn[:, cols], return_lse=True,
                          out_dtype=torch.float32)
        acc = (o, m, l) if acc is None else merge_partials_torch(*acc, o, m, l)
    o, m, l = acc
    o = o.to(q.dtype)
    return (o, m, l) if return_lse else o


def _norm(a, norm_scale, norm_bias, norm_type: str, eps: float, dtype):
    """ACT rows a (..., d) float32 normed in float32 (LayerNorm with its
    bias, or rmsnorm with 1 + scale), rounded to the cache ``dtype``."""
    if norm_type == "layernorm":
        mu = a.mean(-1, keepdim=True)
        var = (a - mu).square().mean(-1, keepdim=True)
        a = (a - mu) * torch.rsqrt(var + eps) * norm_scale.float() \
            + norm_bias.float()
    else:
        var = a.square().mean(-1, keepdim=True)
        a = a * torch.rsqrt(var + eps) * (1.0 + norm_scale.float())
    return a.to(dtype).float()


def _project(a, w, dtype):
    """Normed rows a (B, P, T, d) by a projection w (d, KVH, D), rounded to
    the cache ``dtype``: (B, P, T, KVH, D) float32."""
    return torch.einsum("bptd,dhe->bpthe", a, w.float()).to(dtype).float()


def _pages(pool, scales, idx, dtype):
    """Pages ``idx`` of a pool as float32; an int8 pool's codes times their
    scales, rounded to the cache ``dtype`` first."""
    if scales is None:
        return pool[idx].float()
    return dequantize(pool[idx], scales[idx], dtype).float()


def _empty(q, return_lse: bool):
    """A table with no entry: zeros, and the empty partition's statistics."""
    o = torch.zeros_like(q)
    if not return_lse:
        return o
    stat = q.new_zeros(q.shape[:-1] + (1,), dtype=torch.float32)
    return o, stat + NEG_INF, stat


def _attend(q, k, v, page_type, page_ntok, return_lse: bool = False,
            out_dtype=None):
    """Masked softmax attention of q (B, KVH, G, D) over gathered pages
    k/v (B, P, 16, KVH, D) float32; the output in ``out_dtype`` (default
    q's)."""
    B, KVH, G, D = q.shape
    P = k.shape[1]
    pty = page_type.long()
    k = k.reshape(B, P * PAGE, KVH, D)
    v = v.reshape(B, P * PAGE, KVH, D)
    tok = torch.arange(PAGE, device=q.device)
    valid = ((pty != 2)[..., None] & (tok < page_ntok[..., None])).reshape(B, -1)
    v = torch.where(valid[:, :, None, None], v, 0.0)
    s = torch.einsum("bhgd,bshd->bhgs", q.float() / math.sqrt(D), k)
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    e = torch.where(vm, torch.exp(s - m), 0.0)
    o = torch.einsum("bhgs,bshd->bhgd", e, v)
    l = e.sum(-1, keepdim=True)
    o = (o / l.clamp_min(1e-30)).to(out_dtype or q.dtype)
    return (o, m, l) if return_lse else o
