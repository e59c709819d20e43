"""Tensor-parallel hybrid prefill and decode of the uniform family over a
``ShardPlan``'s mesh: the counterpart of the reference's sharded jit
dispatches, where XLA splits ``hybrid_prefill_batched`` and
``hybrid_decode_loop`` under the plan's specs.

One controller drives every position, as in the reference.  Each data row of
the mesh runs its slice of the batch (all of it where the batch does not
divide the data axis, as ``cache_spec``'s ``fit`` decides); within a row,
each layer runs once per model position between the tensor-parallel seams
of the serve specs (``sharding.rules``):

  * ``embed`` is split over the vocabulary: each position looks up the
    tokens of its range (zero elsewhere) and the rows are summed, exactly;
    ``pos_embed`` is split over d_model and gathered before it is added,
  * ``wq``/``wk``/``wv``/``w1``/``w3`` are split by columns, ``wo``/``w2``
    by rows and their products summed over the row (``collectives``),
  * MoE layers (``rules``: experts split where E divides the model axis,
    else d_ff): every position routes every token of its row (the router is
    replicated) and runs its own experts' slots, or every expert at its
    d_ff slice; each token's gated sum over the pairs a position ran is
    summed over the row in float32 (``_moe_sum``),
  * the logits are per vocabulary slice, and the greedy token their
    combined argmax (the lowest index among equal maxima),
  * the cache follows ``plan.cache_spec``: K/V (and an int8 cache's K/V
    scales) split over KV heads, the ACT checkpoints over d_model with one
    scale per whole row replicated, lengths and ACT positions over data.

Each position's attention goes through the port's kernels at its own head
counts (``Layout.cfg_l``): ``flash_attention`` in prefill, and in decode the
fused ``hybrid_paged_attention`` (learned positions) or ``kv_gen`` then the
second-pool mode (RoPE), in their int8 modes for an int8 cache.  Some
seams need whole rows or whole heads:

  * KV-Gen reads whole ACT rows (the norm prologue and ``LN(act) @ wk``
    contract over d_model), so each layer's ACT slices are gathered before
    the position's kernel (``_act_gather``; counted as collective bytes);
    an int8 cache gathers the codes, whose scale every position holds,
  * an int8 ACT row is quantized against the whole row's absmax: each
    position takes its slice's scale, the scales' max is reduced over the
    row (``_act_scale_max``, two bytes a row), and each slice is quantized
    against it, so the codes and scales are the single-device run's bit for
    bit (the scale is monotone in the absmax),
  * where the KV heads do not divide the model axis (``kv_head_shards`` 1),
    the K/V cache is replicated and the ``wk``/``wv`` column slices, which
    the spec may cut inside a head, are gathered to whole heads before use:
    no position attends over part of a head.  Each position writes the new
    row of every KV head and attends with the queries of its heads over the
    one KV head they share (a contiguous copy of that head's pages where
    the cache holds more than one),
  * where the query heads do not split into whole KV groups or into one KV
    head per position, every position computes all heads (``wq``/``wo``
    gathered whole where the spec splits them) and no ``wo`` sum is taken.

With the CPU attention lane (``host``: the offload executor's) each
position's device partial runs the kernels' ``return_lse`` mode over its
new row and the ACT region, the lane attends over that position's heads of
its host arena, and the two merge before the position's ``wo`` partial.

Values every position of a row holds alike (the residual stream, the norms
of it, the lengths, the page tables) are computed once per distinct tensor
(``_each``): where positions share a device, the collectives hand them the
same tensor and the work is done once; on separate devices each position
computes its own.  Nothing here reads a device value on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.launch.mesh import Position
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import shardhints as SH
from repro_torch.models import transformer as T
from repro_torch.models.quant_ops import absmax_scale, quantize, quantize_at
from repro_torch.models.quant_ops import check_supported as check_quant
from repro_torch.kernels.hybrid_attention.ref import merge_partials_torch
from repro_torch.sharding import collectives as C
from repro_torch.sharding.plan import Sharded, ShardPlan, local

Cache = Dict[str, Sharded]


def _each(fn, *xs):
    """``fn`` over per-position arguments, once per distinct tuple of
    tensors: positions that share a tensor share its result."""
    memo, out = {}, []
    for args in zip(*xs):
        key = tuple(id(a) for a in args)
        if key not in memo:
            memo[key] = fn(*args)
        out.append(memo[key])
    return out


def check_plan_supported(cfg: ModelConfig, plan: ShardPlan,
                         quant=None) -> None:
    """Raise ``NotImplementedError`` for a model the engine does not serve
    (the same refusal as without a plan), ``ValueError`` for an int8
    format the cache does not store.  Every combination the single-device
    engine serves, a plan serves: the int8 cache, the CPU lane, MoE and
    every head layout."""
    T.check_supported(cfg, "engine")
    check_quant(quant)


def resolve_plan(cfg: ModelConfig, plan: Optional[ShardPlan], device,
                 hw=None, quant=None):
    """What a constructor given ``plan=`` serves on: -> (the plan, or None
    where there is none or its mesh has one position: the single-device
    path; the device, position 0's under a plan; ``hw`` priced per shard
    (``scale_for_shards``; None stays None); the shard factor)."""
    if plan is None:
        return None, torch.device(device), hw, 1
    device = plan.mesh.devices[0]
    if plan.mesh.size == 1:
        return None, device, hw, 1
    check_plan_supported(cfg, plan, quant)
    if hw is not None:
        hw = cm.scale_for_shards(hw, plan.shard_factor)
    return plan, device, hw, plan.shard_factor


# --- the seams (module-level, so a planted fault can replace one) -------------

def _attn_sum(parts, devices):
    """The attention output projection's row-parallel sum (``wo``)."""
    return C.sum_model(parts, devices, kind="wo")


def _ffn_sum(parts, devices):
    """The FFN's row-parallel sum (``w2``)."""
    return C.sum_model(parts, devices, kind="w2")


def _moe_sum(parts, devices):
    """Each token's float32 gated sums over the pairs each position ran
    (its experts, or every expert at its d_ff slice), summed over the row."""
    return C.sum_model(parts, devices, kind="moe")


def _act_gather(parts, devices):
    """A layer's ACT region slices (..., d/m) gathered to whole rows for
    KV-Gen (int8 codes in an int8 cache)."""
    return C.all_gather(parts, -1, devices, kind="act")


def _act_scale_max(parts, devices):
    """The float16 scales (..., 1) of each position's slice of the ACT rows
    reduced to the whole rows' (their max) on every position."""
    return C.max_model(parts, devices, kind="act_scale")


class Layout:
    """What a plan's positions hold of the uniform family's tensors and how
    each position attends, from the shapes and the model axis (the serve
    specs split a dim exactly where it divides).  ``quant``: the cache's
    ``QuantConfig`` (None: the config dtype)."""

    def __init__(self, plan: ShardPlan, quant=None):
        cfg = plan.cfg
        m = self.m = plan.model_shards
        self.plan, self.cfg, self.quant = plan, cfg, quant
        vp = T.pad_vocab(cfg.vocab_size)
        split = lambda n: m > 1 and n % m == 0
        self.vocab_split = split(vp)
        self.vocab_offsets = [c * vp // m if self.vocab_split else 0
                              for c in range(m)]
        self.d_split = split(cfg.d_model)
        self.act_split = plan.act_shards == m and m > 1
        self.kv_split = plan.kv_head_shards == m and m > 1
        H, KVH = cfg.num_heads, cfg.num_kv_heads
        G = H // KVH
        # a position's query heads are whole KV groups (KV heads split) or
        # lie within one KV head; otherwise every position runs all heads
        self.heads_split = split(H) and (self.kv_split or G % (H // m) == 0)
        hl = H // m if self.heads_split else H
        self.kvh_cache = KVH // m if self.kv_split else KVH
        kvh_att = self.kvh_cache if self.kv_split or not self.heads_split \
            else 1
        # the first cache head each position attends over
        self.kv0 = [c * hl // G if kvh_att < self.kvh_cache else 0
                    for c in range(m)]
        self.kv_slice = kvh_att < self.kvh_cache
        # wq/wo split by the spec, the heads computed whole: gathered
        self.q_gather = split(cfg.q_dim) and not self.heads_split
        # wk/wv columns split but not at head boundaries: gathered whole
        self.wkv_gather = split(cfg.kv_dim) and not self.kv_split
        #: the head counts a position attends with, and computes q/k/v with
        self.cfg_l = dataclasses.replace(cfg, num_heads=hl,
                                         num_kv_heads=kvh_att)
        self.cfg_w = dataclasses.replace(cfg, num_heads=hl,
                                         num_kv_heads=self.kvh_cache)
        self.moe = cfg.is_moe
        self.moe_ep = self.moe and split(cfg.moe_num_experts)
        self.ffn_split = split(cfg.d_ff) and not self.moe_ep
        self.expert0 = [c * cfg.moe_num_experts // m if self.moe_ep else 0
                        for c in range(m)]
        d = cfg.d_model
        self.dsl = [slice(c * d // m, (c + 1) * d // m) if self.act_split
                    else slice(None) for c in range(m)]


class Row(NamedTuple):
    """One data row: its positions (model order), their devices, and the
    batch rows it runs (host indices into the global batch)."""
    pos: List[Position]
    devs: List[torch.device]
    bidx: np.ndarray


def rows_for(plan: ShardPlan, B: int) -> List[Row]:
    """Each data row with the batch rows it runs: a contiguous slice where
    ``B`` divides the data axis, else all of them."""
    out = []
    split = plan.batch_split(B)
    b = B // plan.data_shards if split else B
    for r, pos in enumerate(plan.rows()):
        idx = np.arange(r * b, (r + 1) * b) if split else np.arange(B)
        out.append(Row(pos, [p.device for p in pos], idx))
    return out


def moe_groups(lay: Layout, b: int, B: Optional[int], S: int):
    """The MoE dispatch groups of a row's ``b`` x ``S`` tokens: its share of
    ``_moe_groups`` of the whole batch's ``B`` x ``S`` (``B`` None: the
    row's batch is the whole one), so that every row drops the pairs the
    single-device run drops (fault N).  None for a dense model."""
    if not lay.moe:
        return None
    if B is None or B == b:
        return L._moe_groups(b * S)
    G = L._moe_groups(B * S)
    if (G * b) % B:
        raise ValueError(f"a row of {b} of {B} requests holds no whole "
                         f"MoE groups ({G} over the batch)")
    return G * b // B


def _row_layers(lay: Layout, row: Row, lps: Sequence[dict]) -> List[dict]:
    """The row's per-position layer weights as the model functions take
    them: ``wk``/``wv`` gathered to whole heads where the spec cuts them,
    ``wq``/``wo`` gathered whole where every position runs all heads."""
    gathers = []
    if lay.wkv_gather:
        gathers += [("wk", -1), ("wv", -1)]
    if lay.q_gather:
        gathers += [("wq", -1), ("wo", 0)]
    if not gathers:
        return list(lps)
    out = [dict(lp, attn=dict(lp["attn"])) for lp in lps]
    for key, dim in gathers:
        full = C.all_gather([lp["attn"][key] for lp in lps], dim, row.devs,
                            kind="weights")
        for lp, w in zip(out, full):
            lp["attn"][key] = w
    return out


def _att_layers(lay: Layout, lps: Sequence[dict]) -> List[dict]:
    """Each position's layer weights as its attention kernels take them:
    ``wk``/``wv`` at the columns of the KV head it attends over (a
    contiguous copy, once per distinct head and weight), where the cache
    holds more KV heads than a position attends."""
    if not lay.kv_slice:
        return list(lps)
    d, D, KVH = lay.cfg.d_model, lay.cfg.head_dim, lay.kvh_cache
    memo, out = {}, []
    for lp, h in zip(lps, lay.kv0):
        attn = dict(lp["attn"])
        for key in ("wk", "wv"):
            w = lp["attn"][key]
            at = (id(w), h)
            if at not in memo:
                memo[at] = w.view(d, KVH, D)[:, h].contiguous()
            attn[key] = memo[at]
        out.append(dict(lp, attn=attn))
    return out


def _att_heads(lay: Layout, c: int, t):
    """Position ``c``'s attended KV heads of ``t`` (..., KVH_cache, D or 1):
    ``t`` itself, or a contiguous copy of its one head."""
    if t is None or not lay.kv_slice:
        return t
    return t[..., lay.kv0[c]:lay.kv0[c] + 1, :].contiguous()


def encode_act(lay: Layout, row: Row, parts: Sequence[torch.Tensor]) -> list:
    """The row's ACT rows as each position stores them (``parts[c]`` its
    slice, or the whole rows where the ACT is replicated): the rows
    themselves, or in an int8 cache (codes, float16 scales (..., 1))
    quantized against each whole row's scale."""
    if lay.quant is None:
        return list(parts)
    if not lay.act_split:
        return _each(quantize, parts)
    scales = _act_scale_max([absmax_scale(p) for p in parts], row.devs)
    return [(quantize_at(p, sc), sc) for p, sc in zip(parts, scales)]


# =============================================================================
# embedding and logits over vocabulary slices
# =============================================================================

def embed_rows(lay: Layout, row: Row, res: Sequence[dict], tokens, ctx=None):
    """The row's tokens (b, S) embedded on every position; learned
    positions ``ctx`` (b,) for one decode token, else 0..S-1."""
    devs = row.devs
    if lay.vocab_split:
        parts = []
        for c, (r, dev) in enumerate(zip(res, devs)):
            w = r["embed"]
            t = tokens.to(dev).long() - lay.vocab_offsets[c]
            inside = (t >= 0) & (t < w.shape[0])
            parts.append(torch.where(inside[..., None],
                                     w[t.clamp(0, w.shape[0] - 1)], 0))
        x = C.sum_model(parts, devs, kind="embed")
    else:
        x = _each(lambda r, t: r["embed"][t.long()], res,
                  [tokens.to(d) for d in devs])
    if lay.cfg.pos_type != "learned":
        return x
    S = tokens.shape[1]
    if ctx is None:
        rows = [r["pos_embed"][:S][None] for r in res]
    else:
        rows = [r["pos_embed"][ctx.to(d).long()][:, None]
                for r, d in zip(res, devs)]
    pe = C.all_gather(rows, -1, devs, kind="pos_embed") if lay.d_split \
        else rows
    return _each(lambda a, b: a + b, x, pe)


def logits_rows(lay: Layout, res: Sequence[dict], h) -> List[torch.Tensor]:
    """Each position's float32 logits over its vocabulary slice (the whole
    vocabulary where it is not split) of the normed ``h``."""
    cfg = lay.cfg
    w = [r["embed"].T if cfg.tie_embeddings else r["unembed"] for r in res]
    if lay.vocab_split:
        return [(x @ wc.to(x.dtype)).float() for x, wc in zip(h, w)]
    return _each(lambda x, wc: (x @ wc.to(x.dtype)).float(), h, w)


def argmax_rows(lay: Layout, row: Row, logits) -> List[torch.Tensor]:
    """Greedy tokens of the row's logits, on every position."""
    if lay.vocab_split:
        return C.vocab_argmax(logits, lay.vocab_offsets, row.devs)
    return _each(lambda lg: lg.argmax(-1).int(), logits)


def _final(lay: Layout, res, x):
    return _each(lambda r, h: L.apply_norm(h, r["final_norm"],
                                           lay.cfg.norm_type), res, x)


def _layer_mlp(lay: Layout, row: Row, lps, x, groups=None):
    """The FFN of one layer on every position, residual: ``w1``/``w3``
    column slices, ``w2`` row slices summed over the row; MoE as
    ``_moe_ffn`` (``groups``: its dispatch groups, ``moe_groups``)."""
    cfg = lay.cfg
    hn = _each(lambda lp, h: L.apply_norm(h, lp["ln2"], cfg.norm_type),
               lps, x)
    if lay.moe:
        f = _moe_ffn(lay, row, lps, hn, groups)
    elif lay.ffn_split:
        parts = [L.dense_ffn(lp["ffn"], h, cfg.ffn_type)
                 for lp, h in zip(lps, hn)]
        f = _ffn_sum(parts, row.devs)
    else:
        f = _each(lambda lp, h: L.dense_ffn(lp["ffn"], h, cfg.ffn_type),
                  lps, hn)
    return _each(lambda a, b: a + b, x, f)


def _moe_ffn(lay: Layout, row: Row, lps, hn, groups):
    """The MoE FFN of the row's normed ``hn`` (b, S, d) on every position:
    each position routes all the row's tokens (``L.moe_route``, the
    replicated router, ``groups`` dispatch groups) and runs its experts'
    slots (expert parallel) or every expert at its d_ff slice; the float32
    gated sums are summed over the row (``_moe_sum``) and rounded to the
    model dtype once, as on one device."""
    cfg = lay.cfg
    b, S, d = hn[0].shape

    def part(lp, h, e0):
        x = h.reshape(b * S, d)
        r = L.moe_route(lp["ffn"]["router"], x,
                        num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
                        capacity_factor=cfg.moe_capacity_factor,
                        groups=groups)
        return L.moe_experts(lp["ffn"], x, r, top_k=cfg.moe_top_k,
                             ffn_type=cfg.ffn_type, expert0=e0)

    dt = hn[0].dtype
    if not (lay.moe_ep or lay.ffn_split):
        return _each(lambda lp, h: part(lp, h, 0).reshape(b, S, d).to(dt),
                     lps, hn)
    parts = [part(lp, h, e0) for lp, h, e0 in zip(lps, hn, lay.expert0)]
    return _each(lambda y: y.reshape(b, S, d).to(dt),
                 _moe_sum(parts, row.devs))


def _out_proj(lay: Layout, row: Row, lps, x, outs):
    """The attention outputs (per position, its heads) through its ``wo``
    rows, summed over the row, residual; where every position ran all
    heads, the whole ``wo`` and no sum."""
    q_dim = lay.cfg_l.q_dim
    proj = lambda lp, h, o: o.reshape(h.shape[0], h.shape[1], q_dim) \
        @ lp["attn"]["wo"]
    if lay.heads_split:
        a = _attn_sum([proj(lp, h, o) for lp, h, o in zip(lps, x, outs)],
                      row.devs)
    else:
        a = _each(proj, lps, x, outs)
    return _each(lambda u, v: u + v, x, a)


# =============================================================================
# prefill
# =============================================================================

class RowPrefill(NamedTuple):
    """A data row's prefill in flight: its row, the residual stream on each
    position, each position's local cache, and what every layer shares
    (``groups``: the MoE dispatch groups of the row's tokens)."""
    row: Row
    x: List[torch.Tensor]
    caches: List[dict]
    sincos: list
    act_idx: list
    kfit: int
    kv_keep: torch.Tensor
    last_pos: torch.Tensor
    groups: Optional[int]


def _zeros_cache(lay: Layout, B: int, kv_cap: int, act_cap: int, dev):
    """One position's local hybrid cache, in the cache's format."""
    cfg = lay.cfg
    dt = T.torch_dtype(cfg) if lay.quant is None else torch.int8
    i32 = dict(dtype=torch.int32, device=dev)
    d = cfg.d_model // lay.m if lay.act_split else cfg.d_model
    kv = (cfg.num_layers, B, kv_cap, lay.kvh_cache, cfg.head_dim)
    act = (cfg.num_layers, B, act_cap, d)
    cache = {"k": torch.zeros(kv, dtype=dt, device=dev),
             "v": torch.zeros(kv, dtype=dt, device=dev),
             "act": torch.zeros(act, dtype=dt, device=dev),
             "act_pos": torch.zeros((B, act_cap), **i32),
             "kv_len": torch.zeros((B,), **i32),
             "act_len": torch.zeros((B,), **i32)}
    if lay.quant is not None:
        f16 = dict(dtype=torch.float16, device=dev)
        cache.update(k_s=torch.zeros(kv[:-1] + (1,), **f16),
                     v_s=torch.zeros(kv[:-1] + (1,), **f16),
                     act_s=torch.zeros(act[:-1] + (1,), **f16))
    return cache


def prefill_begin(lay: Layout, row: Row, res: Sequence[dict], tokens: np.ndarray,
                  kv_keep: np.ndarray, last_pos: np.ndarray, kv_cap: int,
                  act_cap: int, moe_batch: Optional[int] = None) -> RowPrefill:
    """Check the row's split on the host, upload it, embed, allocate each
    position's cache.  ``moe_batch``: the batch whose MoE groups the row's
    requests share (``moe_groups``).  Reads no device value."""
    cfg = lay.cfg
    kv_keep = np.asarray(kv_keep, np.int32)
    last_pos = np.asarray(last_pos, np.int32)
    M.check_split(kv_keep, last_pos, kv_cap, act_cap)
    lead = row.devs[0]
    toks = M.upload(np.asarray(tokens, np.int32), lead)
    kk, lp = M.upload(kv_keep, lead), M.upload(last_pos, lead)
    B, S = toks.shape
    x = embed_rows(lay, row, res, toks)
    caches = [_zeros_cache(lay, B, kv_cap, act_cap, d) for d in row.devs]
    slots = torch.arange(act_cap, dtype=torch.int32, device=lead)[None]
    idx = (kk[:, None] + slots).clamp(0, S - 1).long()
    idx = idx[:, :, None].expand(B, act_cap, cfg.d_model)
    sc = T._rope_for(cfg, M._positions(S, lead))
    sincos = [None if sc is None else tuple(t.to(d) for t in sc)
              for d in row.devs]
    return RowPrefill(row, x, caches, sincos, [idx.to(d) for d in row.devs],
                      min(S, kv_cap), kk, lp, moe_groups(lay, B, moe_batch, S))


def prefill_layer(lay: Layout, pre: RowPrefill, lps: Sequence[dict],
                  i: int) -> RowPrefill:
    """Layer ``i`` of the row's prefill: the ACT checkpoint stored by slices
    (in an int8 cache against each whole row's scale), each position's
    heads through the flash kernel, the seams summed."""
    cfg, row = lay.cfg, pre.row
    lps = _row_layers(lay, row, lps)
    x = pre.x
    act = _each(lambda h, ix: torch.gather(h, 1, ix), x, pre.act_idx)
    act = encode_act(lay, row, [a[..., sl] for a, sl in zip(act, lay.dsl)])
    kept = (i, slice(None), slice(None, pre.kfit))
    hn = _each(lambda lp, h: L.apply_norm(h, lp["ln1"], cfg.norm_type),
               lps, x)
    outs = []
    for c, (lp, h, cache) in enumerate(zip(lps, hn, pre.caches)):
        if isinstance(act[c], tuple):                               # A^i
            cache["act"][i], cache["act_s"][i] = act[c]
        else:
            M._store(cache, "act", i, act[c])
        q, k, v = T._qk_roped(lp["attn"], lay.cfg_w, h, pre.sincos[c])
        outs.append(T.flash_attention(q, _att_heads(lay, c, k),
                                      _att_heads(lay, c, v), causal=True))
        M._store(cache, "k", kept, k[:, :pre.kfit])
        M._store(cache, "v", kept, v[:, :pre.kfit])
    x = _out_proj(lay, row, lps, x, outs)
    return pre._replace(x=_layer_mlp(lay, row, lps, x, pre.groups))


def prefill_end(lay: Layout, pre: RowPrefill, res: Sequence[dict]):
    """Final norm, each position's logits at each request's last prompt
    position, the lengths.  -> (logits per position (b, 1, V/m), caches)."""
    row = pre.row
    h = _final(lay, res, pre.x)
    B = pre.kv_keep.shape[0]
    act_cap = pre.caches[0]["act"].shape[2]
    lead = row.devs[0]
    ar = torch.arange(B, device=lead)
    at = (pre.last_pos - 1).long()
    h = _each(lambda t: t[ar.to(t.device), at.to(t.device)][:, None], h)
    logits = logits_rows(lay, res, h)
    slots = torch.arange(act_cap, dtype=torch.int32, device=lead)[None]
    act_pos = (pre.kv_keep[:, None] + slots).int()
    kv_len = torch.clamp(pre.kv_keep, max=pre.kfit).int()
    act_len = torch.clamp(pre.last_pos - pre.kv_keep, max=act_cap).int()
    for cache, dev in zip(pre.caches, row.devs):
        cache.update(act_pos=act_pos.to(dev), kv_len=kv_len.to(dev),
                     act_len=act_len.to(dev))
    return logits, pre.caches


def assemble(lay: Layout, rows: Sequence[Row], caches: Sequence[Sequence[dict]],
             B: int) -> Cache:
    """The rows' local caches as one ``Sharded`` cache of batch ``B`` under
    ``plan.cache_spec``."""
    plan, mesh = lay.plan, lay.plan.mesh
    shards: Dict[str, list] = {}
    for row, cs in zip(rows, caches):
        for p, cache in zip(row.pos, cs):
            for k, t in cache.items():
                shards.setdefault(k, [None] * mesh.size)[p.index] = t
    out = {}
    for k, parts in shards.items():
        shape = list(parts[0].shape)
        if k in ("k", "v", "k_s", "v_s"):
            shape[1], shape[3] = B, lay.cfg.num_kv_heads
        elif k == "act":
            shape[1], shape[3] = B, lay.cfg.d_model
        elif k == "act_s":
            shape[1] = B
        else:
            shape[0] = B
        spec = plan.cache_spec(k, shape)
        out[k] = Sharded(mesh, spec, shape, parts[0].dtype, parts)
    return out


def prefill_rows(lay: Layout, params, rows: Sequence[Row], tokens,
                 kv_keep, last_pos, kv_cap: int, act_cap: int, *,
                 layers: Optional[Callable] = None,
                 after_layer: Optional[Callable] = None,
                 moe_batch: Optional[int] = None):
    """The hybrid prefill of each data row's own batch (``tokens[r]`` (b_r,
    S), ``kv_keep[r]``, ``last_pos[r]``: host arrays), layer by layer across
    the rows.  ``params``: the resident tree of ``Sharded`` leaves (the
    whole tree, or the tree without ``layers`` when ``layers(i)`` gives
    each position's layer-``i`` weights by position index;
    ``after_layer(i)``, when given, runs once layer ``i`` is issued).
    ``moe_batch``: the batch the rows' requests are slices of, whose MoE
    groups they share (None: each row's batch is the whole one).
    -> (each row's first greedy tokens (b_r,) int32 on its first position,
    each row's per-position local caches, each row's per-position logits
    (b_r, 1, V/m))."""
    plan = lay.plan
    res = [local({k: v for k, v in params.items() if k != "layers"}, p)
           for p in plan.mesh.positions]
    if layers is None:
        layers = layer_source(params, plan)
    pres = [prefill_begin(lay, row, [res[p.index] for p in row.pos], t, kk,
                          lp, kv_cap, act_cap, moe_batch)
            for row, t, kk, lp in zip(rows, tokens, kv_keep, last_pos)]
    for i in range(lay.cfg.num_layers):
        lps = layers(i)
        pres = [prefill_layer(lay, pre, [lps[p.index] for p in pre.row.pos], i)
                for pre in pres]
        if after_layer is not None:
            after_layer(i)
    curs, caches, logits = [], [], []
    for pre in pres:
        lg, cs = prefill_end(lay, pre, [res[p.index] for p in pre.row.pos])
        curs.append(argmax_rows(lay, pre.row, lg)[0][:, 0])
        caches.append(cs)
        logits.append(lg)
    return curs, caches, logits


def _split_args(plan: ShardPlan, rows, tokens, kv_keep, last_pos):
    """Each row's share of a global batch's host arrays, and the batch its
    MoE groups come from (None where each row holds the whole batch)."""
    B = tokens.shape[0]
    return ([tokens[r.bidx] for r in rows], [kv_keep[r.bidx] for r in rows],
            [last_pos[r.bidx] for r in rows],
            B if plan.batch_split(B) else None)


def prefill(plan: ShardPlan, params, tokens: np.ndarray, kv_cap: int,
            act_cap: int, kv_keep, last_pos, *, layers: Optional[Callable]
            = None, after_layer: Optional[Callable] = None,
            lay: Optional[Layout] = None):
    """The group-batched hybrid prefill over the plan's mesh (each data row
    runs its slice of the batch; ``params``/``layers`` as for
    ``prefill_rows``).  -> (the first greedy tokens, one (b,) int32 per
    data row on its first position, the ``Sharded`` cache)."""
    lay = lay or Layout(plan)
    tokens = np.asarray(tokens, np.int32)
    kv_keep, last_pos = np.asarray(kv_keep), np.asarray(last_pos)
    B = tokens.shape[0]
    rows = rows_for(plan, B)
    *args, moe_batch = _split_args(plan, rows, tokens, kv_keep, last_pos)
    curs, caches, _ = prefill_rows(
        lay, params, rows, *args, kv_cap, act_cap, layers=layers,
        after_layer=after_layer, moe_batch=moe_batch)
    return curs, assemble(lay, rows, caches, B)


def init_cache(lay: Layout, B: int, kv_cap: int, act_cap: int) -> Cache:
    """A zeroed ``Sharded`` hybrid cache of ``B`` slots under
    ``plan.cache_spec``, each position's shard allocated on its device."""
    rows = rows_for(lay.plan, B)
    return assemble(lay, rows, [[_zeros_cache(lay, len(r.bidx), kv_cap,
                                              act_cap, d) for d in r.devs]
                                for r in rows], B)


def select_rows(cache: dict, idx) -> dict:
    """A local cache's batch rows ``idx`` (a (k,) long tensor on its
    device): every region plane along its batch dim 1, the lengths and ACT
    positions along 0."""
    planes = M.region_planes(cache)
    return {k: v[:, idx] if k in planes else v[idx] for k, v in cache.items()}


def scatter_rows(cache: Cache, row: Row, new: Sequence[dict], slots) -> None:
    """Write a row's admission caches ``new`` (per position) into its local
    slots ``slots`` (a (k,) long tensor on the row's first position) of the
    server's ``cache``, in place."""
    for p, dev, n in zip(row.pos, row.devs, new):
        idx = slots.to(dev)
        for key in M.region_planes(n):
            cache[key].shard(p)[:, idx] = n[key]
        for key in ("act_pos", "kv_len", "act_len"):
            cache[key].shard(p)[idx] = n[key]


def _layer_of(stacked, pos: Position, i: int) -> dict:
    """Position ``pos``'s weights of layer ``i`` of a stacked tree of
    ``Sharded`` leaves."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t.shard(pos)[i]
    return walk(stacked)


def layer_source(params, plan: ShardPlan) -> Callable[[int], List[dict]]:
    """``layers(i)`` over a resident ``Sharded`` tree's stacked layers."""
    stacked = params["layers"]
    return lambda i: [_layer_of(stacked, p, i) for p in plan.mesh.positions]


# =============================================================================
# decode
# =============================================================================

class RowStep(NamedTuple):
    """One data row's decode step in flight: the residual stream on each
    position, each position's local cache, its plan, its scratch, the MoE
    dispatch groups of the row's tokens, and with the CPU lane each
    position's device-partial page tables."""
    row: Row
    x: List[torch.Tensor]
    caches: List[dict]
    plans: List[M.DecodePlan]
    store: List[torch.Tensor]
    groups: Optional[int] = None
    ha_tables: Optional[list] = None


def _locals(cache: Cache, pos: Position) -> dict:
    return {k: v.shard(pos) for k, v in cache.items()}


def step_begin(lay: Layout, row: Row, res, cache: Cache, cur, store_act, *,
               pages_bound=None, act_pages_bound=None, any_act: bool = True,
               groups: Optional[int] = None, host=None) -> RowStep:
    """Record the new ACT position, build the page tables once on the row's
    first position, embed the row's tokens ``cur`` (b,) on every position.
    ``store_act`` (b,) bool on the row's first position; ``any_act``
    (whether it may hold a True, from the host schedule) as
    ``M.hybrid_decode_plan`` takes it; ``host``: the CPU lane, whose device
    partials attend over their own row's page and the ACT region."""
    cfg, cl = lay.cfg, lay.cfg_l
    caches = [_locals(cache, p) for p in row.pos]
    lead = caches[0]
    ctx = lead["kv_len"] + lead["act_len"]
    plan = M.hybrid_decode_plan(cl, lead, store_act, pages_bound=pages_bound,
                                act_pages_bound=act_pages_bound,
                                quant=lay.quant, any_act=any_act)
    plans = [plan]
    for dev, c in zip(row.devs[1:], caches[1:]):
        c["act_pos"] = lead["act_pos"].to(dev)
        akv = plan.act_kv
        if akv is not None:
            akv = M.ActKV(tuple(t.to(dev) for t in akv.sincos_new),
                          akv.sin.to(dev), akv.cos.to(dev),
                          akv.page_index.to(dev), torch.empty_like(
                              akv.k, device=dev),
                          torch.empty_like(akv.v, device=dev))
        plans.append(plan._replace(
            tables=tuple(t.to(dev) for t in plan.tables), act_kv=akv,
            act_read=plan.act_read.to(dev),
            write_on=tuple(t.to(dev) for t in plan.write_on)))
    ha = None
    if host is not None:
        act_cap = lead["act"].shape[2]
        n_act = plan.act_stride // M.PAGE if plan.act_kv is not None \
            else act_cap // M.PAGE if act_pages_bound is None \
            else min(int(act_pages_bound), act_cap // M.PAGE)
        t = M.hybrid_page_table((~store_act).int(), plan.act_read, M.PAGE,
                                plan.act_stride, 1 + n_act)
        ha = [tuple(x.to(d) for x in t) for d in row.devs]
    x = embed_rows(lay, row, res, cur[:, None],
                   ctx if cfg.pos_type == "learned" else None)
    return RowStep(row, x, caches, plans,
                   [store_act.to(d) for d in row.devs], groups, ha)


def step_layer(lay: Layout, st: RowStep, lps: Sequence[dict], i: int,
               kv: Optional[Sequence[tuple]] = None, host=None) -> RowStep:
    """Layer ``i`` of the row's step: each position writes its new K/V row
    (its heads) or its slice of the checkpoint, the layer's ACT slices are
    gathered to whole rows, each position's kernels attend over its heads,
    and the seams sum.  ``kv``: each position's KV planes of the layer
    (``M.kv_planes`` order) when they live elsewhere than the cache (the
    offload executor's spill buffers).

    ``host``, the CPU lane (the offload executor's): the new K/V row goes to
    ``host.own(row, c)``, a one-page region of position ``c``'s (and, with
    ``host.write_cache``, also into the cache's planes);
    ``host.queries(row, i, qs)`` ships the queries to the host,
    ``host.partial(row, c, i)`` attends over position ``c``'s heads of the
    layer's host rows -> (o, m, l) on its device, merged with the device
    partial over [the own row ; the ACT region]; ``host.store(row, i)``
    stores the new rows back after the layer."""
    cfg, cl, cw, row = lay.cfg, lay.cfg_l, lay.cfg_w, st.row
    lps = _row_layers(lay, row, lps)
    lpas = _att_layers(lay, lps)
    hn = _each(lambda lp, h: L.apply_norm(h, lp["ln1"], cfg.norm_type),
               lps, st.x)
    act_new = encode_act(lay, row, [x[:, 0, sl] for x, sl in
                                    zip(st.x, lay.dsl)])
    regions, qs, news = [], [], []
    for c, (lp, cache, plan, h) in enumerate(
            zip(lps, st.caches, st.plans, hn)):
        if host is not None:
            kvp = host.own(row, c)
        elif kv is not None:
            kvp = kv[c]
        else:
            kvp = [cache[key][i] for key in M.kv_planes(cache)]
        ac = cache["act"][i]
        scales = M.plane_scales(kvp, cache["act_s"][i] if "act_s" in cache
                                else None)
        q, k, v = T._qk(lp["attn"], cw, h)
        if plan.act_kv is not None:
            q = L.apply_rope(q, *plan.act_kv.sincos_new)
            k = L.apply_rope(k, *plan.act_kv.sincos_new)
        if host is None:
            M._write_new(kvp[0], kvp[1], ac, k, v, act_new[c],
                         cache["kv_len"], cache["act_len"], st.store[c],
                         scales, plan.write_on)
        else:
            M._write_new(kvp[0], kvp[1], ac, k, v, act_new[c],
                         torch.zeros_like(cache["kv_len"]), cache["act_len"],
                         st.store[c], scales)
            if host.write_cache:
                _put_rows(cache, i, kvp, plan)
        regions.append((kvp, ac, scales))
        qs.append(q)
        news.append((k, v))
    acts = [r[1] for r in regions]
    if lay.act_split:
        acts = _act_gather(acts, row.devs)
    if host is not None:
        host.queries(row, i, qs)
    outs = []
    for c, (lpa, q, (kvp, _, scales), a, plan, (k, v)) in enumerate(
            zip(lpas, qs, regions, acts, st.plans, news)):
        kc, vc = (_att_heads(lay, c, t) for t in kvp[:2])
        if scales is not None:
            scales = (_att_heads(lay, c, scales[0]),
                      _att_heads(lay, c, scales[1]), scales[2])
        own = M.OwnRow(_att_heads(lay, c, k), _att_heads(lay, c, v),
                       st.caches[c]["act_len"], st.store[c]) \
            if scales is not None and plan.exact_own else None
        if host is None:
            outs.append(M._hybrid_attend(lpa, cl, q, kc, vc, a, plan.tables,
                                         plan.act_kv, scales=scales, own=own))
            continue
        o_d, m_d, l_d = M._hybrid_attend(lpa, cl, q, kc, vc, a,
                                         st.ha_tables[c], plan.act_kv,
                                         return_lse=True, scales=scales,
                                         own=own)
        o, _, _ = merge_partials_torch(o_d.float(), m_d, l_d,
                                       *host.partial(row, c, i))
        outs.append(o.to(q.dtype))
    x = _out_proj(lay, row, lps, st.x, outs)
    x = _layer_mlp(lay, row, lps, x, st.groups)
    if host is not None:
        host.store(row, i)
    return st._replace(x=x)


def _put_rows(cache: dict, i: int, own, plan) -> None:
    """The new K/V rows of a one-page region ``own`` (row 0) written into
    the cache's KV planes of layer ``i`` at ``kv_len``, for the requests
    the plan writes a K/V row for."""
    planes = [cache[key][i] for key in M.kv_planes(cache)]
    B = planes[0].shape[0]
    ar = torch.arange(B, device=planes[0].device)
    ki = cache["kv_len"].clamp(max=planes[0].shape[1] - 1).long()
    on = plan.write_on[0].view(B, 1, 1)
    for plane, new in zip(planes, own):
        plane[ar, ki] = torch.where(on, new[:, 0], plane[ar, ki])


def step_end(lay: Layout, st: RowStep, res, cache: Cache, active=None):
    """Final norm, logits and the greedy token on every position; the
    lengths advance (frozen for the slots not ``active``) on every
    position.  -> (the row's next tokens on its first position (b,), each
    position's logits over its vocabulary slice (b, 1, V/m))."""
    row = st.row
    logits = logits_rows(lay, res, _final(lay, res, st.x))
    nxt = argmax_rows(lay, row, logits)[0][:, 0]
    lead = st.caches[0]
    store = st.store[0]
    kv_len = lead["kv_len"] + (~store).int()
    act_len = lead["act_len"] + store.int()
    if active is not None:
        kv_len = torch.where(active, kv_len, lead["kv_len"])
        act_len = torch.where(active, act_len, lead["act_len"])
    for p, dev in zip(row.pos, row.devs):
        cache["kv_len"].shards[p.index] = kv_len.to(dev)
        cache["act_len"].shards[p.index] = act_len.to(dev)
        cache["act_pos"].shards[p.index] = lead["act_pos"].to(dev)
    return nxt, logits


def gather_batch(plan: ShardPlan, rows: Sequence[Row], parts, B: int):
    """Per-row tensors (b, ...) -> the global batch (B, ...) on position 0's
    device (the rows' first positions hold them)."""
    if not plan.batch_split(B):
        return parts[0]
    dev = plan.mesh.devices[0]
    return C.all_gather(list(parts), 0, [dev], kind="batch")[0]


def take(row: Row, t: torch.Tensor) -> torch.Tensor:
    """The row's columns of a per-batch tensor (..., B), on its first
    position (its batch rows are contiguous)."""
    b0 = int(row.bidx[0])
    return t[..., b0:b0 + len(row.bidx)].to(row.devs[0])


#: the cache planes ``decode_chunk`` holds to the plan's layout after each
#: step, by their logical axes
_CONSTRAIN = {"k": (None, SH.BATCH, None, SH.MODEL, None),
              "v": (None, SH.BATCH, None, SH.MODEL, None),
              "k_s": (None, SH.BATCH, None, SH.MODEL, None),
              "v_s": (None, SH.BATCH, None, SH.MODEL, None),
              "act": (None, SH.BATCH, None, SH.MODEL),
              "act_s": (None, SH.BATCH, None, None)}


def decode_chunk(plan: ShardPlan, params, cur, cache: Cache, store_sched,
                 active_sched=None, *, pages_bound=None, act_pages_bound=None,
                 any_act=None, feed=None, layers: Optional[Callable] = None,
                 kv: Optional[Callable] = None, host=None,
                 before_step: Optional[Callable] = None,
                 after_layer: Optional[Callable] = None,
                 after_step: Optional[Callable] = None,
                 lay: Optional[Layout] = None):
    """``M.hybrid_decode_chunk`` over the plan's mesh: masked multi-step
    greedy decode, the cache updated in place.  The one decode loop of the
    sharded path: the engine, the server, the offload executor (through
    the hooks) and the teacher-forced reader (``feed``) all run it.

    cur: one (b,) int32 per data row on its first position; store_sched /
    active_sched: (S, B) bool on position 0's device (active None: every
    slot in every step).  ``any_act`` (S,) host bools: whether step s binds
    an active token to the ACT region (None: every step may; an int8 cache
    then attends to each ACT-bound token's exact K/V).  ``feed`` (S, B)
    int32 on position 0's device,
    when given, is the token each step runs on in place of the one the
    step before chose (``cur`` unused).  ``params``/``layers`` as for
    ``prefill`` (``layers(i)`` is called once per layer of every step, in
    order); ``kv(i)``, when given, each position's KV planes of layer
    ``i`` by position index, where they live elsewhere than the cache (the
    offload executor's spill buffers); ``host``: the CPU lane
    (``step_layer``).  ``before_step(s)``,
    ``after_layer(i)`` (once layer ``i`` of the step is issued) and
    ``after_step(s, logits)`` (each row's per-position logits) are called
    where given.
    -> (tokens (B, S) int32 with -1 at inactive entries and the next cur
    (B,), both on position 0's device; the next cur per row)."""
    lay = lay or Layout(plan)
    cfg = lay.cfg
    B = store_sched.shape[1]
    rows = rows_for(plan, B)
    whole = None if not plan.batch_split(B) else B
    res = [local({k: v for k, v in params.items() if k != "layers"}, p)
           for p in plan.mesh.positions]
    if layers is None:
        layers = layer_source(params, plan)
    cur = [None] * len(rows) if cur is None else list(cur)
    toks = [[] for _ in rows]
    for s in range(store_sched.shape[0]):
        if before_step is not None:
            before_step(s)
        steps, acts = [], []
        for r, row in enumerate(rows):
            if feed is not None:
                cur[r] = take(row, feed[s])
            store = take(row, store_sched[s])
            act = None
            if active_sched is not None:
                act = take(row, active_sched[s])
                store = store & act
            acts.append(act)
            steps.append(step_begin(
                lay, row, [res[p.index] for p in row.pos], cache, cur[r],
                store, pages_bound=pages_bound,
                act_pages_bound=act_pages_bound,
                any_act=True if any_act is None else bool(any_act[s]),
                groups=moe_groups(lay, len(row.bidx), whole, 1), host=host))
        for i in range(cfg.num_layers):
            lps = layers(i)
            kvi = None if kv is None else kv(i)
            steps = [step_layer(lay, st, [lps[p.index] for p in st.row.pos],
                                i, kv=None if kvi is None else
                                [kvi[p.index] for p in st.row.pos], host=host)
                     for st in steps]
            if after_layer is not None:
                after_layer(i)
        logits = []
        for r, (row, st) in enumerate(zip(rows, steps)):
            rres = [res[p.index] for p in row.pos]
            nxt, lg = step_end(lay, st, rres, cache, acts[r])
            logits.append(lg)
            if acts[r] is None:
                toks[r].append(cur[r])
                cur[r] = nxt
            else:
                toks[r].append(torch.where(acts[r], cur[r], -1))
                cur[r] = torch.where(acts[r], nxt, cur[r])
        if after_step is not None:
            after_step(s, logits)
        for key, axes in _CONSTRAIN.items():
            if cache.get(key) is not None:
                cache[key] = SH.constrain(cache[key], *axes)
    out = [M._stack(t, c) for t, c in zip(toks, cur)]
    both = [torch.cat([o, c[:, None]], 1) for o, c in zip(out, cur)]
    return gather_batch(plan, rows, both, B), cur


def full_logits(lay: Layout, row: Row, logits) -> torch.Tensor:
    """Each position's vocabulary slice of the row's logits, joined on its
    first position (a reader's view, not a serving collective)."""
    if not lay.vocab_split:
        return logits[0]
    return torch.cat([lg.to(row.devs[0]) for lg in logits], -1)


def forced_logits(plan: ShardPlan, params, tokens: np.ndarray, kv_cap: int,
                  act_cap: int, kv_keep, last_pos, store_sched, gold, *,
                  pages_bound=None, act_pages_bound=None, any_act=None,
                  lay: Optional[Layout] = None) -> torch.Tensor:
    """Teacher-forced logits of the sharded prefill and decode: the
    prefill's at each request's last prompt position, then each step's fed
    ``gold`` (B, n) (token s in step s) in place of its argmax.
    ``store_sched``: (n, B) bool on position 0's device; ``any_act`` as
    ``decode_chunk`` takes it.  -> (B, n, V) float32 on position 0's
    device."""
    lay = lay or Layout(plan)
    tokens = np.asarray(tokens, np.int32)
    kv_keep, last_pos = np.asarray(kv_keep), np.asarray(last_pos)
    B, n = gold.shape
    rows = rows_for(plan, B)
    *args, moe_batch = _split_args(plan, rows, tokens, kv_keep, last_pos)
    _, caches, first = prefill_rows(lay, params, rows, *args, kv_cap,
                                    act_cap, moe_batch=moe_batch)
    out = [[full_logits(lay, row, lg)[:, -1]] for row, lg in zip(rows, first)]

    def after_step(s, logits):
        for o, row, lg in zip(out, rows, logits):
            o.append(full_logits(lay, row, lg)[:, -1])

    if n > 1:
        dev0 = plan.mesh.devices[0]
        decode_chunk(plan, params, None, assemble(lay, rows, caches, B),
                     store_sched[:n - 1], feed=gold[:, :n - 1].T.int().to(dev0),
                     pages_bound=pages_bound, act_pages_bound=act_pages_bound,
                     any_act=None if any_act is None else any_act[:n - 1],
                     after_step=after_step, lay=lay)
    out = [torch.stack(o, 1) for o in out]
    return out[0] if not plan.batch_split(B) else \
        torch.cat([o.to(plan.mesh.devices[0]) for o in out], 0)
