"""Top-level model API of the uniform family: embed -> layers -> logits, the
plain KV decode path (the oracle's) and the hybrid KV/ACT decode path (the
engine's).  Counterparts of ``repro.models.model``.

The hybrid decode takes one of two kernel routes per model.  Learned-position
models (OPT) run the fused ``hybrid_paged_attention``, which recomputes each
ACT page's K/V inside the attention loop.  RoPE models (yi, minitron) first
recompute the ACT region's bounded prefix with ``kv_gen`` (norm, projection,
and K rotated at each ACT token's recorded position) into a per-step scratch
pool, then run ``hybrid_paged_attention_two_pool`` over the KV pages and that
pool: the fused loop cannot rotate K.

JAX's functions are pure and the JAX engine donates the cache into its decode
loop; here the cache tensors are updated in place instead, and each function
returns the (same) cache dict for symmetry with the reference.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.hybrid_attention.ops import (
    hybrid_paged_attention, hybrid_paged_attention_two_pool)
from repro_torch.kernels.kv_gen.ops import kv_gen
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.transformer import (init_params, layer_params,  # noqa: F401 (re-export)
                                            pad_vocab, torch_dtype)

Params = Dict[str, Any]
Cache = Dict[str, Any]
PAGE = 16


# =============================================================================
# embedding / unembedding
# =============================================================================

def _embed_tokens(params, cfg, tokens):
    return params["embed"][tokens.long()]


def embed_input(params, cfg: ModelConfig, tokens, offset: int = 0):
    """tokens (B, S) -> x (B, S, d); learned positions offset..offset+S are
    added here, RoPE is applied inside attention."""
    x = _embed_tokens(params, cfg, tokens)
    if cfg.pos_type == "learned":
        x = x + params["pos_embed"][offset: offset + x.shape[1]][None]
    return x


def _positions(S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None]


def unembed(params, cfg: ModelConfig, h):
    """Tied or untied embeddings; logits in float32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (h @ w.to(h.dtype)).float()


# =============================================================================
# plain KV cache: prefill + decode (the exactness oracle's path)
# =============================================================================

def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda") -> Cache:
    shape = (cfg.num_layers, B, max_len, cfg.num_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "kv_len": torch.zeros((B,), dtype=torch.int32, device=device)}


def prefill(params, cfg: ModelConfig, tokens, max_len: int):
    """Run the prompt (B, S), build the decode cache. -> (last_logits, cache)."""
    h = embed_input(params, cfg, tokens)
    B, S = h.shape[:2]
    cache = init_cache(cfg, B, max_len, device=h.device)
    sincos = T._rope_for(cfg, _positions(S, h.device))
    for i in range(cfg.num_layers):
        h, (k, v) = T.layer_full(layer_params(params, i), cfg, h, sincos)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    h = L.apply_norm(h, params["final_norm"], cfg.norm_type)
    cache["kv_len"].fill_(S)
    return unembed(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, token, cache: Cache):
    """token (B, 1) -> (logits (B, 1, V), cache); kv_len advances by 1."""
    kv_len = cache["kv_len"]
    x = _embed_tokens(params, cfg, token)
    if cfg.pos_type == "learned":
        x = x + params["pos_embed"][kv_len.long()][:, None]
    sincos = T._rope_for(cfg, kv_len[:, None])
    for i in range(cfg.num_layers):
        x = T.layer_decode(layer_params(params, i), cfg, x, cache["k"][i],
                           cache["v"][i], kv_len, sincos)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    cache["kv_len"] = kv_len + 1
    return unembed(params, cfg, x), cache


def decode_loop(params, cfg: ModelConfig, cur, cache: Cache, n_steps: int):
    """Greedy generation over the plain cache, argmax on the device.

    cur: (B,) first token to emit.  -> (tokens (B, n_steps) int32, cache)."""
    toks = []
    for _ in range(n_steps):
        toks.append(cur)
        lg, cache = decode_step(params, cfg, cur[:, None], cache)
        cur = lg[:, -1].argmax(-1).int()
    return _stack(toks, cur), cache


def _stack(toks, like):
    if not toks:
        return torch.zeros((like.shape[0], 0), dtype=torch.int32,
                           device=like.device)
    return torch.stack(toks, 1)


# =============================================================================
# HYBRID KV/ACT cache — the paper's technique
# =============================================================================

def init_hybrid_cache(cfg: ModelConfig, B: int, kv_cap: int, act_cap: int,
                      device="cuda") -> Cache:
    """KV region holds the context prefix as K/V; ACT region holds the suffix
    as layer-input activation checkpoints (paper Eq. 7 recomputes K/V).
    Both capacities are whole pages, so each layer's region reshapes without
    a copy into a page pool of the hybrid kernel."""
    if kv_cap % PAGE or act_cap % PAGE:
        raise ValueError(f"kv_cap={kv_cap}, act_cap={act_cap}: not multiples "
                         f"of the {PAGE}-token page")
    dt = torch_dtype(cfg)
    kv = (cfg.num_layers, B, kv_cap, cfg.num_kv_heads, cfg.head_dim)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "act": torch.zeros((cfg.num_layers, B, act_cap, cfg.d_model), dtype=dt,
                           device=device),
        "act_pos": torch.zeros((B, act_cap), **i32),
        "kv_len": torch.zeros((B,), **i32),
        "act_len": torch.zeros((B,), **i32),
    }


def hybrid_prefill_batched(params, cfg: ModelConfig, tokens, kv_cap: int,
                           act_cap: int, kv_keep, last_pos):
    """Group-batched hybrid prefill with PER-REQUEST KV/ACT split points.

      kv region  <- K/V of positions [0, kv_keep[b])   (kv_len masks the rest)
      act region <- checkpoints of [kv_keep[b], last_pos[b])  (gathered)

    tokens (B, S); kv_keep, last_pos: (B,) int32 tensors on the same device.
    -> (last_logits (B, 1, V), hybrid cache).  Its three stages are the
    offload executor's too, which runs the layers with streamed weights."""
    pre = hybrid_prefill_begin(params, cfg, tokens, kv_cap, act_cap, kv_keep,
                               last_pos)
    h = pre.h
    for i in range(cfg.num_layers):
        h = hybrid_prefill_layer(layer_params(params, i), cfg, h, pre, i)
    return hybrid_prefill_end(params, cfg, h, pre, kv_keep, last_pos)


class PrefillPlan(NamedTuple):
    """What every layer of one hybrid prefill shares: the embedded input
    ``h``, the cache it fills, RoPE at positions 0..S-1 (or None), the
    ACT-region gather index (B, act_cap, d) and the KV rows each layer keeps."""
    h: torch.Tensor
    cache: Cache
    sincos: Optional[Tuple[torch.Tensor, torch.Tensor]]
    act_idx: torch.Tensor
    kfit: int


def hybrid_prefill_begin(params, cfg: ModelConfig, tokens, kv_cap: int,
                         act_cap: int, kv_keep, last_pos) -> PrefillPlan:
    """Check the split against the capacities, embed, allocate the cache."""
    if int(kv_keep.max()) > kv_cap:
        raise ValueError(f"kv_keep={int(kv_keep.max())} exceeds kv_cap={kv_cap}")
    if int((last_pos - kv_keep).max()) > act_cap:
        raise ValueError(f"ACT span {int((last_pos - kv_keep).max())} exceeds "
                         f"act_cap={act_cap}")
    h = embed_input(params, cfg, tokens)
    B, S = h.shape[:2]
    dev = h.device
    cache = init_hybrid_cache(cfg, B, kv_cap, act_cap, device=dev)
    slots = torch.arange(act_cap, dtype=torch.int32, device=dev)[None]
    # act region slot j of request b holds the checkpoint of position kv_keep[b]+j
    act_idx = (kv_keep[:, None] + slots).clamp(0, S - 1).long()
    act_idx = act_idx[:, :, None].expand(B, act_cap, cfg.d_model)
    return PrefillPlan(h, cache, T._rope_for(cfg, _positions(S, dev)), act_idx,
                       min(S, kv_cap))


def hybrid_prefill_layer(lp, cfg: ModelConfig, h, pre: PrefillPlan, i: int):
    """Layer ``i`` of the hybrid prefill: store its input as the ACT
    checkpoint, run it, keep its first ``kfit`` K/V rows.  -> its output."""
    cache = pre.cache
    cache["act"][i] = torch.gather(h, 1, pre.act_idx)       # A^i, the checkpoint
    h, (k, v) = T.layer_full(lp, cfg, h, pre.sincos)
    cache["k"][i, :, :pre.kfit] = k[:, :pre.kfit]
    cache["v"][i, :, :pre.kfit] = v[:, :pre.kfit]
    return h


def hybrid_prefill_end(params, cfg: ModelConfig, h, pre: PrefillPlan, kv_keep,
                       last_pos):
    """Final norm, logits at each request's last prompt position, lengths.
    -> (last_logits (B, 1, V), cache)."""
    cache = pre.cache
    h = L.apply_norm(h, params["final_norm"], cfg.norm_type)
    B, act_cap = h.shape[0], cache["act"].shape[2]
    ar = torch.arange(B, device=h.device)
    logits = unembed(params, cfg, h[ar, (last_pos - 1).long()][:, None])
    slots = torch.arange(act_cap, dtype=torch.int32, device=h.device)[None]
    cache["act_pos"] = (kv_keep[:, None] + slots).int()
    # lengths clamped to what was actually stored
    cache["kv_len"] = torch.clamp(kv_keep, max=pre.kfit).int()
    cache["act_len"] = torch.clamp(last_pos - kv_keep, max=act_cap).int()
    return logits, cache


def hybrid_page_table(kv_tokens, act_tokens, kv_cap: int, act_cap: int,
                      n_pages: int):
    """Compacted page tables of one decode step, built on the device.

    Request b's KV region is pages ``b*kv_cap/16 + j`` of the layer's KV pool
    and its ACT region pages ``b*act_cap/16 + j`` of the ACT pool (the ACT
    region, or for RoPE models the scratch pool of recomputed K/V, whose
    per-request stride is passed as ``act_cap``); its used KV pages come
    first, then its ACT pages, then empty entries.
    kv_tokens / act_tokens (B,): tokens each region holds, this step's new
    token included.  -> (page_table, page_type, page_ntok), int32 (B, n_pages).
    """
    dev = kv_tokens.device
    B = kv_tokens.shape[0]
    j = torch.arange(n_pages, device=dev)[None]
    b = torch.arange(B, device=dev)[:, None]
    kv_t, act_t = kv_tokens.long()[:, None], act_tokens.long()[:, None]
    n_kv = (kv_t + PAGE - 1) // PAGE
    ja = j - n_kv
    is_kv = j < n_kv
    is_act = ~is_kv & (ja * PAGE < act_t)
    table = torch.where(is_kv, b * (kv_cap // PAGE) + j,
                        torch.where(is_act, b * (act_cap // PAGE) + ja, 0))
    ptype = torch.where(is_kv, 0, torch.where(is_act, 1, 2))
    ntok = torch.where(is_kv, (kv_t - PAGE * j).clamp(0, PAGE),
                       torch.where(is_act, (act_t - PAGE * ja).clamp(0, PAGE), 0))
    return table.int(), ptype.int(), ntok.int()


class ActKV(NamedTuple):
    """Per-step inputs of the RoPE models' route, shared by every layer.

    sincos_new: (sin, cos) (B, 1, hd/2) at each request's new position.
    sin, cos: (N, 16, hd/2) float32 at the recorded ACT positions of the
    pages in ``page_index`` (N,) int32, the bounded prefix of each request's
    ACT region in the layer's pool.  k, v: (N, 16, KVH, hd), the scratch
    pool ``kv_gen`` writes and the second-pool attention reads."""
    sincos_new: Tuple[torch.Tensor, torch.Tensor]
    sin: torch.Tensor
    cos: torch.Tensor
    page_index: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor


def _layer_qkv(lp, cfg, h, act_kv: Optional[ActKV] = None):
    """The new token's q, k, v (B, 1, heads, D) from the layer input h
    (B, 1, d); q and k rotated at the new position for RoPE models."""
    q, k, v = T._qk(lp["attn"], cfg, L.apply_norm(h, lp["ln1"], cfg.norm_type))
    if act_kv is not None:
        q = L.apply_rope(q, *act_kv.sincos_new)
        k = L.apply_rope(k, *act_kv.sincos_new)
    return q, k, v


def _write_new(kc, vc, ac, k, v, act_in, kv_len, act_len, store_act):
    """Write the new token's K/V row (KV-bound) at ``kv_len`` of kc/vc
    (B, cap, KVH, D), or its checkpoint ``act_in`` (ACT-bound) at
    ``act_len`` of ac (B, act_cap, d), in place."""
    ar = torch.arange(kc.shape[0], device=kc.device)
    ki = kv_len.clamp(max=kc.shape[1] - 1).long()
    ai = act_len.clamp(max=ac.shape[1] - 1).long()
    to_act = store_act[:, None, None]
    kc[ar, ki] = torch.where(to_act, kc[ar, ki], k[:, 0])
    vc[ar, ki] = torch.where(to_act, vc[ar, ki], v[:, 0])
    ac[ar, ai] = torch.where(store_act[:, None], act_in.to(ac.dtype), ac[ar, ai])


def _hybrid_attend(lp, cfg, q, kc, vc, ac, tables,
                   act_kv: Optional[ActKV] = None, return_lse: bool = False):
    """The new token's attention over the typed page tables: KV pages of
    kc/vc (B, cap, KVH, D), ACT pages of ac (B, act_cap, d).  ``act_kv``
    given (RoPE models): ``kv_gen`` recomputes the ACT pages into the
    scratch pool and the second-pool kernel attends; else the fused kernel
    recomputes in its loop.  -> (B, KVH, G, D), and (m, l) with
    ``return_lse``."""
    B = q.shape[0]
    KVH, D, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    qg = q.reshape(B, KVH, cfg.num_heads // KVH, D)
    pools = (kc.view(-1, PAGE, KVH, D), vc.view(-1, PAGE, KVH, D))
    norm = (lp["ln1"]["scale"], lp["ln1"].get("bias"))
    wkv = (lp["attn"]["wk"].view(d, KVH, D), lp["attn"]["wv"].view(d, KVH, D))
    eps = L.NORM_EPS[cfg.norm_type]
    if act_kv is None:
        return hybrid_paged_attention(qg, *pools, ac.view(-1, PAGE, d), *norm,
                                      *wkv, *tables, norm_type=cfg.norm_type,
                                      eps=eps, return_lse=return_lse)
    if act_kv.page_index.numel():
        kv_gen(ac.view(-1, PAGE, d), *norm, *wkv,
               page_index=act_kv.page_index, sin=act_kv.sin,
               cos=act_kv.cos, norm_type=cfg.norm_type, eps=eps,
               out=(act_kv.k, act_kv.v))
    return hybrid_paged_attention_two_pool(qg, *pools, act_kv.k, act_kv.v,
                                           *tables, return_lse=return_lse)


def _layer_out(lp, cfg, h, o):
    """Output projection of the attention ``o`` and the FFN, both residual."""
    h = h + o.reshape(h.shape[0], 1, cfg.q_dim) @ lp["attn"]["wo"]
    return h + T.ffn_apply(lp["ffn"], cfg, L.apply_norm(h, lp["ln2"], cfg.norm_type))


def _hybrid_layer_step(lp, cfg, h, kc, vc, ac, kv_len, act_len, store_act,
                       tables, act_kv: Optional[ActKV] = None):
    """One hybrid KV/ACT attention layer at decode time.  kc/vc (B, kv_cap,
    KVH, D) and ac (B, act_cap, d) are this layer's regions, updated in place.

    The new token's K/V (KV-bound) or checkpoint (ACT-bound) is written into
    its region BEFORE the kernels run, so an ACT-bound token's K/V are
    recomputed from its own checkpoint — the same norm(h) @ wk that ``_qk``
    computed, rotated at the same position."""
    q, k, v = _layer_qkv(lp, cfg, h, act_kv)
    _write_new(kc, vc, ac, k, v, h[:, 0], kv_len, act_len, store_act)
    o = _hybrid_attend(lp, cfg, q, kc, vc, ac, tables, act_kv)
    return _layer_out(lp, cfg, h, o)


class DecodePlan(NamedTuple):
    """What every layer of one hybrid decode step shares: the embedded new
    token ``x`` (B, 1, d), the page tables, the RoPE route's inputs (None
    for learned positions), and the ACT side of the tables: the stride of a
    request's ACT entries in the pool they index (the ACT region, or the
    scratch pool) and the ACT tokens each request attends over."""
    x: torch.Tensor
    tables: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    act_kv: Optional[ActKV]
    act_stride: int
    act_read: torch.Tensor


def hybrid_decode_begin(params, cfg: ModelConfig, token, cache: Cache,
                        store_act, *, pages_bound=None,
                        act_pages_bound=None) -> DecodePlan:
    """Record the new token's ACT position, embed it, and build the step's
    page tables (and, for RoPE models, the ``kv_gen`` inputs) once for all
    layers.  Bounds as for ``hybrid_decode_step``."""
    B = token.shape[0]
    kv_cap, act_cap = cache["k"].shape[2], cache["act"].shape[2]
    kv_len, act_len = cache["kv_len"], cache["act_len"]
    ctx = kv_len + act_len                                     # absolute position
    ar = torch.arange(B, device=token.device)
    ai = act_len.clamp(max=act_cap - 1).long()
    # ACT tokens carry their recorded absolute positions (appends interleave)
    cache["act_pos"][ar, ai] = torch.where(store_act, ctx, cache["act_pos"][ar, ai])

    x = _embed_tokens(params, cfg, token)
    if cfg.pos_type == "learned":
        x = x + params["pos_embed"][ctx.long()][:, None]
    kv_new = kv_len + (~store_act).int()
    act_new = act_len + store_act.int()
    maxp = kv_cap // PAGE + act_cap // PAGE
    n_pages = maxp if pages_bound is None else min(int(pages_bound), maxp)
    act_kv, act_stride, act_read = None, act_cap, act_new
    if cfg.pos_type == "rope":
        n_act = act_cap // PAGE if act_pages_bound is None \
            else min(int(act_pages_bound), act_cap // PAGE)
        act_kv = _act_kv(cfg, cache, ctx, n_act)
        act_stride = n_act * PAGE        # ACT entries index the scratch pool
        # tokens past the bound have no recomputed K/V: attention drops them
        act_read = act_new.clamp(max=act_stride)
    tables = hybrid_page_table(kv_new, act_read, kv_cap, act_stride, n_pages)
    return DecodePlan(x, tables, act_kv, act_stride, act_read)


def hybrid_decode_end(params, cfg: ModelConfig, x, cache: Cache, store_act):
    """Final norm and logits of the step's last layer output; the lengths
    advance.  -> logits (B, 1, V)."""
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    cache["kv_len"] = cache["kv_len"] + (~store_act).int()
    cache["act_len"] = cache["act_len"] + store_act.int()
    return unembed(params, cfg, x)


def hybrid_decode_step(params, cfg: ModelConfig, token, cache: Cache,
                       store_act, *, pages_bound=None, act_pages_bound=None):
    """One generation step with the KV-Activation hybrid cache.

    store_act (B,) bool: whether this token's checkpoint goes to the ACT
    region (True) or its K/V to the KV region (False).
    pages_bound: bound on any request's used pages this step (the caller
    knows it from the store schedule); the page tables, and so the kernel's
    page loop, are that wide.  Default: every page of both regions.
    act_pages_bound (RoPE models): bound on any request's used ACT pages this
    step; ``kv_gen`` recomputes that many pages of each request, and none
    when it is 0.  Default: every ACT page.  A bound that is too small drops
    the ACT tokens past it from attention, as the reference's ``act_bound``
    does.
    -> (logits (B, 1, V), cache)."""
    plan = hybrid_decode_begin(params, cfg, token, cache, store_act,
                               pages_bound=pages_bound,
                               act_pages_bound=act_pages_bound)
    x = plan.x
    for i in range(cfg.num_layers):
        x = _hybrid_layer_step(layer_params(params, i), cfg, x, cache["k"][i],
                               cache["v"][i], cache["act"][i], cache["kv_len"],
                               cache["act_len"], store_act, plan.tables,
                               plan.act_kv)
    return hybrid_decode_end(params, cfg, x, cache, store_act), cache


def _act_kv(cfg, cache, ctx, n_act: int) -> ActKV:
    """The RoPE route's per-step inputs, computed once for all layers: RoPE
    at the new positions ``ctx`` and at the recorded positions of the first
    ``n_act`` ACT pages of each request, those pages' indices in a layer's
    pool, and the scratch pool."""
    B, act_cap = cache["act_pos"].shape
    dev, dt = ctx.device, cache["act"].dtype
    sin, cos = T._rope_for(cfg, cache["act_pos"][:, :n_act * PAGE])
    page_index = (torch.arange(B, dtype=torch.int32, device=dev)[:, None]
                  * (act_cap // PAGE)
                  + torch.arange(n_act, dtype=torch.int32, device=dev)[None])
    shape = (B * n_act, PAGE, cfg.num_kv_heads, cfg.head_dim)
    half = (B * n_act, PAGE, cfg.head_dim // 2)
    return ActKV(T._rope_for(cfg, ctx[:, None]), sin.reshape(half),
                 cos.reshape(half), page_index.reshape(-1),
                 torch.empty(shape, dtype=dt, device=dev),
                 torch.empty(shape, dtype=dt, device=dev))


def hybrid_decode_loop(params, cfg: ModelConfig, cur, cache: Cache,
                       store_sched, *, pages_bound=None, act_pages_bound=None):
    """Greedy generation over the hybrid cache, argmax on the device and no
    host sync inside the loop.

    cur:         (B,) int32 — first token to emit (argmax of prefill logits).
    store_sched: (n_steps, B) bool tensor — per-step store_act flags.
    -> (tokens (B, n_steps) int32, cache)."""
    toks = []
    for s in range(store_sched.shape[0]):
        toks.append(cur)
        lg, cache = hybrid_decode_step(params, cfg, cur[:, None], cache,
                                       store_sched[s], pages_bound=pages_bound,
                                       act_pages_bound=act_pages_bound)
        cur = lg[:, -1].argmax(-1).int()
    return _stack(toks, cur), cache
