"""Parameter init and the per-layer forwards of two families:

  uniform   every layer attention + FFN: OPT (learned positions, tied
            embeddings), yi and minitron (RoPE, untied embeddings);
  windowed  gemma3: periods of ``window_period - 1`` sliding-window (local)
            layers and one global layer, then a tail of local layers; q/k
            norm, MQA, tied embeddings.

Counterparts of ``repro.models.transformer``.  Parameters are a plain dict laid
out like the JAX pytree: layers stacked on dim 0 (``layers``; windowed:
``periods.local`` stacked (n_per, period - 1, ...), ``periods.global``
(n_per, ...) and ``tail``), weights stored ``(d_in, d_out)``.  Prefill
attention goes through the hand-written flash kernel's wrapper, the local
layers' through its sliding-window mode.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L

Params = Dict[str, Any]


def pad_vocab(v: int, multiple: int = 256) -> int:
    return (v + multiple - 1) // multiple * multiple


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# =============================================================================
# parameter init (same distributions and scales as the JAX package; the
# numbers differ, since torch.Generator is not jax.random)
# =============================================================================

def _dense(gen, shape, cfg, device, scale=None, n=None):
    """Normal(0, scale or 1/sqrt(fan_in)) in the config dtype; ``n`` stacks
    n independent draws on dim 0, drawn one at a time so the float32
    scratch stays one slice large."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.empty(((n,) if n else ()) + tuple(shape),
                      dtype=torch_dtype(cfg), device=device)
    for i in range(n or 1):
        draw = torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std)
        (out[i] if n else out).copy_(draw)
    return out


def _norm_p(cfg, device, n=None):
    shape = ((n,) if n else ()) + (cfg.d_model,)
    dt = torch_dtype(cfg)
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=dt, device=device)}
    return {"scale": torch.ones(shape, dtype=dt, device=device),
            "bias": torch.zeros(shape, dtype=dt, device=device)}


#: position encodings the port serves
POS_TYPES = ("learned", "rope")
#: the architecture families the port serves (``family``)
FAMILIES = ("uniform", "windowed")


def family(cfg: ModelConfig) -> str:
    if cfg.is_encoder_decoder:
        return "encdec"
    if cfg.arch_type == "ssm":
        return "ssm"
    if cfg.is_hybrid:
        return "hybrid"
    if cfg.window_period > 0:
        return "windowed"
    return "uniform"


def _window_split(cfg) -> Tuple[int, int, int]:
    period = cfg.window_period
    n_per = cfg.num_layers // period
    tail = cfg.num_layers - n_per * period
    return period, n_per, tail


def check_supported(cfg: ModelConfig, families=FAMILIES,
                    qk_norm: bool = True) -> None:
    """Raise unless the port serves ``cfg`` in one of ``families``: a dense
    decoder (no MoE, SSM, encoder or frontend) with an FFN, learned or RoPE
    positions; q/k norm (where ``qk_norm`` allows it) and the windowed
    family only with RoPE, the route that recomputes K outside the fused
    kernel.  The serving engine and the offload executor take the uniform
    family without q/k norm, as far as the reference's engine is held
    against."""
    dense = (cfg.arch_type == "dense" and not cfg.is_encoder_decoder
             and cfg.moe_num_experts == 0 and cfg.frontend == "none")
    rope_only = cfg.qk_norm or family(cfg) == "windowed"
    if not dense or family(cfg) not in families or cfg.d_ff == 0 \
            or cfg.pos_type not in POS_TYPES \
            or (rope_only and cfg.pos_type != "rope") \
            or (cfg.qk_norm and not qk_norm):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense "
            f"{' and '.join(f + '-family' for f in families)} decoders with "
            f"{' or '.join(POS_TYPES)} positions"
            + (" (q/k norm and windows with RoPE only)" if qk_norm
               else " and no q/k norm"))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters (the JAX pytree's keys: ``unembed`` when embeddings
    are untied, ``pos_embed`` for learned positions, ``w3`` for gated FFNs,
    ``qnorm``/``knorm`` with q/k norm; ``layers``, or for the windowed family
    ``periods`` and ``tail``), made on ``device`` from a seeded
    ``torch.Generator``."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    Lyr, d, qd, kvd, f = (cfg.num_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                          cfg.d_ff)
    V = pad_vocab(cfg.vocab_size)
    o_scale = 1.0 / math.sqrt(qd) / math.sqrt(2 * Lyr)
    f_scale = 1.0 / math.sqrt(f) / math.sqrt(2 * Lyr)
    params = {"embed": _dense(gen, (V, d), cfg, device, scale=0.02),
              "final_norm": _norm_p(cfg, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = _dense(gen, (d, V), cfg, device)
    if cfg.pos_type == "learned":
        params["pos_embed"] = _dense(gen, (cfg.max_seq_len, d), cfg, device,
                                     scale=0.02)
    # the draw order is part of what a seed means: the optional leaves come
    # after the ones every model has, so adding them changes no other weight
    def stack(n):
        layers = {
            "ln1": _norm_p(cfg, device, n),
            "attn": {"wq": _dense(gen, (d, qd), cfg, device, n=n),
                     "wk": _dense(gen, (d, kvd), cfg, device, n=n),
                     "wv": _dense(gen, (d, kvd), cfg, device, n=n),
                     "wo": _dense(gen, (qd, d), cfg, device, scale=o_scale, n=n)},
            "ln2": _norm_p(cfg, device, n),
            "ffn": {"w1": _dense(gen, (d, f), cfg, device, n=n),
                    "w2": _dense(gen, (f, d), cfg, device, scale=f_scale, n=n)},
        }
        if cfg.ffn_type.startswith("gated"):
            layers["ffn"]["w3"] = _dense(gen, (d, f), cfg, device, n=n)
        if cfg.qk_norm:
            for key in ("qnorm", "knorm"):
                layers["attn"][key] = torch.zeros((n, cfg.head_dim),
                                                  dtype=torch_dtype(cfg),
                                                  device=device)
        return layers

    if family(cfg) == "uniform":
        params["layers"] = stack(Lyr)
        return params
    period, n_per, tail = _window_split(cfg)
    local = _map(stack(n_per * (period - 1)),
                 lambda t: t.view(n_per, period - 1, *t.shape[1:]))
    params["periods"] = {"local": local, "global": stack(n_per)}
    if tail:
        params["tail"] = stack(tail)
    return params


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) \
        else fn(tree)


#: where each layer stack lives in the params: the uniform family's
#: ``layers``; the windowed family's local layers of each period, its
#: global layers and its tail
_STACKS = {"layers": ("layers",), "local": ("periods", "local"),
           "global": ("periods", "global"), "tail": ("tail",)}


def layer_params(params: Params, i: int, j: Optional[int] = None,
                 stack: str = "layers") -> Params:
    """Views of one layer's parameters (the stacked dims indexed away): layer
    ``i`` of ``stack``; for the windowed family, local layer ``j`` of period
    ``i`` (``"local"``), period ``i``'s global layer (``"global"``) or tail
    layer ``i`` (``"tail"``)."""
    tree = params
    for key in _STACKS[stack]:
        tree = tree[key]
    idx = i if j is None else (i, j)
    return _map(tree, lambda t: t[idx])


def window_walk(cfg: ModelConfig) -> Iterator[Tuple[str, int, Optional[int]]]:
    """The windowed family's layers in order, as ``layer_params``'s
    (stack, i, j): each period's local layers, then its global layer, then
    the tail's local layers."""
    period, n_per, tail = _window_split(cfg)
    for p in range(n_per):
        for j in range(period - 1):
            yield "local", p, j
        yield "global", p, None
    for i in range(tail):
        yield "tail", i, None


# =============================================================================
# block applications
# =============================================================================

def _rope_for(cfg: ModelConfig, positions):
    """-> (sin, cos) (..., S, head_dim/2) for RoPE models, else None."""
    if cfg.pos_type == "rope":
        return L.rope_sin_cos(positions, cfg.head_dim, cfg.rope_theta)
    return None


def _qk(p, cfg, x):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["qnorm"])
        k = L.rms_norm(k, p["knorm"])
    return q, k, v


def _qk_roped(p, cfg, x, sincos):
    q, k, v = _qk(p, cfg, x)
    if sincos is not None:
        q, k = L.apply_rope(q, *sincos), L.apply_rope(k, *sincos)
    return q, k, v


def attn_full(p, cfg: ModelConfig, x, sincos=None, window: int = 0):
    """Causal full-sequence attention (prefill), sliding-window when
    ``window`` > 0; q and k rotated by ``sincos`` when given.
    Returns (out, (k, v))."""
    q, k, v = _qk_roped(p, cfg, x, sincos)
    o = flash_attention(q, k, v, window=window)
    return o.reshape(x.shape[0], x.shape[1], cfg.q_dim) @ p["wo"], (k, v)


def attn_decode(p, cfg: ModelConfig, x, k_cache, v_cache, kv_len, sincos=None,
                *, window: int = 0, ring: bool = False):
    """One-token attention against a cache (B, S, KVH, D).  The new token's
    K/V (k rotated by ``sincos`` when given) are written in place at
    ``kv_len``, then attended.  ``ring=True`` treats the cache as a ring
    buffer of S slots (the sliding-window layers): the token goes to slot
    ``kv_len % S`` and attends over the slots whose positions lie in its
    ``window``."""
    B = x.shape[0]
    q, k, v = _qk_roped(p, cfg, x, sincos)
    S = k_cache.shape[1]
    slot = (kv_len % S if ring else kv_len).long()
    ar = torch.arange(B, device=x.device)
    k_cache[ar, slot] = k[:, 0]
    v_cache[ar, slot] = v[:, 0]
    if ring:
        # position held by slot j: the largest p <= kv_len with p % S == j
        n = kv_len.long()[:, None]
        pos = n - (n - torch.arange(S, device=x.device)[None]) % S
        valid = (pos >= 0) & (pos >= n + 1 - window)
        o = _masked_decode_attn(q, k_cache, v_cache, valid)
    else:
        o = L.decode_attention(q, k_cache, v_cache, kv_len=kv_len + 1)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"]


def _masked_decode_attn(q, k_cache, v_cache, valid):
    """q (B, 1, H, D) against every cache slot (B, S, KVH, D) that ``valid``
    (B, S) marks; float32 softmax."""
    B, _, H, D = q.shape
    KVH = k_cache.shape[2]
    G = H // KVH
    qr = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float()) / math.sqrt(D)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def ffn_apply(p, cfg: ModelConfig, x):
    return L.dense_ffn(p, x, cfg.ffn_type)


# --- single transformer layer (pre-norm residual) -----------------------------

def layer_full(p, cfg, x, sincos=None, window: int = 0):
    """-> (x', (k, v)) over the whole sequence (sliding-window attention
    when ``window`` > 0)."""
    a, kv = attn_full(p["attn"], cfg, L.apply_norm(x, p["ln1"], cfg.norm_type),
                      sincos, window)
    x = x + a
    return x + ffn_apply(p["ffn"], cfg, L.apply_norm(x, p["ln2"], cfg.norm_type)), kv


def layer_decode(p, cfg, x, k_cache, v_cache, kv_len, sincos=None, *,
                 window: int = 0, ring: bool = False):
    """-> x' for one token; the caches are updated in place (a ring buffer
    with ``ring``, see ``attn_decode``)."""
    h = L.apply_norm(x, p["ln1"], cfg.norm_type)
    x = x + attn_decode(p["attn"], cfg, h, k_cache, v_cache, kv_len, sincos,
                        window=window, ring=ring)
    return x + ffn_apply(p["ffn"], cfg, L.apply_norm(x, p["ln2"], cfg.norm_type))
