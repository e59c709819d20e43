"""Parameter init and the per-layer forwards of the uniform family (every
layer attention + FFN): OPT (learned positions, tied embeddings), yi and
minitron (RoPE, untied embeddings).

Counterparts of ``repro.models.transformer``.  Parameters are a plain dict laid
out like the JAX pytree: layers stacked on dim 0, weights stored
``(d_in, d_out)``.  Prefill attention goes through the hand-written flash
kernel's wrapper.
"""
from __future__ import annotations

import math
from typing import Any, Dict

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


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless the port serves ``cfg``: a dense decoder of the uniform
    family (no MoE, windows, SSM, encoder or frontend) with an FFN, learned
    or RoPE positions, and no q/k norm."""
    uniform = (cfg.arch_type == "dense" and not cfg.is_encoder_decoder
               and cfg.window_period == 0 and cfg.moe_num_experts == 0
               and cfg.frontend == "none")
    if not uniform or cfg.d_ff == 0 or cfg.pos_type not in POS_TYPES \
            or cfg.qk_norm:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense uniform-family decoders with "
            f"{' or '.join(POS_TYPES)} positions and no q/k norm")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters of a uniform-family model (the JAX pytree's keys:
    ``unembed`` when embeddings are untied, ``pos_embed`` for learned
    positions, ``w3`` for gated FFNs), made on ``device`` from a seeded
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
    layers = {
        "ln1": _norm_p(cfg, device, Lyr),
        "attn": {"wq": _dense(gen, (d, qd), cfg, device, n=Lyr),
                 "wk": _dense(gen, (d, kvd), cfg, device, n=Lyr),
                 "wv": _dense(gen, (d, kvd), cfg, device, n=Lyr),
                 "wo": _dense(gen, (qd, d), cfg, device, scale=o_scale, n=Lyr)},
        "ln2": _norm_p(cfg, device, Lyr),
        "ffn": {"w1": _dense(gen, (d, f), cfg, device, n=Lyr),
                "w2": _dense(gen, (f, d), cfg, device, scale=f_scale, n=Lyr)},
    }
    if cfg.ffn_type.startswith("gated"):
        layers["ffn"]["w3"] = _dense(gen, (d, f), cfg, device, n=Lyr)
    params["layers"] = layers
    return params


def layer_params(params: Params, i: int) -> Params:
    """Views of layer ``i``'s parameters (the stacked dim indexed away)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["layers"])


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
    return q, k, v


def _qk_roped(p, cfg, x, sincos):
    q, k, v = _qk(p, cfg, x)
    if sincos is not None:
        q, k = L.apply_rope(q, *sincos), L.apply_rope(k, *sincos)
    return q, k, v


def attn_full(p, cfg: ModelConfig, x, sincos=None):
    """Causal full-sequence attention (prefill); q and k rotated by
    ``sincos`` when given. Returns (out, (k, v))."""
    q, k, v = _qk_roped(p, cfg, x, sincos)
    o = flash_attention(q, k, v)
    return o.reshape(x.shape[0], x.shape[1], cfg.q_dim) @ p["wo"], (k, v)


def attn_decode(p, cfg: ModelConfig, x, k_cache, v_cache, kv_len, sincos=None):
    """One-token attention against a cache (B, S, KVH, D).  The new token's
    K/V (k rotated by ``sincos`` when given) are written in place at
    ``kv_len``, then attended."""
    B = x.shape[0]
    q, k, v = _qk_roped(p, cfg, x, sincos)
    ar = torch.arange(B, device=x.device)
    k_cache[ar, kv_len.long()] = k[:, 0]
    v_cache[ar, kv_len.long()] = v[:, 0]
    o = L.decode_attention(q, k_cache, v_cache, kv_len=kv_len + 1)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"]


def ffn_apply(p, cfg: ModelConfig, x):
    return L.dense_ffn(p, x, cfg.ffn_type)


# --- single transformer layer (pre-norm residual) -----------------------------

def layer_full(p, cfg, x, sincos=None):
    """-> (x', (k, v)) over the whole sequence."""
    a, kv = attn_full(p["attn"], cfg, L.apply_norm(x, p["ln1"], cfg.norm_type),
                      sincos)
    x = x + a
    return x + ffn_apply(p["ffn"], cfg, L.apply_norm(x, p["ln2"], cfg.norm_type)), kv


def layer_decode(p, cfg, x, k_cache, v_cache, kv_len, sincos=None):
    """-> x' for one token; the caches are updated in place."""
    h = L.apply_norm(x, p["ln1"], cfg.norm_type)
    x = x + attn_decode(p["attn"], cfg, h, k_cache, v_cache, kv_len, sincos)
    return x + ffn_apply(p["ffn"], cfg, L.apply_norm(x, p["ln2"], cfg.norm_type))
