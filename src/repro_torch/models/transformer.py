"""Parameter init and the per-layer forwards of five families:

  uniform   every layer attention + FFN: OPT (learned positions, tied
            embeddings), yi and minitron (RoPE, untied embeddings), the
            MoE models dbrx and grok (RoPE, an MoE FFN in every layer), and
            qwen2-vl (M-RoPE; patch embeddings before the text);
  windowed  gemma3: periods of ``window_period - 1`` sliding-window (local)
            layers and one global layer, then a tail of local layers; q/k
            norm, MQA, tied embeddings;
  ssm       mamba2: every layer a Mamba-2 SSD mixer, no FFN, no positions,
            tied embeddings;
  hybrid    jamba: periods of ``attn_period`` layers, one attention layer
            (NoPE) at ``attn_period // 2`` and SSD mixers elsewhere, every
            layer with an FFN, MoE where ``layer_is_moe`` says (jamba:
            every second layer), dense elsewhere;
  encdec    whisper: a bidirectional encoder over frame embeddings
            (``enc_pos``, ``enc_layers``, ``enc_norm``), and a causal
            decoder whose layers add cross attention (``ln_x``, ``xattn``)
            over the encoder's output.

Counterparts of ``repro.models.transformer``.  Parameters are a plain dict laid
out like the JAX pytree: layers stacked on dim 0 (``layers``; windowed:
``periods.local`` stacked (n_per, period - 1, ...), ``periods.global``
(n_per, ...) and ``tail``; hybrid: ``periods.attn`` (n_per, ...) and the
SSD layers with a dense and with an MoE FFN, ``periods.ssd_dense`` and
``periods.ssd_moe`` (n_per, n_j, ...), walked in ``hybrid_slots`` order),
weights stored ``(d_in, d_out)``.  Prefill
attention goes through the hand-written flash kernel's wrapper, the local
layers' through its sliding-window mode, the encoder's and the cross
attention through its non-causal mode; the SSD layers' prefill scan through
the ``ssd_scan`` kernel's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

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


#: what each path of the port serves (``check_supported``'s ``path``):
#: (families, frontends, q/k norm allowed).  The server takes the
#: engine's models.
_ENGINE = (("uniform",), ("none",), False)
_PLAIN = (("uniform", "windowed", "ssm", "encdec", "hybrid"),
          ("none", "audio_stub", "vision_stub"), True)
SERVES = {
    "plain": _PLAIN,
    "hybrid": (("uniform", "windowed"), ("none",), True),
    "engine": _ENGINE,
    "server": _ENGINE,
    # the training path trains the plain path's models
    "train": _PLAIN,
}
#: the position encodings of the models with attention (M-RoPE only with
#: the vision frontend, see ``check_supported``)
POS_TYPES = ("learned", "rope", "mrope")
#: the entry points of each path, as the refusal names them
PATH_NAMES = {"plain": "the plain path (prefill -> decode_loop)",
              "hybrid": "the hybrid model functions (hybrid_prefill -> "
                        "hybrid_decode_loop, init_hybrid_cache)",
              "engine": "the engine and the offload executor",
              "server": "the server (ContinuousBatchingServer)",
              "train": "the training path (apply_train, make_train_step)"}
#: what the port serves and trains, path by path, and why the serving
#: paths refuse the frontend models: every refusal carries it
SERVED = (
    "The port serves, on the plain path (prefill -> decode_loop): dense "
    "uniform-family and windowed-family decoders with learned or RoPE "
    "positions (q/k norm and windows with RoPE only), MoE in every layer of "
    "the uniform family, SSD stacks with no FFN and no positions, the "
    "hybrid family (jamba: SSD and NoPE attention layers, each with a dense "
    "or MoE FFN by layer), the encdec family (whisper: audio_stub frames, "
    "learned positions, cross-KV or cross-ACT) and vision_stub patches "
    "with M-RoPE (qwen2-vl).  On the "
    "hybrid model functions: the uniform and windowed families with no "
    "frontend, learned or RoPE positions (the reference's hybrid step "
    "rotates RoPE only, so it has no M-RoPE path; its hybrid KV/ACT "
    "functions and engine assert the uniform and windowed families, so "
    "the hybrid family has no KV/ACT path either).  On the engine and the "
    "offload executor, and on the server: the uniform family with no "
    "frontend and no q/k norm, learned or RoPE positions.  The serving "
    "paths refuse the encdec family because the reference's engine asserts "
    "the uniform family (an encoder checkpoint or cross K/V per request "
    "have no place in its block pools), and the vlm frontend because their "
    "batched prefill takes no patches.  The training path (apply_train, "
    "make_train_step) trains every family the plain path serves: the "
    "uniform family (dense, and MoE in every layer with its aux loss kept), "
    "the windowed family (sliding windows, q/k norm), the ssm family and the "
    "hybrid family (their SSD layers through the ssd_scan kernel's "
    "backward; jamba's MoE aux loss kept), the encdec family (the gradient "
    "flows through the cross attention into the encoder) and vision_stub "
    "patches with M-RoPE.")


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


def check_supported(cfg: ModelConfig, path: str = "plain") -> None:
    """Raise ``NotImplementedError`` unless ``path`` of the port serves
    ``cfg`` (``SERVES``; the message names the path and carries ``SERVED``,
    what every path serves).  Beyond each path's families, frontends and
    q/k norm: the ssm family is a stack of SSD mixers with no FFN and no
    positions; the hybrid family (plain path only) interleaves SSD mixers
    and NoPE attention, every layer with an FFN, dense or MoE by layer
    (``layer_is_moe``); every other model has an FFN, dense or (the uniform
    family) MoE in every layer; q/k norm and the windowed family take RoPE
    only, the route that recomputes K outside the fused kernel; the audio_stub
    frontend is the encdec family's, with learned positions and no q/k
    norm; the vision_stub frontend and M-RoPE go together (M-RoPE's
    positions are laid out on the patch grid)."""
    families, frontends, qk_norm = SERVES[path]
    fam = family(cfg)
    if fam == "ssm":
        ok = cfg.d_ff == 0 and cfg.pos_type == "none" \
            and cfg.ssm_state_size > 0 and cfg.moe_num_experts == 0 \
            and cfg.frontend == "none"
    elif fam == "hybrid":
        ok = cfg.d_ff > 0 and cfg.pos_type == "none" \
            and cfg.ssm_state_size > 0 and cfg.frontend == "none" \
            and not cfg.qk_norm
    else:
        moe = cfg.arch_type == "moe" and cfg.moe_num_experts > 0 \
            and cfg.moe_every == 1 and fam == "uniform"
        dense = cfg.arch_type in ("dense", "audio", "vlm") \
            and cfg.moe_num_experts == 0
        rope_only = cfg.qk_norm or fam == "windowed"
        audio = cfg.frontend == "audio_stub"
        vision = cfg.frontend == "vision_stub"
        ok = (moe or dense) and cfg.d_ff > 0 \
            and cfg.pos_type in POS_TYPES and cfg.frontend in frontends \
            and not (rope_only and cfg.pos_type != "rope") \
            and not (cfg.qk_norm and not qk_norm) \
            and audio == (fam == "encdec") \
            and not (audio and (cfg.pos_type != "learned" or cfg.qk_norm)) \
            and vision == (cfg.pos_type == "mrope") \
            and not (vision and cfg.frontend_tokens <= 0)
    if not (ok and fam in families):
        raise NotImplementedError(
            f"{cfg.name} ({fam} family, frontend {cfg.frontend}, "
            f"{cfg.pos_type} positions): not served by {PATH_NAMES[path]}.  "
            + SERVED)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters (the JAX pytree's keys: ``unembed`` when embeddings
    are untied, ``pos_embed`` for learned positions, ``w3`` for gated FFNs,
    an MoE FFN's ``router`` (float32) and ``we1``/``we2``/``we3``,
    ``qnorm``/``knorm`` with q/k norm; ``layers``, or for the windowed family
    ``periods`` and ``tail``, for the hybrid family ``periods`` (``attn``,
    ``ssd_dense``, ``ssd_moe``); the encdec family's ``enc_pos``,
    ``enc_layers`` and ``enc_norm``, and ``ln_x``/``xattn`` in each decoder
    layer), made on ``device`` from a seeded ``torch.Generator``."""
    check_supported(cfg)
    # the meta device (shapes only, ``launch.specs``) draws nothing
    gen = torch.Generator(device="cpu" if torch.device(device).type == "meta"
                          else device).manual_seed(seed)
    Lyr, d, qd, kvd, f = (cfg.num_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                          cfg.d_ff)
    V = pad_vocab(cfg.vocab_size)
    params = {"embed": _dense(gen, (V, d), cfg, device, scale=0.02),
              "final_norm": _norm_p(cfg, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = _dense(gen, (d, V), cfg, device)
    if cfg.pos_type == "learned":
        params["pos_embed"] = _dense(gen, (cfg.max_seq_len, d), cfg, device,
                                     scale=0.02)
    # the draw order is part of what a seed means: the optional leaves come
    # after the ones every model has, so adding them changes no other weight
    attn = lambda n: {"wq": _dense(gen, (d, qd), cfg, device, n=n),
                      "wk": _dense(gen, (d, kvd), cfg, device, n=n),
                      "wv": _dense(gen, (d, kvd), cfg, device, n=n),
                      "wo": _dense(gen, (qd, d), cfg, device, n=n,
                                   scale=1.0 / math.sqrt(qd)
                                   / math.sqrt(2 * Lyr))}

    def ffn(n, moe):
        f_scale = 1.0 / math.sqrt(f) / math.sqrt(2 * Lyr)
        return {"ln2": _norm_p(cfg, device, n),
                "ffn": (_moe_p if moe else _ffn_p)(gen, cfg, device, n,
                                                   f_scale)}

    def stack(n, cross=False, moe=cfg.is_moe):
        layers = {"ln1": _norm_p(cfg, device, n), "attn": attn(n),
                  **ffn(n, moe)}
        if cross:                          # the decoder's cross attention
            layers["ln_x"] = _norm_p(cfg, device, n)
            layers["xattn"] = attn(n)
        if cfg.qk_norm:
            for key in ("qnorm", "knorm"):
                layers["attn"][key] = torch.zeros((n, cfg.head_dim),
                                                  dtype=torch_dtype(cfg),
                                                  device=device)
        return layers

    # SSD layers: their mixer, then (hybrid family) the layer's FFN
    ssd = lambda n, moe: {"ln1": _norm_p(cfg, device, n),
                          "ssd": _ssd_p(gen, cfg, device, n),
                          **(ffn(n, moe) if f > 0 else {})}
    if family(cfg) == "ssm":
        params["layers"] = ssd(Lyr, False)
        return params
    if family(cfg) == "hybrid":
        slots = hybrid_slots(cfg)
        n_per = cfg.num_layers // cfg.attn_period
        attn_moe = next(m for name, _, m in slots if name == "attn")
        params["periods"] = {"attn": stack(n_per, moe=attn_moe)}
        for name, moe in (("ssd_dense", False), ("ssd_moe", True)):
            n = sum(s_ == name for s_, _, _ in slots)
            if n:
                params["periods"][name] = _map(
                    ssd(n_per * n, moe),
                    lambda t: t.view(n_per, n, *t.shape[1:]))
        return params
    if family(cfg) == "uniform":
        params["layers"] = stack(Lyr)
        return params
    if family(cfg) == "encdec":
        params["enc_pos"] = _dense(gen, (cfg.enc_seq_len, d), cfg, device,
                                   scale=0.02)
        params["enc_layers"] = stack(cfg.enc_num_layers)
        params["enc_norm"] = _norm_p(cfg, device)
        params["layers"] = stack(Lyr, cross=True)
        return params
    period, n_per, tail = _window_split(cfg)
    local = _map(stack(n_per * (period - 1)),
                 lambda t: t.view(n_per, period - 1, *t.shape[1:]))
    params["periods"] = {"local": local, "global": stack(n_per)}
    if tail:
        params["tail"] = stack(tail)
    return params


def _ffn_p(gen, cfg, device, n, out_scale):
    """``n`` stacked dense FFNs: ``w1`` and (gated) ``w3`` (d, f), ``w2``
    (f, d)."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"w1": _dense(gen, (d, f), cfg, device, n=n),
         "w2": _dense(gen, (f, d), cfg, device, scale=out_scale, n=n)}
    if cfg.ffn_type.startswith("gated"):
        p["w3"] = _dense(gen, (d, f), cfg, device, n=n)
    return p


def _moe_p(gen, cfg, device, n, out_scale):
    """``n`` stacked MoE FFNs (the reference's ``init_moe``): the router
    drawn in the config dtype and kept in float32, experts ``we1``/``we3``
    (E, d, f) and ``we2`` (E, f, d).  Each expert is drawn on its own, so
    the float32 scratch stays one expert's matrix large."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    experts = lambda shape, scale=None: _dense(
        gen, shape, cfg, device, scale=scale, n=n * E).view(n, E, *shape)
    p = {"router": _dense(gen, (d, E), cfg, device, n=n).float(),
         "we1": experts((d, f)),
         "we2": experts((f, d), out_scale)}
    if cfg.ffn_type.startswith("gated"):
        p["we3"] = experts((d, f))
    return p


def _ssd_p(gen, cfg, device, n):
    """``n`` stacked SSD mixers (the reference's ``init_ssd``): in_proj
    makes z, x, B, C and dt; x, B and C go through the depthwise conv."""
    d, inner = cfg.d_model, cfg.ssm_inner
    h, ns, w = cfg.ssm_num_heads, cfg.ssm_state_size, cfg.ssm_conv_width
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.linspace(1.0, 16.0, h, **f32).log()
    return {
        "in_proj": _dense(gen, (d, 2 * inner + 2 * ns + h), cfg, device, n=n),
        "conv_w": _dense(gen, (inner + 2 * ns, w), cfg, device,
                         scale=1.0 / math.sqrt(w), n=n),
        "A_log": a_log.expand(n, h).clone(),
        "D": torch.ones((n, h), **f32),
        "dt_bias": torch.zeros((n, h), **f32),
        "norm": torch.zeros((n, inner), dtype=torch_dtype(cfg), device=device),
        "out_proj": _dense(gen, (inner, d), cfg, device,
                           scale=1.0 / math.sqrt(inner)
                           / math.sqrt(2 * cfg.num_layers), n=n)}


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) \
        else fn(tree)


#: where each layer stack lives in the params: the uniform family's
#: ``layers`` (the encdec family's decoder layers); the windowed family's
#: local layers of each period, its global layers and its tail; the encdec
#: family's encoder layers
_STACKS = {"layers": ("layers",), "local": ("periods", "local"),
           "global": ("periods", "global"), "tail": ("tail",),
           "enc": ("enc_layers",), "attn": ("periods", "attn"),
           "ssd_dense": ("periods", "ssd_dense"),
           "ssd_moe": ("periods", "ssd_moe")}


def layer_params(params: Params, i: int, j: Optional[int] = None,
                 stack: str = "layers") -> Params:
    """Views of one layer's parameters (the stacked dims indexed away): layer
    ``i`` of ``stack``; for the windowed family, local layer ``j`` of period
    ``i`` (``"local"``), period ``i``'s global layer (``"global"``) or tail
    layer ``i`` (``"tail"``); for the encdec family, encoder layer ``i``
    (``"enc"``); for the hybrid family, period ``i``'s attention layer
    (``"attn"``) or its SSD layer ``j`` of ``"ssd_dense"`` or
    ``"ssd_moe"``."""
    tree = params
    for key in _STACKS[stack]:
        tree = tree[key]
    idx = i if j is None else (i, j)
    return _map(tree, lambda t: t[idx])


def unbind_layers(params: Params, stack: str = "layers") -> list:
    """Each layer's parameters of ``stack``, for a forward under autograd:
    every stacked leaf unbound once, so that the backward builds one
    gradient per stack (``layer_params``'s index would build a zero-filled
    gradient of the whole stack per layer, O(L^2) traffic)."""
    tree = params
    for key in _STACKS[stack]:
        tree = tree[key]
    return unbind_tree(tree)


def unbind_tree(tree) -> list:
    """A tree of stacked leaves -> one tree per index of their first dim
    (views, each leaf unbound once)."""
    if isinstance(tree, dict):
        parts = {k: unbind_tree(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


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


def hybrid_slots(cfg: ModelConfig) -> Tuple[Tuple[str, int, bool], ...]:
    """Walk order inside one hybrid period: (stack name, index in that
    stack, is_moe) per layer, the reference's ``hybrid_slots``."""
    period = cfg.attn_period
    kinds = cfg.layer_kinds()[:period]
    moe_flags = cfg.layer_is_moe()[:period]
    slots, nd, nm = [], 0, 0
    for j in range(period):
        if kinds[j] == "attn":
            slots.append(("attn", 0, moe_flags[j]))
        elif moe_flags[j]:
            slots.append(("ssd_moe", nm, True))
            nm += 1
        else:
            slots.append(("ssd_dense", nd, False))
            nd += 1
    return tuple(slots)


def hybrid_walk(cfg: ModelConfig) -> Iterator[
        Tuple[str, int, Optional[int], Optional[int], bool]]:
    """The hybrid family's layers in order, as (stack, period i, index j in
    the stack or None for attention, the SSD cache slot or None, is_moe).
    The SSD cache slots count each period's SSD layers in WALK order, as the
    reference's prefill reassembles its states (not in stack order: dense
    layers first, then MoE)."""
    slots = hybrid_slots(cfg)
    for i in range(cfg.num_layers // cfg.attn_period):
        si = 0
        for name, j, moe in slots:
            if name == "attn":
                yield name, i, None, None, moe
            else:
                yield name, i, j, si, moe
                si += 1


# =============================================================================
# block applications
# =============================================================================

def _rope_for(cfg: ModelConfig, positions):
    """-> (sin, cos) (..., S, head_dim/2) for RoPE models (positions
    (..., S)) and M-RoPE models (positions (B, S, 3)), else None."""
    if cfg.pos_type == "rope":
        return L.rope_sin_cos(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.pos_type == "mrope":
        return L.mrope_sin_cos(positions, cfg.head_dim, cfg.rope_theta)
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


def attn_full(p, cfg: ModelConfig, x, sincos=None, window: int = 0, *,
              causal: bool = True):
    """Full-sequence attention (prefill): causal, sliding-window when
    ``window`` > 0, or bidirectional with ``causal=False`` (the encoder);
    q and k rotated by ``sincos`` when given.  Returns (out, (k, v))."""
    q, k, v = _qk_roped(p, cfg, x, sincos)
    o = flash_attention(q, k, v, causal=causal, window=window)
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


def ffn_full(p, cfg: ModelConfig, x, is_moe: Optional[bool] = None):
    """The layer's FFN on x (B, S, d) -> (y, aux loss): dense (aux 0.0), or
    MoE, ``moe_ffn`` over the B·S tokens flattened row-major, as the
    reference flattens them, with its Switch aux loss (float32).  Which of
    the two is the layer's (``is_moe``, the reference's per-layer flag):
    by default MoE in every layer of an MoE config with ``moe_every`` 1,
    the uniform family's; the hybrid family passes each layer's."""
    if is_moe is None:
        is_moe = cfg.is_moe and cfg.moe_every == 1
    if is_moe:
        B, S, d = x.shape
        y, aux = L.moe_ffn(p, x.reshape(B * S, d),
                           num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor,
                           ffn_type=cfg.ffn_type)
        return y.reshape(B, S, d), aux
    return L.dense_ffn(p, x, cfg.ffn_type), 0.0


def ffn_apply(p, cfg: ModelConfig, x, is_moe: Optional[bool] = None):
    """``ffn_full`` without its aux loss (the serving paths)."""
    return ffn_full(p, cfg, x, is_moe)[0]


def _ssd_in(p, cfg, x, conv_cache):
    """The SSD mixer's input side: in_proj, the causal conv over x, B, C and
    its SiLU, softplus'ed dt.  -> (z, xs, Bc, Cc, dt, A, new conv cache);
    xs, Bc and Cc are slices of one tensor, passed on without a copy."""
    inner, ns = cfg.ssm_inner, cfg.ssm_state_size
    proj = x @ p["in_proj"]                                  # (B, S, 2i+2n+h)
    z, xbc, dt_raw = torch.split(proj, [inner, inner + 2 * ns,
                                        cfg.ssm_num_heads], dim=-1)
    xbc, new_conv = L.causal_conv1d(xbc, p["conv_w"], conv_cache)
    xbc = F.silu(xbc)
    xs, Bc, Cc = torch.split(xbc, [inner, ns, ns], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, xs, Bc, Cc, dt, A, new_conv


def _ssd_out(p, cfg, x, y, xs, z):
    """The skip term, the SiLU(z) gate, the gated RMSNorm and out_proj."""
    B, S = x.shape[:2]
    h, hp = cfg.ssm_num_heads, cfg.ssm_head_dim
    y = y + xs.reshape(B, S, h, hp) * p["D"][None, None, :, None]
    y = (y.reshape(B, S, cfg.ssm_inner) * F.silu(z)).to(x.dtype)
    return L.rms_norm(y, p["norm"]) @ p["out_proj"]


def ssd_full(p, cfg: ModelConfig, x):
    """The SSD mixer over the whole sequence (prefill), from a zero state.
    -> (out, (final state in the config dtype, conv cache))."""
    B, S, _ = x.shape
    z, xs, Bc, Cc, dt, A, new_conv = _ssd_in(p, cfg, x, None)
    y, final = L.ssd_chunked(
        xs.reshape(B, S, cfg.ssm_num_heads, cfg.ssm_head_dim), dt, A, Bc, Cc,
        chunk=cfg.ssm_chunk)
    return _ssd_out(p, cfg, x, y, xs, z), (final.to(torch_dtype(cfg)), new_conv)


def ssd_decode(p, cfg: ModelConfig, x, state, conv_cache):
    """One-token SSD step, x (B, 1, d).  -> (out, new state in the config
    dtype, new conv cache)."""
    B = x.shape[0]
    h, hp = cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xs, Bc, Cc, dt, A, new_conv = _ssd_in(p, cfg, x, conv_cache)
    y, new_state = L.ssd_decode_step(
        state.float(), xs[:, 0].reshape(B, h, hp), dt[:, 0], A,
        Bc[:, 0].reshape(B, 1, -1), Cc[:, 0].reshape(B, 1, -1))
    return (_ssd_out(p, cfg, x, y[:, None], xs, z),
            new_state.to(torch_dtype(cfg)), new_conv)


# --- single transformer layer (pre-norm residual) -----------------------------

def layer_full(p, cfg, x, sincos=None, window: int = 0, *, kind: str = "attn",
               causal: bool = True, aux: bool = False,
               is_moe: Optional[bool] = None):
    """-> (x', cache) over the whole sequence: attention's (k, v)
    (sliding-window when ``window`` > 0, bidirectional with
    ``causal=False``), or with ``kind="ssd"`` the SSD mixer's (final state,
    conv cache).  No FFN where the config has none; ``is_moe`` as
    ``ffn_full`` takes it.  ``aux=True`` (the training forward): -> (x',
    cache, the FFN's aux loss), the reference's triple."""
    h = L.apply_norm(x, p["ln1"], cfg.norm_type)
    if kind == "ssd":
        a, cache = ssd_full(p["ssd"], cfg, h)
    else:
        a, cache = attn_full(p["attn"], cfg, h, sincos, window, causal=causal)
    x = x + a
    a_loss = 0.0
    if cfg.d_ff > 0:
        f, a_loss = ffn_full(p["ffn"], cfg,
                             L.apply_norm(x, p["ln2"], cfg.norm_type), is_moe)
        x = x + f
    return (x, cache, a_loss) if aux else (x, cache)


def layer_decode(p, cfg, x, k_cache, v_cache, kv_len, sincos=None, *,
                 window: int = 0, ring: bool = False, kind: str = "attn",
                 is_moe: Optional[bool] = None):
    """-> x' for one token; the caches are updated in place (a ring buffer
    with ``ring``, see ``attn_decode``).  With ``kind="ssd"`` the two caches
    are the layer's SSD state (B, h, p, n) and conv cache (B, width - 1,
    inner + 2n), and ``kv_len`` is not read.  ``is_moe`` as ``ffn_full``
    takes it."""
    h = L.apply_norm(x, p["ln1"], cfg.norm_type)
    if kind == "ssd":
        a, state, conv = ssd_decode(p["ssd"], cfg, h, k_cache, v_cache)
        k_cache.copy_(state)
        v_cache.copy_(conv)
    else:
        a = attn_decode(p["attn"], cfg, h, k_cache, v_cache, kv_len, sincos,
                        window=window, ring=ring)
    x = x + a
    if cfg.d_ff > 0:
        x = x + ffn_apply(p["ffn"], cfg, L.apply_norm(x, p["ln2"], cfg.norm_type),
                          is_moe)
    return x
