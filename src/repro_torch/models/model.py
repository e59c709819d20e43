"""Top-level model API of the uniform, windowed, ssm, hybrid and encdec
families:
embed -> layers -> logits, the plain decode path (the oracle's) and the
hybrid KV/ACT decode path (the engine's), and for every family the training
forward and loss (``forward_hidden`` -> ``lm_loss``, ``apply_train``).
Counterparts of ``repro.models.model``.

The encdec family (whisper) and the vision frontend (qwen2-vl, M-RoPE) have
the plain path only, as in the reference, whose engine asserts the uniform
family.  whisper's ``prefill`` encodes the frames (bidirectional layers,
the flash kernel's non-causal mode), then runs the decoder, whose cross
attention over the encoder's frames is the same mode with Sk = F.  Its
cache holds the decoder's self K/V and, per layer, cross K/V (cross-KV,
``init_cache``), or (``cross_act=True``, ``cache_spec_cross_act``) one
activation checkpoint of the encoder, 2·L·KVH·D/d = 12× fewer bytes: the
paper's Eq. 7 applied to cross attention.  The checkpoint is the encoder's
last residual BEFORE ``enc_norm``, padded to whole 16-token pages, and each
decode step recomputes every layer's cross K/V from it in one launch of the
fused ``hybrid_paged_attention`` (its norm prologue applies ``enc_norm``,
its projection the layer's ``xattn.wk``/``wv``), over tables of ACT pages
only.  The values attended are the reference's, which stores
``enc_norm(enc)`` rounded to the cache dtype and projects it: the kernel
rounds the normed row to the cache dtype before projecting.  The cross-KV
mode is the oracle and attends in plain torch (``L.decode_attention``).
qwen2-vl's patch embeddings go before the text, and its three position
streams (``mrope_positions``) rotate q and k in every layer.

The ssm family (mamba2) has no KV cache to trade for activations, so it has
the plain path only, as in the reference: ``prefill`` runs each SSD layer's
scan through the ``ssd_scan`` kernel and keeps its final state and conv
tail; ``decode_step`` advances both one token in plain torch.

The hybrid family (jamba: SSD layers and one NoPE attention layer per
period, each layer's FFN dense or MoE by ``layer_is_moe``) has the plain
path only too: the reference's hybrid KV/ACT functions and engine assert
the uniform and windowed families.  ``prefill`` walks each period's slots
in ``T.hybrid_walk`` order, the attention layer on the flash kernel
(causal, no rotation) and the SSD layers on ``ssd_scan``; its cache holds
the attention layers' K/V (``attn_k/v``) and each SSD layer's state and
conv tail in walk order (``state``/``conv`` (n_per, n_ssd, ...)), as the
reference's prefill reassembles them.  ``decode_step`` attends over
``attn_k/v`` and advances the SSD slots in plain torch.

The windowed family (gemma3) keeps the hybrid cache on its GLOBAL layers
only; its local layers keep ring buffers of ``sliding_window`` slots, as the
reference does (DESIGN.md §7).  On the card a ring reshapes without a copy
into W/16 KV pages per request, and the second-pool kernel attends over them
with no ACT page: the ring's live slots are always its prefix
``[0, min(ctx + 1, W))``, so ``page_ntok`` masks it.

The hybrid decode takes one of two kernel routes per model.  Learned-position
models (OPT) run the fused ``hybrid_paged_attention``, which recomputes each
ACT page's K/V in the same call that attends over them.  RoPE models (yi,
minitron) first recompute the ACT region's bounded prefix with ``kv_gen``
(norm, projection, and K rotated at each ACT token's recorded position) into
a per-step scratch pool, then run ``hybrid_paged_attention_two_pool`` over
the KV pages and that pool: the fused projection cannot rotate K.

JAX's functions are pure and the JAX engine donates the cache into its decode
loop; here the cache tensors are updated in place instead, and each function
returns the (same) cache dict for symmetry with the reference.

Quantized cache (``quant=QuantConfig()``): the reference fake-quantizes every
cache write and keeps the regions in the model dtype; here the regions hold
what that stands for, int8 codes with float16 scale sidecars (``k_s``,
``v_s`` per (token, head), ``act_s`` per token), and the kernels' int8 modes
dequantize them on the tile.  As in the reference, an ACT-bound token
attends to its own EXACT K/V on the step it is produced (only its checkpoint
is stored quantized), while a KV-bound token's row is read back dequantized.
The fused route leaves that token's ACT row out of the kernel's tables and
folds its exact (k, v) into the kernel's ``return_lse`` partial; the RoPE
route writes the exact rotated (k, v) into the token's row of the scratch
pool after ``kv_gen``, the reference's ``ka.at[act_len].set(k)``.  A step
whose schedule binds no token to the ACT region (every step in kv mode)
needs neither: the caller says so (``any_act``) from its host schedule.

The int8 format lives here: ``kv_planes`` names a cache's KV planes in
storage order (the offload arena's too), ``plane_scales`` makes a layer's
scale operands of them, and ``_encode`` is every region write's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.hybrid_attention.ops import (
    hybrid_paged_attention, hybrid_paged_attention_two_pool)
from repro_torch.kernels.hybrid_attention.ref import (NEG_INF,
                                                      merge_partials_torch)
from repro_torch.kernels.kv_gen.ops import kv_gen
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.quant_ops import check_supported, quantize
from repro_torch.models.transformer import (_window_split, family,  # noqa: F401 (re-export)
                                            init_params, layer_params,
                                            pad_vocab, torch_dtype,
                                            window_walk)

Params = Dict[str, Any]
Cache = Dict[str, Any]
PAGE = 16


# =============================================================================
# embedding / unembedding
# =============================================================================

def _embed_tokens(params, cfg, tokens):
    return params["embed"][tokens.long()]


def embed_input(params, cfg: ModelConfig, tokens=None, offset: int = 0, *,
                frames=None, patches=None):
    """tokens (B, S) -> x (B, S, d); learned positions offset..offset+S are
    added here, RoPE is applied inside attention.  Frontends, as the
    reference's ``embed_input``: ``patches`` (B, P, d) go before the
    embedded tokens (vision_stub; required there); ``frames`` (B, F, d)
    without tokens are the input itself (audio_stub; the encoder adds its
    own ``enc_pos`` in ``_encdec_encode`` instead)."""
    if cfg.frontend == "vision_stub":
        if patches is None:
            raise ValueError(f"{cfg.name}: the vision frontend needs patches")
        tok = _embed_tokens(params, cfg, tokens)
        x = torch.cat([patches.to(tok.dtype), tok], 1)
    elif cfg.frontend == "audio_stub" and frames is not None and tokens is None:
        x = frames
    else:
        x = _embed_tokens(params, cfg, tokens)
    if cfg.pos_type == "learned":
        x = x + params["pos_embed"][offset: offset + x.shape[1]][None]
    return x


def _positions(S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None]


def mrope_grid(cfg: ModelConfig) -> Tuple[int, int]:
    """(grid width, t0) of the M-RoPE layout: the P patches sit on a grid
    of that width at temporal position 0, and the text's three streams run
    equal from t0 (the reference's ``_positions_for``)."""
    P = cfg.frontend_tokens
    gw = max(1, math.isqrt(max(P, 1)))
    return gw, max(gw, P // gw)


def mrope_positions(cfg: ModelConfig, B: int, S: int, device):
    """(B, S, 3) int32 (temporal, height, width) ids of P patches and S - P
    text tokens: patch i at (0, i // gw, i % gw), text token j at t0 + j
    in all three streams."""
    P = cfg.frontend_tokens
    gw, t0 = mrope_grid(cfg)
    ids = np.arange(P)
    txt = t0 + np.arange(S - P)
    pos3 = np.stack([np.concatenate([np.zeros_like(ids), txt]),
                     np.concatenate([ids // gw, txt]),
                     np.concatenate([ids % gw, txt])], -1)
    pos3 = torch.from_numpy(pos3.astype(np.int32)).to(device)
    return pos3[None].expand(B, S, 3)


def _sincos_at(cfg: ModelConfig, B: int, S: int, device):
    """RoPE or M-RoPE tables of a whole sequence from position 0 (None for
    learned positions)."""
    if cfg.pos_type == "mrope":
        return T._rope_for(cfg, mrope_positions(cfg, B, S, device))
    return T._rope_for(cfg, _positions(S, device))


def unembed(params, cfg: ModelConfig, h):
    """Tied or untied embeddings; logits in float32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (h @ w.to(h.dtype)).float()


# =============================================================================
# training: full-sequence forward, loss (every family)
# =============================================================================

def _run(fn, remat: bool, *args, **kw):
    """``fn(*args, **kw)``, checkpointed with ``remat``
    (``torch.utils.checkpoint``, non-reentrant): the counterpart of
    ``_scan_layers``'s ``jax.checkpoint``, the backward recomputes the
    layer from its inputs."""
    return checkpoint(fn, *args, use_reentrant=False, **kw) if remat \
        else fn(*args, **kw)


def _train_layers(params, cfg: ModelConfig) -> list:
    """(layer params, window, kind, is_moe) of each decoder layer in the
    forward's order, each stack's leaves unbound once (``T.unbind_layers``):
    the uniform family's layers at window 0 (``is_moe`` None: the config's
    default); the windowed family's in ``window_walk`` order, its local and
    tail layers at ``sliding_window``, its global layers at 0; the ssm
    family's layers as SSD mixers (``kind="ssd"``, no FFN); the hybrid
    family's in ``T.hybrid_walk`` order, its attention slot at window 0,
    each layer's FFN dense or MoE as the walk gives it."""
    fam = family(cfg)
    if fam == "ssm":
        return [(lp, 0, "ssd", False) for lp in T.unbind_layers(params)]
    if fam == "hybrid":
        stacks = {"attn": T.unbind_layers(params, "attn")}
        for name in ("ssd_dense", "ssd_moe"):
            if name in params["periods"]:
                stacks[name] = [T.unbind_tree(p)
                                for p in T.unbind_layers(params, name)]
        return [(stacks[s][i] if j is None else stacks[s][i][j], 0,
                 "attn" if j is None else "ssd", moe)
                for s, i, j, _, moe in T.hybrid_walk(cfg)]
    if fam != "windowed":
        return [(lp, 0, "attn", None) for lp in T.unbind_layers(params)]
    W = cfg.sliding_window
    stacks = {"local": [T.unbind_tree(p)
                        for p in T.unbind_layers(params, "local")],
              "global": T.unbind_layers(params, "global"),
              "tail": T.unbind_layers(params, "tail") if "tail" in params
              else []}
    return [(stacks[s][i] if j is None else stacks[s][i][j],
             0 if s == "global" else W, "attn", None)
            for s, i, j in window_walk(cfg)]


def _decoder_layer(lp, cfg: ModelConfig, h, enc_out):
    """An encdec decoder layer over h (B, S, d): causal self attention, then
    cross attention over the encoder's output (flash, non-causal, Sk = F),
    then the FFN.  -> (h', self (k, v), cross (k, v))."""
    a, kv = T.attn_full(lp["attn"], cfg,
                        L.apply_norm(h, lp["ln1"], cfg.norm_type))
    h = h + a
    ek, ev = _cross_kv(lp, cfg, enc_out)
    o = T.flash_attention(_cross_q(lp, cfg, h), ek, ev, causal=False)
    return _cross_out(lp, cfg, h, o), kv, (ek, ev)


def forward_hidden(params, cfg: ModelConfig, batch, *, remat: bool = False):
    """Full-sequence forward of ``batch`` -> (hidden after the final norm,
    the layers' summed MoE aux loss).  ``batch["tokens"]`` (B, S); the
    vision frontend's ``batch["patches"]`` (B, P, d) go before the tokens
    (the hidden rows then are P + S, M-RoPE over them); the encdec family's
    ``batch["frames"]`` (B, F, d) feed the encoder, whose output (after
    ``enc_norm``) every decoder layer's cross attention reads.  The windowed
    family runs its layers in ``window_walk`` order, local ones at its
    sliding window; the ssm family's are SSD mixers; the hybrid family's
    run in ``T.hybrid_walk`` order, SSD mixers and NoPE attention, each
    layer's FFN dense or MoE, its aux loss summed as the reference's
    ``_hybrid_full`` sums it.  Each layer runs on its own unbound parameters
    (``T.unbind_layers``); ``remat`` checkpoints every layer of every stack,
    the encoder's too.  On the card the attention is the flash kernel in
    its mode (causal, window, non-causal) with its hand-written backward,
    and the SSD scan the ``ssd_scan`` kernel with its own."""
    T.check_supported(cfg, "train")
    if family(cfg) == "encdec":
        pre = _encdec_encode(params, cfg, batch["frames"], remat)
        enc_out = L.apply_norm(pre, params["enc_norm"], cfg.norm_type)
        x = embed_input(params, cfg, batch["tokens"])
        for lp in T.unbind_layers(params):
            x = _run(_decoder_layer, remat, lp, cfg, x, enc_out)[0]
        return L.apply_norm(x, params["final_norm"], cfg.norm_type), 0.0
    x = embed_input(params, cfg, batch["tokens"], patches=batch.get("patches"))
    B, S = x.shape[:2]
    sincos = _sincos_at(cfg, B, S, x.device)
    aux = 0.0
    for lp, window, kind, is_moe in _train_layers(params, cfg):
        x, _, a = _run(T.layer_full, remat, lp, cfg, x, sincos, window,
                       kind=kind, aux=True, is_moe=is_moe)
        aux = aux + a
    return L.apply_norm(x, params["final_norm"], cfg.norm_type), aux


def apply_logits(params, cfg: ModelConfig, batch, remat: bool = False):
    """-> (logits (B, S, V padded) float32, aux loss)."""
    h, aux = forward_hidden(params, cfg, batch, remat=remat)
    return unembed(params, cfg, h), aux


def _ce_chunk(hc, lab, w):
    """One chunk's summed cross entropy over its labelled positions, and
    their count.  The logsumexp runs over the padded vocab, as the
    reference's does; the label's logit is a gather, where the reference
    takes a one-hot product (the same value: one logit plus zeros)."""
    logits = (hc @ w.to(hc.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, lab.clamp_min(0).long()[..., None])[..., 0]
    mask = (lab >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def lm_loss(params, cfg: ModelConfig, h, labels, *, chunk: int = 512):
    """Sequence-chunked mean cross entropy of h (B, S, d) against labels
    (B, S); -1 labels are masked.  Each chunk's logits (B, chunk, V) exist
    only inside its body, which is checkpointed (recomputed in the
    backward), so the peak holds one chunk's logits."""
    B, S, _ = h.shape
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = cnt = 0.0
    for i in range(0, S + pad, chunk):
        t, c = checkpoint(_ce_chunk, h[:, i:i + chunk], labels[:, i:i + chunk],
                          w, use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def apply_train(params, cfg: ModelConfig, batch, remat: bool = True):
    """-> (loss, metrics): cross entropy over ``batch["labels"]`` (-1 is
    masked) plus ``moe_aux_loss_weight`` times the MoE aux loss; metrics
    {"ce", "aux"}.  The vision frontend's patch rows carry no label: they
    are dropped before the loss, as the reference drops them."""
    h, aux = forward_hidden(params, cfg, batch, remat=remat)
    if cfg.frontend == "vision_stub":
        h = h[:, cfg.frontend_tokens:]
    loss = lm_loss(params, cfg, h, batch["labels"])
    total = loss + cfg.moe_aux_loss_weight * aux
    return total, {"ce": loss, "aux": aux}


# =============================================================================
# plain KV cache: prefill + decode (the exactness oracle's path)
# =============================================================================

def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda") -> Cache:
    """The plain decode cache: K/V (L, B, max_len, KVH, D); windowed family:
    ``local_k/v`` rings (n_per, period - 1, B, W, KVH, D), ``global_k/v``
    (n_per, B, max_len, KVH, D) and ``tail_k/v`` rings (tail, B, W, KVH, D);
    ssm family: the SSD ``state`` (L, B, h, p, n) and the conv tail ``conv``
    (L, B, width - 1, inner + 2n), whatever ``max_len``; hybrid family:
    ``attn_k/v`` (n_per, B, max_len, KVH, D), ``state`` (n_per, n_ssd, B,
    h, p, n) and ``conv`` (n_per, n_ssd, B, width - 1, inner + 2n), the SSD
    slots in walk order; encdec family (its
    cross-KV mode): ``self_k/v`` (L, B, max_len, KVH, D) and ``cross_k/v``
    (L, B, F, KVH, D)."""
    dt = torch_dtype(cfg)
    kv = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    head = (cfg.num_kv_heads, cfg.head_dim)
    kv_len = torch.zeros((B,), dtype=torch.int32, device=device)
    if family(cfg) == "encdec":
        F = cfg.enc_seq_len
        return {"self_k": kv(cfg.num_layers, B, max_len, *head),
                "self_v": kv(cfg.num_layers, B, max_len, *head),
                "cross_k": kv(cfg.num_layers, B, F, *head),
                "cross_v": kv(cfg.num_layers, B, F, *head), "kv_len": kv_len}
    ssd = lambda *n: {"state": kv(*n, B, cfg.ssm_num_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state_size),
                      "conv": kv(*n, B, cfg.ssm_conv_width - 1,
                                 cfg.ssm_inner + 2 * cfg.ssm_state_size)}
    if family(cfg) == "ssm":
        return {**ssd(cfg.num_layers), "kv_len": kv_len}
    if family(cfg) == "hybrid":
        n_per = cfg.num_layers // cfg.attn_period
        n_ssd = sum(name != "attn" for name, _, _ in T.hybrid_slots(cfg))
        return {"attn_k": kv(n_per, B, max_len, *head),
                "attn_v": kv(n_per, B, max_len, *head),
                **ssd(n_per, n_ssd), "kv_len": kv_len}
    if family(cfg) != "windowed":
        return {"k": kv(cfg.num_layers, B, max_len, *head),
                "v": kv(cfg.num_layers, B, max_len, *head), "kv_len": kv_len}
    period, n_per, tail = _window_split(cfg)
    W = cfg.sliding_window
    cache = {"kv_len": kv_len}
    for key in ("k", "v"):
        cache["local_" + key] = kv(n_per, period - 1, B, W, *head)
        cache["global_" + key] = kv(n_per, B, max_len, *head)
        if tail:
            cache["tail_" + key] = kv(tail, B, W, *head)
    return cache


def _to_ring(k_full, W: int):
    """(B, S, KVH, D) K or V of positions 0..S-1 -> (B, W, KVH, D) ring for
    ctx_len = S: slot j holds position S - 1 - ((S - 1 - j) mod W), zeros
    where S < W leaves a slot empty."""
    S = k_full.shape[1]
    if S < W:
        ring = k_full.new_zeros((k_full.shape[0], W) + tuple(k_full.shape[2:]))
        ring[:, :S] = k_full
        return ring
    j = torch.arange(W, device=k_full.device)
    return k_full[:, S - 1 - (S - 1 - j) % W]


def enc_act_len(cfg: ModelConfig) -> int:
    """Rows of the cross-ACT checkpoint: the F frames padded to whole
    16-token pages (whisper-base: 1500 -> 1504, 94 pages)."""
    return -(-cfg.enc_seq_len // PAGE) * PAGE


def cache_spec_cross_act(cfg: ModelConfig, B: int, max_len: int,
                         device="cuda") -> Cache:
    """The encdec cache in its cross-ACT mode: ``init_cache``'s without
    ``cross_k/v``, with ``enc_act`` (B, F_pad, d), the encoder's last
    residual before ``enc_norm`` (``enc_act_len`` rows, the padding zeros),
    which reshapes without a copy into a pool of 16-token ACT pages.
    2·L·KVH·D/d_model times fewer cross-cache bytes than cross-KV (12× for
    whisper-base; 11.9× with the page padding)."""
    cache = init_cache(cfg, B, max_len, device)
    del cache["cross_k"], cache["cross_v"]
    cache["enc_act"] = torch.zeros((B, enc_act_len(cfg), cfg.d_model),
                                   dtype=torch_dtype(cfg), device=device)
    return cache


def _ring(cache: Cache, stack: str, i: int, j: Optional[int]):
    """The (k, v) ring buffers (B, W, KVH, D) of a windowed model's local
    layer: local layer j of period i, or tail layer i."""
    if stack == "local":
        return cache["local_k"][i, j], cache["local_v"][i, j]
    return cache["tail_k"][i], cache["tail_v"][i]


def _local_full(lp, cfg, h, sincos, rings):
    """A local layer over the whole prompt, its K/V placed in its ``rings``
    (k, v) as they stand after the prompt.  -> the layer's output."""
    W = cfg.sliding_window
    h, (k, v) = T.layer_full(lp, cfg, h, sincos, window=W)
    for ring, x in zip(rings, (k, v)):
        ring.copy_(_to_ring(x, W))
    return h


def _encdec_encode(params, cfg: ModelConfig, frames, remat: bool = False):
    """The encoder over frame embeddings (B, F, d): ``enc_pos`` added, its
    bidirectional layers (the flash kernel's non-causal mode), each
    checkpointed with ``remat``.  -> its last residual BEFORE ``enc_norm``
    (the cross-ACT checkpoint; the reference's encoder output is
    ``enc_norm`` of it)."""
    h = frames + params["enc_pos"][: frames.shape[1]][None]
    for lp in T.unbind_layers(params, "enc"):
        h = _run(T.layer_full, remat, lp, cfg, h, causal=False)[0]
    return h


def _cross_q(lp, cfg: ModelConfig, h):
    """The decoder's cross-attention queries (B, S, H, D) from its residual
    h (B, S, d): ``ln_x``, then ``xattn.wq``."""
    hx = L.apply_norm(h, lp["ln_x"], cfg.norm_type)
    return (hx @ lp["xattn"]["wq"]).reshape(h.shape[0], h.shape[1],
                                             cfg.num_heads, cfg.head_dim)


def _cross_kv(lp, cfg: ModelConfig, enc_out):
    """A decoder layer's cross K/V (B, F, KVH, D) of the encoder's output."""
    shape = enc_out.shape[:2] + (cfg.num_kv_heads, cfg.head_dim)
    return ((enc_out @ lp["xattn"]["wk"]).reshape(shape),
            (enc_out @ lp["xattn"]["wv"]).reshape(shape))


def _cross_out(lp, cfg: ModelConfig, h, o):
    """The cross attention's output ``o`` projected by ``xattn.wo`` onto the
    residual, then the FFN, both residual."""
    h = h + o.reshape(h.shape[0], h.shape[1], cfg.q_dim) @ lp["xattn"]["wo"]
    return h + T.ffn_apply(lp["ffn"], cfg, L.apply_norm(h, lp["ln2"],
                                                        cfg.norm_type))


def _prefill_encdec(params, cfg: ModelConfig, tokens, max_len: int, frames,
                    cross_act: bool):
    """whisper's prefill: encode the frames, then the decoder over the
    prompt, each layer's causal self attention then its cross attention
    over the F frames (flash, non-causal, Sk = F).  The cache keeps the
    self K/V and the cross K/V, or the encoder's checkpoint (cross-ACT)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: the encoder needs frames")
    pre = _encdec_encode(params, cfg, frames)
    enc_out = L.apply_norm(pre, params["enc_norm"], cfg.norm_type)
    h = embed_input(params, cfg, tokens)
    B, S = h.shape[:2]
    F = frames.shape[1]
    if cross_act:
        cache = cache_spec_cross_act(cfg, B, max_len, device=h.device)
        cache["enc_act"][:, :F] = pre
    else:
        cache = init_cache(cfg, B, max_len, device=h.device)
    for i in range(cfg.num_layers):
        h, (k, v), (ek, ev) = _decoder_layer(T.layer_params(params, i), cfg,
                                             h, enc_out)
        cache["self_k"][i, :, :S] = k
        cache["self_v"][i, :, :S] = v
        if not cross_act:
            cache["cross_k"][i] = ek
            cache["cross_v"][i] = ev
    h = L.apply_norm(h, params["final_norm"], cfg.norm_type)
    cache["kv_len"].fill_(S)
    return unembed(params, cfg, h[:, -1:]), cache


def prefill(params, cfg: ModelConfig, tokens, max_len: int, *, frames=None,
            patches=None, cross_act: bool = False):
    """Run the prompt (B, S), build the decode cache. -> (last_logits, cache).
    whisper (encdec): ``frames`` (B, F, d) feed the encoder, and
    ``cross_act`` stores its checkpoint instead of per-layer cross K/V
    (``cache_spec_cross_act``).  qwen2-vl (vision_stub): ``patches``
    (B, P, d) go before the prompt, which the cache then holds from
    position P on."""
    if family(cfg) == "encdec":
        return _prefill_encdec(params, cfg, tokens, max_len, frames, cross_act)
    if cross_act or frames is not None:
        raise ValueError(f"{cfg.name}: frames and cross_act are the encdec "
                         "family's")
    h = embed_input(params, cfg, tokens, patches=patches)
    B, S = h.shape[:2]
    cache = init_cache(cfg, B, max_len, device=h.device)
    sincos = _sincos_at(cfg, B, S, h.device)
    if family(cfg) == "windowed":
        for stack, i, j in window_walk(cfg):
            lp = layer_params(params, i, j, stack)
            if stack == "global":
                h, (k, v) = T.layer_full(lp, cfg, h, sincos)
                cache["global_k"][i, :, :S] = k
                cache["global_v"][i, :, :S] = v
            else:
                h = _local_full(lp, cfg, h, sincos, _ring(cache, stack, i, j))
    elif family(cfg) == "ssm":
        for i in range(cfg.num_layers):
            h, (state, conv) = T.layer_full(layer_params(params, i), cfg, h,
                                            kind="ssd")
            cache["state"][i] = state
            cache["conv"][i] = conv
    elif family(cfg) == "hybrid":
        for stack, i, j, si, moe in T.hybrid_walk(cfg):
            lp = layer_params(params, i, j, stack)
            if si is None:
                h, (k, v) = T.layer_full(lp, cfg, h, sincos, is_moe=moe)
                cache["attn_k"][i, :, :S] = k
                cache["attn_v"][i, :, :S] = v
            else:
                h, (state, conv) = T.layer_full(lp, cfg, h, kind="ssd",
                                                is_moe=moe)
                cache["state"][i, si] = state
                cache["conv"][i, si] = conv
    else:
        for i in range(cfg.num_layers):
            h, (k, v) = T.layer_full(layer_params(params, i), cfg, h, sincos)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
    h = L.apply_norm(h, params["final_norm"], cfg.norm_type)
    cache["kv_len"].fill_(S)
    return unembed(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, token, cache: Cache):
    """token (B, 1) -> (logits (B, 1, V), cache); kv_len advances by 1.
    The windowed family's local layers attend over their rings in the
    torch formulation (``T._masked_decode_attn``), as the uniform layers do
    over their caches: the oracle stays independent of the kernels.  The
    encdec family: cross-KV attends in torch too; cross-ACT recomputes each
    layer's cross K/V from the checkpoint in the fused kernel
    (``_decode_encdec``).  M-RoPE: the text continues at kv_len - P + t0
    in all three streams (the patches take P slots but t0 positions)."""
    kv_len = cache["kv_len"]
    x = _embed_tokens(params, cfg, token)
    if cfg.pos_type == "learned":
        x = x + params["pos_embed"][kv_len.long()][:, None]
    if cfg.pos_type == "mrope":
        mpos = kv_len - cfg.frontend_tokens + mrope_grid(cfg)[1]
        sincos = T._rope_for(cfg, mpos[:, None, None].expand(-1, 1, 3))
    else:
        sincos = T._rope_for(cfg, kv_len[:, None])
    if family(cfg) == "encdec":
        x = _decode_encdec(params, cfg, x, cache)
    elif family(cfg) == "windowed":
        W = cfg.sliding_window
        for stack, i, j in window_walk(cfg):
            lp = layer_params(params, i, j, stack)
            if stack == "global":
                x = T.layer_decode(lp, cfg, x, cache["global_k"][i],
                                   cache["global_v"][i], kv_len, sincos)
            else:
                x = T.layer_decode(lp, cfg, x, *_ring(cache, stack, i, j),
                                   kv_len, sincos, window=W, ring=True)
    elif family(cfg) == "ssm":
        for i in range(cfg.num_layers):
            x = T.layer_decode(layer_params(params, i), cfg, x,
                               cache["state"][i], cache["conv"][i], kv_len,
                               kind="ssd")
    elif family(cfg) == "hybrid":
        for stack, i, j, si, moe in T.hybrid_walk(cfg):
            lp = layer_params(params, i, j, stack)
            if si is None:
                x = T.layer_decode(lp, cfg, x, cache["attn_k"][i],
                                   cache["attn_v"][i], kv_len, sincos,
                                   is_moe=moe)
            else:
                x = T.layer_decode(lp, cfg, x, cache["state"][i, si],
                                   cache["conv"][i, si], kv_len, kind="ssd",
                                   is_moe=moe)
    else:
        for i in range(cfg.num_layers):
            x = T.layer_decode(layer_params(params, i), cfg, x, cache["k"][i],
                               cache["v"][i], kv_len, sincos)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    cache["kv_len"] = kv_len + 1
    return unembed(params, cfg, x), cache


def cross_page_table(B: int, F: int, device):
    """The cross-ACT checkpoint's page tables, the same every step and
    layer: request b's ``ceil(F/16)`` ACT pages are pages ``b*n + j`` of its
    checkpoint pool, every one full but the last (whisper-base: 93 of 16
    tokens and one of 12).  -> (page_table, page_type, page_ntok), int32
    (B, n)."""
    n = -(-F // PAGE)
    j = torch.arange(n, dtype=torch.int32, device=device)[None]
    b = torch.arange(B, dtype=torch.int32, device=device)[:, None]
    ntok = (F - PAGE * j).clamp(0, PAGE).expand(B, n).contiguous()
    return (b * n + j).contiguous(), torch.ones_like(ntok), ntok


def _cross_act_attend(lp, cfg: ModelConfig, q, enc_norm, enc_act, tables,
                      no_kv):
    """One decoder layer's cross attention in the cross-ACT mode: one fused
    launch that norms the checkpoint's rows by ``enc_norm``, projects them
    by the layer's ``xattn.wk``/``wv`` and attends q (B, 1, H, D) over them,
    through tables of ACT pages only (``no_kv``: a one-page KV pool no
    entry reads).  -> (B, KVH, G, D)."""
    B = q.shape[0]
    KVH, D, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    w = (lp["xattn"]["wk"].view(d, KVH, D), lp["xattn"]["wv"].view(d, KVH, D))
    return hybrid_paged_attention(
        q.reshape(B, KVH, cfg.num_heads // KVH, D), no_kv, no_kv,
        enc_act.view(-1, PAGE, d), enc_norm["scale"], enc_norm.get("bias"),
        *w, *tables, norm_type=cfg.norm_type, eps=L.NORM_EPS[cfg.norm_type])


def _decode_encdec(params, cfg: ModelConfig, x, cache: Cache):
    """The decoder's layers for one token x (B, 1, d): causal self attention
    over ``self_k/v`` (written in place), cross attention over the F frames,
    the FFN.  -> the last layer's output."""
    kv_len = cache["kv_len"]
    cross_act = "enc_act" in cache
    if cross_act:
        tables = cross_page_table(x.shape[0], cfg.enc_seq_len, x.device)
        no_kv = x.new_zeros((1, PAGE, cfg.num_kv_heads, cfg.head_dim))
    for i in range(cfg.num_layers):
        lp = T.layer_params(params, i)
        x = x + T.attn_decode(lp["attn"], cfg,
                              L.apply_norm(x, lp["ln1"], cfg.norm_type),
                              cache["self_k"][i], cache["self_v"][i], kv_len)
        q = _cross_q(lp, cfg, x)
        if cross_act:
            o = _cross_act_attend(lp, cfg, q, params["enc_norm"],
                                  cache["enc_act"], tables, no_kv)
        else:
            o = L.decode_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                                   kv_len=cfg.enc_seq_len)
        x = _cross_out(lp, cfg, x, o)
    return x


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
                      device="cuda", quant: Optional[QuantConfig] = None) -> Cache:
    """KV region holds the context prefix as K/V; ACT region holds the suffix
    as layer-input activation checkpoints (paper Eq. 7 recomputes K/V).
    Both capacities are whole pages, so each layer's region reshapes without
    a copy into a page pool of the hybrid kernel.  Under ``quant`` the
    regions hold int8 codes, and ``k_s``/``v_s`` (L, B, kv_cap, KVH, 1) and
    ``act_s`` (L, B, act_cap, 1) their float16 scales, pools of (P, 16, ...)
    alike.

    Windowed family (gemma3): only the GLOBAL layers carry the hybrid cache,
    ``k``/``v``/``act`` stacked over the n_per periods; the local layers keep
    their rings ``local_k/v`` (n_per, period - 1, B, W, KVH, D) and
    ``tail_k/v`` (tail, B, W, KVH, D), W a whole number of pages.  As in the
    reference, no ``quant`` for this family.  The ssm family has no KV to
    trade (the reference's hybrid cache is for attention): refused."""
    T.check_supported(cfg, "hybrid")
    if kv_cap % PAGE or act_cap % PAGE:
        raise ValueError(f"kv_cap={kv_cap}, act_cap={act_cap}: not multiples "
                         f"of the {PAGE}-token page")
    check_supported(quant)
    dt = torch_dtype(cfg) if quant is None else torch.int8
    n_hyb = cfg.num_layers
    windowed = family(cfg) == "windowed"
    if windowed:
        if quant is not None:
            raise NotImplementedError(
                "QuantConfig is wired for the uniform hybrid family only")
        period, n_hyb, tail = _window_split(cfg)
        W = cfg.sliding_window
        if W % PAGE:
            raise ValueError(f"sliding_window={W}: not a multiple of the "
                             f"{PAGE}-token page")
    kv = (n_hyb, B, kv_cap, cfg.num_kv_heads, cfg.head_dim)
    act = (n_hyb, B, act_cap, cfg.d_model)
    i32 = dict(dtype=torch.int32, device=device)
    cache = {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "act": torch.zeros(act, dtype=dt, device=device),
        "act_pos": torch.zeros((B, act_cap), **i32),
        "kv_len": torch.zeros((B,), **i32),
        "act_len": torch.zeros((B,), **i32),
    }
    if quant is not None:
        f16 = dict(dtype=torch.float16, device=device)
        cache.update(k_s=torch.zeros(kv[:-1] + (1,), **f16),
                     v_s=torch.zeros(kv[:-1] + (1,), **f16),
                     act_s=torch.zeros(act[:-1] + (1,), **f16))
    if windowed:
        head = (cfg.num_kv_heads, cfg.head_dim)
        for key in ("k", "v"):
            cache["local_" + key] = torch.zeros((n_hyb, period - 1, B, W) + head,
                                                dtype=dt, device=device)
            if tail:
                cache["tail_" + key] = torch.zeros((tail, B, W) + head,
                                                   dtype=dt, device=device)
    return cache


def _check_cache(cache: Cache, quant: Optional[QuantConfig]) -> None:
    if ("k_s" in cache) != (quant is not None):
        raise ValueError(f"quant={quant} does not match the cache's format "
                         f"({'int8' if 'k_s' in cache else 'unquantized'})")


def kv_planes(cache: Cache) -> Tuple[str, ...]:
    """The keys of a cache's KV region planes in storage order: K and V
    (codes in a quantized cache), then a quantized cache's K and V scales."""
    return ("k", "v", "k_s", "v_s") if "k_s" in cache else ("k", "v")


def region_planes(cache: Cache) -> Tuple[str, ...]:
    """The keys of every region plane of a cache: the KV planes, then the
    ACT region and a quantized cache's ACT scales."""
    return kv_planes(cache) + (("act", "act_s") if "act_s" in cache else ("act",))


def plane_scales(kv, act_s):
    """A layer's scale operands (k_s, v_s, act_s) from its KV planes ``kv``
    (in ``kv_planes`` order) and its ACT scales; None for an unquantized
    layer (two planes)."""
    return None if len(kv) == 2 else (kv[2], kv[3], act_s)


def region_scales(cache: Cache, i: int):
    """Layer ``i``'s scale sidecars (k_s, v_s, act_s) of a quantized cache,
    None for an unquantized one."""
    if "k_s" not in cache:
        return None
    return cache["k_s"][i], cache["v_s"][i], cache["act_s"][i]


def _encode(rows, dtype: torch.dtype):
    """What a region of ``dtype`` stores for ``rows`` (..., D): int8 codes
    and their float16 scales (..., 1), or the rows in the cache dtype and
    None."""
    return quantize(rows) if dtype == torch.int8 else (rows.to(dtype), None)


def _store(cache: Cache, key: str, index, rows) -> None:
    """Write ``rows`` into ``cache[key][index]`` in the region's format (as
    codes, with their scales into ``cache[key + "_s"][index]``, when int8)."""
    codes, scales = _encode(rows, cache[key].dtype)
    cache[key][index] = codes
    if scales is not None:
        cache[key + "_s"][index] = scales


def hybrid_prefill(params, cfg: ModelConfig, tokens, kv_cap: int,
                   act_cap: int, kv_keep: int,
                   quant: Optional[QuantConfig] = None):
    """Prefill storing the first ``kv_keep`` tokens as K/V and the remaining
    prompt tokens as activation checkpoints, one split for every request of
    ``tokens`` (B, S).  -> (last_logits (B, 1, V), hybrid cache).  Windowed
    family: the global layers' regions (their inputs are the checkpoints),
    the local layers' rings; no ``quant``.  Uniform family: the batched
    prefill with that split for every request."""
    B, S = tokens.shape
    kfit = min(int(kv_keep), S)
    if family(cfg) == "windowed":
        if quant is not None:
            raise NotImplementedError(
                "QuantConfig is wired for the uniform hybrid family only")
        return _hybrid_prefill_windowed(params, cfg, tokens, kv_cap, act_cap,
                                        kfit)
    return hybrid_prefill_batched(params, cfg, tokens, kv_cap, act_cap,
                                  np.full((B,), kfit), np.full((B,), S), quant)


def _hybrid_prefill_windowed(params, cfg: ModelConfig, tokens, kv_cap: int,
                             act_cap: int, kfit: int):
    """The windowed family's hybrid prefill: each global layer's input is
    its ACT checkpoint, of which positions [kfit, S) go to its ACT region and
    the K/V of [0, kfit) to its KV region; each local layer's K/V go to its
    ring, as ``prefill`` places them."""
    h = embed_input(params, cfg, tokens)
    B, S = h.shape[:2]
    if kfit > kv_cap or S - kfit > act_cap:
        raise ValueError(f"split {kfit} + {S - kfit} exceeds kv_cap={kv_cap} "
                         f"or act_cap={act_cap}")
    cache = init_hybrid_cache(cfg, B, kv_cap, act_cap, device=h.device)
    sincos = T._rope_for(cfg, _positions(S, h.device))
    for stack, i, j in window_walk(cfg):
        lp = layer_params(params, i, j, stack)
        if stack == "global":
            cache["act"][i, :, :S - kfit] = h[:, kfit:]          # A^i
            h, (k, v) = T.layer_full(lp, cfg, h, sincos)
            cache["k"][i, :, :kfit] = k[:, :kfit]
            cache["v"][i, :, :kfit] = v[:, :kfit]
        else:
            h = _local_full(lp, cfg, h, sincos, _ring(cache, stack, i, j))
    h = L.apply_norm(h, params["final_norm"], cfg.norm_type)
    slots = torch.arange(act_cap, dtype=torch.int32, device=h.device)
    cache["act_pos"] = (kfit + slots)[None].expand(B, act_cap).contiguous()
    cache["kv_len"].fill_(kfit)
    cache["act_len"].fill_(S - kfit)
    return unembed(params, cfg, h[:, -1:]), cache


def hybrid_prefill_batched(params, cfg: ModelConfig, tokens, kv_cap: int,
                           act_cap: int, kv_keep, last_pos,
                           quant: Optional[QuantConfig] = None):
    """Group-batched hybrid prefill with PER-REQUEST KV/ACT split points.

      kv region  <- K/V of positions [0, kv_keep[b])   (kv_len masks the rest)
      act region <- checkpoints of [kv_keep[b], last_pos[b])  (gathered)

    tokens (B, S); kv_keep, last_pos (B,): host integers (numpy, a sequence
    or a CPU tensor), checked against the capacities (``check_split``) and
    uploaded without a stream sync.
    -> (last_logits (B, 1, V), hybrid cache).  Its three stages are the
    offload executor's too, which runs the layers with streamed weights.
    ``quant`` stores both regions as int8 codes with their scales."""
    pre = hybrid_prefill_begin(params, cfg, tokens, kv_cap, act_cap, kv_keep,
                               last_pos, quant)
    h = pre.h
    for i in range(cfg.num_layers):
        h = hybrid_prefill_layer(layer_params(params, i), cfg, h, pre, i)
    return hybrid_prefill_end(params, cfg, h, pre)


class PrefillPlan(NamedTuple):
    """What every layer of one hybrid prefill shares: the embedded input
    ``h``, the cache it fills, RoPE at positions 0..S-1 (or None), the
    ACT-region gather index (B, act_cap, d), the KV rows each layer keeps,
    and the split (kv_keep, last_pos) on the device."""
    h: torch.Tensor
    cache: Cache
    sincos: Optional[Tuple[torch.Tensor, torch.Tensor]]
    act_idx: torch.Tensor
    kfit: int
    kv_keep: torch.Tensor
    last_pos: torch.Tensor


def check_split(kv_keep, last_pos, kv_cap: int, act_cap: int) -> None:
    """The split's capacity check on host integers: a KV prefix over
    ``kv_cap`` or an ACT span over ``act_cap`` raises ``ValueError``."""
    kv_keep = np.asarray(kv_keep, np.int64)
    span = np.asarray(last_pos, np.int64) - kv_keep
    if int(kv_keep.max()) > kv_cap:
        raise ValueError(f"kv_keep={int(kv_keep.max())} exceeds kv_cap={kv_cap}")
    if int(span.max()) > act_cap:
        raise ValueError(f"ACT span {int(span.max())} exceeds act_cap={act_cap}")


def upload(a, device) -> torch.Tensor:
    """A host array on ``device`` without a stream sync: on CUDA staged in
    page-locked memory and copied non-blocking."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def hybrid_prefill_begin(params, cfg: ModelConfig, tokens, kv_cap: int,
                         act_cap: int, kv_keep, last_pos,
                         quant: Optional[QuantConfig] = None) -> PrefillPlan:
    """Check the host split against the capacities and upload it, embed,
    allocate the cache.  Reads no device value."""
    T.check_supported(cfg, "hybrid")
    dev = tokens.device
    kv_keep, last_pos = (np.asarray(a, np.int32) for a in (kv_keep, last_pos))
    check_split(kv_keep, last_pos, kv_cap, act_cap)
    kv_keep, last_pos = upload(kv_keep, dev), upload(last_pos, dev)
    h = embed_input(params, cfg, tokens)
    B, S = h.shape[:2]
    cache = init_hybrid_cache(cfg, B, kv_cap, act_cap, device=dev, quant=quant)
    slots = torch.arange(act_cap, dtype=torch.int32, device=dev)[None]
    # act region slot j of request b holds the checkpoint of position kv_keep[b]+j
    act_idx = (kv_keep[:, None] + slots).clamp(0, S - 1).long()
    act_idx = act_idx[:, :, None].expand(B, act_cap, cfg.d_model)
    return PrefillPlan(h, cache, T._rope_for(cfg, _positions(S, dev)), act_idx,
                       min(S, kv_cap), kv_keep, last_pos)


def hybrid_prefill_layer(lp, cfg: ModelConfig, h, pre: PrefillPlan, i: int):
    """Layer ``i`` of the hybrid prefill: store its input as the ACT
    checkpoint, run it, keep its first ``kfit`` K/V rows (each stored in
    the cache's format).  -> its output."""
    cache, kept = pre.cache, (i, slice(None), slice(None, pre.kfit))
    _store(cache, "act", i, torch.gather(h, 1, pre.act_idx))      # A^i
    h, (k, v) = T.layer_full(lp, cfg, h, pre.sincos)
    _store(cache, "k", kept, k[:, :pre.kfit])
    _store(cache, "v", kept, v[:, :pre.kfit])
    return h


def hybrid_prefill_end(params, cfg: ModelConfig, h, pre: PrefillPlan):
    """Final norm, logits at each request's last prompt position, lengths.
    -> (last_logits (B, 1, V), cache)."""
    cache, kv_keep, last_pos = pre.cache, pre.kv_keep, pre.last_pos
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


def _write_new(kc, vc, ac, k, v, act_in, kv_len, act_len, store_act,
               scales=None, on=None):
    """Write the new token's K/V row (KV-bound) at ``kv_len`` of kc/vc
    (B, cap, KVH, D), or its checkpoint ``act_in`` (ACT-bound) at
    ``act_len`` of ac (B, act_cap, d), in place.  A write past its region's
    capacity is dropped, as the reference's scatter drops an out-of-range
    update (masked on the device, no host sync).  ``on`` (B,) x 2: which
    requests write K/V and which a checkpoint, when the step has them
    already (``DecodePlan.write_on``).  ``scales`` (ks, vs, as), the
    regions' sidecars of a quantized cache: the row is written as codes,
    and its scale beside it."""
    ar = torch.arange(kc.shape[0], device=kc.device)
    ki = kv_len.clamp(max=kc.shape[1] - 1).long()
    ai = act_len.clamp(max=ac.shape[1] - 1).long()
    ks, vs, as_ = scales if scales is not None else (None,) * 3
    on_kv, on_act = on if on is not None else \
        write_masks(store_act, kv_len, act_len, kc.shape[1], ac.shape[1])
    _put(kc, ks, ar, ki, k[:, 0], on_kv)
    _put(vc, vs, ar, ki, v[:, 0], on_kv)
    _put(ac, as_, ar, ai, act_in, on_act)


def write_masks(store_act, kv_len, act_len, kv_cap: int, act_cap: int):
    """-> (on_kv, on_act) (B,) bool: the requests whose new token writes a
    K/V row, and those that write a checkpoint, within capacity."""
    return ~store_act & (kv_len < kv_cap), store_act & (act_len < act_cap)


def _put(region, scales, ar, idx, row, on) -> None:
    """Write ``row`` (B, ...) at ``idx`` of ``region`` (B, cap, ...) for the
    requests where ``on`` (B,) holds, in the region's format: int8 codes
    with their scales written into ``scales``."""
    m = on.view(-1, *(1,) * (row.dim() - 1))
    for plane, new in zip((region, scales), _encode(row, region.dtype)):
        if new is not None:
            plane[ar, idx] = torch.where(m, new, plane[ar, idx])


class OwnRow(NamedTuple):
    """The new token's exact K/V (B, 1, KVH, D), its slot in the ACT region
    (B,), and whether it is ACT-bound (B,): what a quantized step attends to
    in place of the K/V its int8 checkpoint would give."""
    k: torch.Tensor
    v: torch.Tensor
    act_len: torch.Tensor
    store_act: torch.Tensor


def _hybrid_attend(lp, cfg, q, kc, vc, ac, tables,
                   act_kv: Optional[ActKV] = None, return_lse: bool = False,
                   scales=None, own: Optional[OwnRow] = None):
    """The new token's attention over the typed page tables: KV pages of
    kc/vc (B, cap, KVH, D), ACT pages of ac (B, act_cap, d).  ``act_kv``
    given (RoPE models): ``kv_gen`` recomputes the ACT pages into the
    scratch pool and the second-pool kernel attends; else the fused mode
    recomputes them in the same call.  ``scales`` (ks, vs, as) select the
    kernels' int8 modes; ``own`` then carries the ACT-bound token's exact K/V, which
    the tables leave out on the fused route.  -> (B, KVH, G, D), and (m, l)
    with ``return_lse``."""
    B = q.shape[0]
    KVH, D, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    qg = q.reshape(B, KVH, cfg.num_heads // KVH, D)
    if own is not None:          # a checkpoint past the ACT capacity was dropped
        own = own._replace(store_act=own.store_act & (own.act_len < ac.shape[1]))
    pools = (kc.view(-1, PAGE, KVH, D), vc.view(-1, PAGE, KVH, D))
    norm = (lp["ln1"]["scale"], lp["ln1"].get("bias"))
    wkv = (lp["attn"]["wk"].view(d, KVH, D), lp["attn"]["wv"].view(d, KVH, D))
    eps = L.NORM_EPS[cfg.norm_type]
    kv_s, act_s = {}, None
    if scales is not None:
        kv_s = dict(k_scales=scales[0].view(-1, PAGE, KVH, 1),
                    v_scales=scales[1].view(-1, PAGE, KVH, 1))
        act_s = scales[2].view(-1, PAGE, 1)
    if act_kv is None:
        fused = lambda lse: hybrid_paged_attention(
            qg, *pools, ac.view(-1, PAGE, d), *norm, *wkv, *tables,
            act_scales=act_s, norm_type=cfg.norm_type, eps=eps,
            return_lse=lse, **kv_s)
        if own is None:
            return fused(return_lse)
        o, m, l = _merge_own(qg, *fused(True), own)
        return (o, m, l) if return_lse else o
    if act_kv.page_index.numel():
        kv_gen(ac.view(-1, PAGE, d), *norm, *wkv,
               page_index=act_kv.page_index, sin=act_kv.sin,
               cos=act_kv.cos, act_scales=act_s,
               knorm=lp["attn"].get("knorm"), norm_type=cfg.norm_type,
               eps=eps, out=(act_kv.k, act_kv.v))
        if own is not None:
            _own_rows(act_kv, own)
    return hybrid_paged_attention_two_pool(qg, *pools, act_kv.k, act_kv.v,
                                           *tables, return_lse=return_lse,
                                           **kv_s)


def _merge_own(qg, o, m, l, own: OwnRow):
    """Fold each ACT-bound token's exact (k, v) into the kernel's partial
    (o, m, l) over the stored pages, as a one-token partition (the CPU
    lane's merge); a KV-bound token's partition is empty.  -> (o in q's
    dtype, m, l)."""
    s = torch.einsum("bhgd,bhd->bhg", qg.float(), own.k[:, 0].float())
    s = s[..., None] / math.sqrt(qg.shape[-1])
    on = own.store_act[:, None, None, None]
    m_own = torch.where(on, s, NEG_INF)
    l_own = on.float().expand_as(s)
    o, m, l = merge_partials_torch(o.float(), m, l, own.v[:, 0, :, None].float(),
                                   m_own, l_own)
    return o.to(qg.dtype), m, l


def _own_rows(act_kv: ActKV, own: OwnRow) -> None:
    """Write each ACT-bound token's exact rotated (k, v) into its row of the
    scratch pool, over what ``kv_gen`` recomputed from its int8
    checkpoint."""
    B = own.k.shape[0]
    rows = act_kv.k.shape[0] // B * PAGE         # scratch rows per request
    kf, vf = (x.view(B, rows, *x.shape[2:]) for x in (act_kv.k, act_kv.v))
    ar = torch.arange(B, device=kf.device)
    slot = own.act_len.clamp(max=rows - 1).long()
    on = (own.store_act & (own.act_len < rows))[:, None, None]
    kf[ar, slot] = torch.where(on, own.k[:, 0].to(kf.dtype), kf[ar, slot])
    vf[ar, slot] = torch.where(on, own.v[:, 0].to(vf.dtype), vf[ar, slot])


def _layer_out(lp, cfg, h, o):
    """Output projection of the attention ``o`` and the FFN, both residual."""
    h = h + o.reshape(h.shape[0], 1, cfg.q_dim) @ lp["attn"]["wo"]
    return h + T.ffn_apply(lp["ffn"], cfg, L.apply_norm(h, lp["ln2"], cfg.norm_type))


def _hybrid_layer_step(lp, cfg, h, kc, vc, ac, kv_len, act_len, store_act,
                       tables, act_kv: Optional[ActKV] = None, scales=None,
                       exact_own: bool = True, write_on=None):
    """One hybrid KV/ACT attention layer at decode time.  kc/vc (B, kv_cap,
    KVH, D) and ac (B, act_cap, d) are this layer's regions, updated in place
    (int8 codes, with ``scales`` (ks, vs, as) their sidecars, in a quantized
    cache).  ``exact_own``: the plan's, whether a quantized step has an
    ACT-bound token to attend to its exact K/V.  ``write_on``: the plan's
    write masks, for regions of the cache's capacities.

    The new token's K/V (KV-bound) or checkpoint (ACT-bound) is written into
    its region BEFORE the kernels run.  Unquantized, an ACT-bound token's K/V
    are then recomputed from its own checkpoint — the same norm(h) @ wk that
    ``_qk`` computed, rotated at the same position.  Quantized, the
    checkpoint is not what the token attends to: its exact K/V are (see the
    module docstring)."""
    q, k, v = _layer_qkv(lp, cfg, h, act_kv)
    _write_new(kc, vc, ac, k, v, h[:, 0], kv_len, act_len, store_act, scales,
               write_on)
    own = OwnRow(k, v, act_len, store_act) \
        if scales is not None and exact_own else None
    o = _hybrid_attend(lp, cfg, q, kc, vc, ac, tables, act_kv, scales=scales,
                       own=own)
    return _layer_out(lp, cfg, h, o)


class DecodePlan(NamedTuple):
    """What every layer of one hybrid decode step shares: the embedded new
    token ``x`` (B, 1, d), the page tables, the RoPE route's inputs (None
    for learned positions), and the ACT side of the tables: the stride of a
    request's ACT entries in the pool they index (the ACT region, or the
    scratch pool) and the ACT tokens each request attends over; and whether
    ACT-bound tokens attend to their exact K/V after the kernels (a
    quantized step with an ACT-bound token); and which requests write a K/V
    row and which a checkpoint, within the regions' capacities
    (``write_masks``)."""
    x: torch.Tensor
    tables: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    act_kv: Optional[ActKV]
    act_stride: int
    act_read: torch.Tensor
    exact_own: bool
    write_on: Tuple[torch.Tensor, torch.Tensor]


def hybrid_decode_begin(params, cfg: ModelConfig, token, cache: Cache,
                        store_act, *, pages_bound=None, act_pages_bound=None,
                        quant: Optional[QuantConfig] = None,
                        any_act: bool = True) -> DecodePlan:
    """Record the new token's ACT position, embed it, and build the step's
    page tables (and, for RoPE models, the ``kv_gen`` inputs) once for all
    layers.  Bounds and ``any_act`` as for ``hybrid_decode_step``.
    Quantized, the fused route's tables leave out an ACT-bound token's own
    row (its exact K/V are merged in after the kernel)."""
    T.check_supported(cfg, "hybrid")
    _check_cache(cache, quant)
    B = token.shape[0]
    kv_cap, act_cap = cache["k"].shape[2], cache["act"].shape[2]
    kv_len, act_len = cache["kv_len"], cache["act_len"]
    ctx = kv_len + act_len                                     # absolute position
    ar = torch.arange(B, device=token.device)
    ai = act_len.clamp(max=act_cap - 1).long()
    write_on = write_masks(store_act, kv_len, act_len, kv_cap, act_cap)
    # ACT tokens carry their recorded absolute positions (appends interleave);
    # a checkpoint past the ACT capacity is dropped, and so is its position
    cache["act_pos"][ar, ai] = torch.where(write_on[1], ctx,
                                           cache["act_pos"][ar, ai])

    x = _embed_tokens(params, cfg, token)
    if cfg.pos_type == "learned":
        x = x + params["pos_embed"][ctx.long()][:, None]
    kv_new = kv_len + (~store_act).int()
    act_new = act_len + store_act.int()
    maxp = kv_cap // PAGE + act_cap // PAGE
    n_pages = maxp if pages_bound is None else min(int(pages_bound), maxp)
    act_kv, act_stride = None, act_cap
    exact_own = quant is not None and bool(any_act)
    act_read = act_len if exact_own else act_new
    if cfg.pos_type == "rope":
        n_act = act_cap // PAGE if act_pages_bound is None \
            else min(int(act_pages_bound), act_cap // PAGE)
        act_kv = _act_kv(cfg, cache, ctx, n_act)
        act_stride = n_act * PAGE        # ACT entries index the scratch pool
        # tokens past the bound have no recomputed K/V: attention drops them
        act_read = act_new.clamp(max=act_stride)
    # a region at capacity attends over what it holds (its write was dropped)
    tables = hybrid_page_table(kv_new.clamp(max=kv_cap),
                               act_read.clamp(max=act_cap), kv_cap, act_stride,
                               n_pages)
    return DecodePlan(x, tables, act_kv, act_stride, act_read, exact_own,
                      write_on)


def hybrid_decode_end(params, cfg: ModelConfig, x, cache: Cache, store_act):
    """Final norm and logits of the step's last layer output; the lengths
    advance.  -> logits (B, 1, V)."""
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    cache["kv_len"] = cache["kv_len"] + (~store_act).int()
    cache["act_len"] = cache["act_len"] + store_act.int()
    return unembed(params, cfg, x)


def hybrid_decode_step(params, cfg: ModelConfig, token, cache: Cache,
                       store_act, *, pages_bound=None, act_pages_bound=None,
                       quant: Optional[QuantConfig] = None,
                       any_act: bool = True):
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
    quant: the cache's ``QuantConfig`` (None: unquantized); it must match
    the format ``init_hybrid_cache`` gave the cache.
    any_act: whether ``store_act`` may hold a True, from the caller's host
    schedule (no host sync).  False spares a quantized step the ACT-bound
    tokens' exact K/V (the fused route's merge, the RoPE route's scratch
    write); a step with an ACT-bound token needs True.
    Windowed family: the global layers take the hybrid route, the local
    layers attend over their rings (``_ring_layer_step``); its caches hold
    no ``quant`` format.
    -> (logits (B, 1, V), cache)."""
    plan = hybrid_decode_begin(params, cfg, token, cache, store_act,
                               pages_bound=pages_bound,
                               act_pages_bound=act_pages_bound, quant=quant,
                               any_act=any_act)
    if family(cfg) == "windowed":
        return _hybrid_decode_windowed(params, cfg, cache, store_act, plan)
    x = plan.x
    for i in range(cfg.num_layers):
        x = _hybrid_layer_step(layer_params(params, i), cfg, x, cache["k"][i],
                               cache["v"][i], cache["act"][i], cache["kv_len"],
                               cache["act_len"], store_act, plan.tables,
                               plan.act_kv, region_scales(cache, i),
                               plan.exact_own, plan.write_on)
    return hybrid_decode_end(params, cfg, x, cache, store_act), cache


def ring_page_table(ctx, W: int):
    """Page tables of the local layers' rings at this step: request b's ring
    is pages ``b*W/16 + j`` of its layer's ring pool, all KV pages, and its
    live slots are the prefix [0, min(ctx + 1, W)) (slot j holds position
    ctx - (ctx - j) mod W, which is > ctx - W; below W only j <= ctx is
    filled).  ctx (B,): the new token's position, its row included.
    -> (page_table, page_type, page_ntok), int32 (B, W/16)."""
    n = W // PAGE
    j = torch.arange(n, device=ctx.device)[None]
    b = torch.arange(ctx.shape[0], device=ctx.device)[:, None]
    live = (ctx.long()[:, None] + 1).clamp(max=W)
    ntok = (live - PAGE * j).clamp(0, PAGE)
    return ((b * n + j).int(), torch.where(ntok > 0, 0, 2).int(), ntok.int())


def _ring_layer_step(lp, cfg, h, k_ring, v_ring, ctx, sincos, tables, no_act):
    """One local (sliding-window) layer at decode time: the new token's
    K/V written at slot ``ctx % W`` of the rings (B, W, KVH, D), in place,
    then the second-pool kernel over the rings' pages (``tables``, no ACT
    page: ``no_act`` are empty pools), then the FFN."""
    B, W = k_ring.shape[:2]
    KVH, D = cfg.num_kv_heads, cfg.head_dim
    q, k, v = T._qk_roped(lp["attn"], cfg,
                          L.apply_norm(h, lp["ln1"], cfg.norm_type), sincos)
    ar = torch.arange(B, device=h.device)
    slot = (ctx % W).long()
    k_ring[ar, slot] = k[:, 0]
    v_ring[ar, slot] = v[:, 0]
    o = hybrid_paged_attention_two_pool(
        q.reshape(B, KVH, cfg.num_heads // KVH, D),
        k_ring.view(-1, PAGE, KVH, D), v_ring.view(-1, PAGE, KVH, D),
        no_act, no_act, *tables)
    return _layer_out(lp, cfg, h, o)


def _hybrid_decode_windowed(params, cfg: ModelConfig, cache: Cache, store_act,
                            plan: DecodePlan):
    """The windowed family's hybrid decode step after ``hybrid_decode_begin``:
    each period's local layers over their rings, then its global layer over
    the hybrid regions (``kv_gen`` with the K norm, then the second-pool
    kernel), then the tail's local layers.  -> (logits (B, 1, V), cache)."""
    ctx = cache["kv_len"] + cache["act_len"]
    W = cfg.sliding_window
    tables = ring_page_table(ctx, W)
    no_act = torch.empty((0, PAGE, cfg.num_kv_heads, cfg.head_dim),
                         dtype=torch_dtype(cfg), device=ctx.device)
    x = plan.x
    for stack, i, j in window_walk(cfg):
        lp = layer_params(params, i, j, stack)
        if stack == "global":
            x = _hybrid_layer_step(lp, cfg, x, cache["k"][i], cache["v"][i],
                                   cache["act"][i], cache["kv_len"],
                                   cache["act_len"], store_act, plan.tables,
                                   plan.act_kv, write_on=plan.write_on)
        else:
            x = _ring_layer_step(lp, cfg, x, *_ring(cache, stack, i, j), ctx,
                                 plan.act_kv.sincos_new, tables, no_act)
    return hybrid_decode_end(params, cfg, x, cache, store_act), cache


def _act_kv(cfg, cache, ctx, n_act: int) -> ActKV:
    """The RoPE route's per-step inputs, computed once for all layers: RoPE
    at the new positions ``ctx`` and at the recorded positions of the first
    ``n_act`` ACT pages of each request, those pages' indices in a layer's
    pool, and the scratch pool."""
    B, act_cap = cache["act_pos"].shape
    dev, dt = ctx.device, torch_dtype(cfg)
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
                       store_sched, **kw):
    """Greedy generation over the hybrid cache, argmax on the device and no
    host sync inside the loop: ``hybrid_decode_chunk`` with every slot
    active (its keywords).

    cur:         (B,) int32 — first token to emit (argmax of prefill logits).
    store_sched: (n_steps, B) bool tensor — per-step store_act flags.
    -> (tokens (B, n_steps) int32, cache)."""
    toks, _, cache = hybrid_decode_chunk(params, cfg, cur, cache, store_sched,
                                         **kw)
    return toks, cache


def _freeze_inactive(cache: Cache, active, kv_len, act_len) -> None:
    """Restore the lengths ``kv_len``/``act_len`` (B,) from before a step for
    the slots not ``active`` in it (``hybrid_decode_end`` advanced them)."""
    cache["kv_len"] = torch.where(active, cache["kv_len"], kv_len)
    cache["act_len"] = torch.where(active, cache["act_len"], act_len)


def hybrid_decode_chunk(params, cfg: ModelConfig, cur, cache: Cache,
                        store_sched, active_sched=None, *, pages_bound=None,
                        act_pages_bound=None,
                        quant: Optional[QuantConfig] = None, any_act=None):
    """Masked multi-step decode: the continuous-batching server's S serving
    iterations as one call, argmax on the device and no host sync inside.

    Each step is ``hybrid_decode_step`` with per-step masking on top:
    INACTIVE slots (retired mid-chunk, or never admitted) store nothing to
    the ACT region (``store &= active``), keep their carried token and emit
    -1, and their ``kv_len``/``act_len`` stay frozen, so an idle slot never
    creeps past its regions.  Their rows may hold garbage; admission
    rewrites every plane of a slot.

    cur:          (B,) int32 — next token each slot would emit.
    store_sched:  (S, B) bool tensor — per-step store_act flags.
    active_sched: (S, B) bool tensor — slot b takes part in step s; None:
                  every slot takes part in every step (no masking launched).
    pages_bound, act_pages_bound: as for ``hybrid_decode_step``, covering
                  every ACTIVE slot's lengths within the chunk (the
                  reference's token bounds / 16).  A frozen slot's lengths
                  may exceed them: its tables stay inside its own regions.
    any_act:      (S,) host bools, whether step s binds an active token to
                  the ACT region; None: every step may.
    -> (tokens (B, S) int32 with -1 at inactive entries, next cur (B,),
        cache)."""
    toks = []
    for s in range(store_sched.shape[0]):
        store = store_sched[s]
        if active_sched is not None:
            active = active_sched[s]
            store = store & active
            kv_len, act_len = cache["kv_len"], cache["act_len"]
        lg, cache = hybrid_decode_step(params, cfg, cur[:, None], cache, store,
                                       pages_bound=pages_bound,
                                       act_pages_bound=act_pages_bound,
                                       quant=quant,
                                       any_act=True if any_act is None
                                       else bool(any_act[s]))
        nxt = lg[:, -1].argmax(-1).int()
        if active_sched is None:
            toks.append(cur)
            cur = nxt
            continue
        _freeze_inactive(cache, active, kv_len, act_len)
        toks.append(torch.where(active, cur, -1))
        cur = torch.where(active, nxt, cur)
    return _stack(toks, cur), cur, cache
