"""The plain int8 KV cache: the quantized engine's kv-mode oracle
(counterpart of ``repro.models.quantized_cache``).

K and V are stored int8 per (token, kv-head) with a float16 absmax scale, the
format of the hybrid cache's KV region under ``QuantConfig()``.  Prefill
runs the plain path and quantizes its cache; each decode step quantizes the
new token's K/V into the cache, then attends over the ``kv_len``-bounded
slice dequantized to the model dtype.  Plain torch, no kernel: it holds the
quantized engine's kv mode to the same codes read back by other means.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.quant_ops import dequantize, quantize


def init_cache_q8(cfg: ModelConfig, B: int, max_len: int,
                  device="cuda") -> Dict[str, Any]:
    """The decode cache: int8 K/V and float16 scales."""
    sh = (cfg.num_layers, B, max_len, cfg.num_kv_heads, cfg.head_dim)
    ssh = sh[:-1] + (1,)
    i8 = dict(dtype=torch.int8, device=device)
    f16 = dict(dtype=torch.float16, device=device)
    return {"k_q": torch.zeros(sh, **i8), "k_s": torch.zeros(ssh, **f16),
            "v_q": torch.zeros(sh, **i8), "v_s": torch.zeros(ssh, **f16),
            "kv_len": torch.zeros((B,), dtype=torch.int32, device=device)}


def prefill_q8(params, cfg: ModelConfig, tokens, max_len: int):
    """Prefill, then quantize the prompt K/V into the int8 cache.
    -> (last_logits, cache)."""
    logits, cache = M.prefill(params, cfg, tokens, max_len=max_len)
    kq, ks = quantize(cache["k"])
    vq, vs = quantize(cache["v"])
    return logits, {"k_q": kq, "k_s": ks, "v_q": vq, "v_s": vs,
                    "kv_len": cache["kv_len"]}


def decode_step_q8(params, cfg: ModelConfig, token, cache, bound: int):
    """One decode step over the int8 cache; token (B, 1).

    Dequantizes only the attended slice ``[:bound]`` of the cache, where
    ``bound`` >= max(kv_len) + 1 is the caller's: the reference reads
    ``max(kv_len) + 1`` from the device, which here would be a host sync per
    step.  Attention masks past ``kv_len`` either way, so any sufficient
    bound gives the same result.  -> (logits (B, 1, V), cache), in place."""
    B = token.shape[0]
    kv_len = cache["kv_len"]
    bound = min(int(bound), cache["k_q"].shape[2])
    dt = M.torch_dtype(cfg)
    x = M._embed_tokens(params, cfg, token)
    if cfg.pos_type == "learned":
        x = x + params["pos_embed"][kv_len.long()][:, None]
    sincos = T._rope_for(cfg, kv_len[:, None])
    ar = torch.arange(B, device=token.device)
    ki = kv_len.long()
    for i in range(cfg.num_layers):
        lp = M.layer_params(params, i)
        h = L.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = T._qk_roped(lp["attn"], cfg, h, sincos)
        for name, new in (("k", k), ("v", v)):
            nq, ns = quantize(new[:, 0])
            cache[name + "_q"][i, ar, ki] = nq
            cache[name + "_s"][i, ar, ki] = ns
        kf = dequantize(cache["k_q"][i, :, :bound], cache["k_s"][i, :, :bound], dt)
        vf = dequantize(cache["v_q"][i, :, :bound], cache["v_s"][i, :, :bound], dt)
        o = L.decode_attention(q, kf, vf, kv_len=kv_len + 1)
        x = x + o.reshape(B, 1, cfg.q_dim) @ lp["attn"]["wo"]
        x = x + T.ffn_apply(lp["ffn"], cfg,
                            L.apply_norm(x, lp["ln2"], cfg.norm_type))
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    cache["kv_len"] = kv_len + 1
    return M.unembed(params, cfg, x), cache
