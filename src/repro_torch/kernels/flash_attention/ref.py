"""Plain PyTorch version of the flash-attention kernel: masked softmax
attention with the whole score matrix in float32 (counterpart of
``repro.kernels.flash_attention.ref``)."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, window: int = 0):
    """Causal: q (B,S,H,D); k,v (B,S,KVH,D) -> (B,S,H,D) in q.dtype.
    ``window`` > 0 (sliding window): query i sees keys i - window < j <= i."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qr = q.reshape(B, S, KVH, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k.float()) / math.sqrt(D)
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window > 0:
        mask &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)
