"""Plain PyTorch version of the flash-attention kernel: masked softmax
attention with the whole score matrix in float32 (counterpart of
``repro.kernels.flash_attention.ref``)."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, window: int = 0, causal: bool = True):
    """q (B,Sq,H,D); k,v (B,Sk,KVH,D) -> (B,Sq,H,D) in q.dtype.  Causal
    (Sq = Sk): query i sees keys j <= i, and with ``window`` > 0 (sliding
    window) only i - window < j <= i.  ``causal=False``: every key."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qr = q.reshape(B, Sq, KVH, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k.float()) / math.sqrt(D)
    if causal:
        i, j = torch.arange(Sq, device=q.device), torch.arange(Sk, device=q.device)
        mask = j[None, :] <= i[:, None]
        if window > 0:
            mask &= j[None, :] > i[:, None] - window
        s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
