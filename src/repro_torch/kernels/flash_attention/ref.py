"""Plain PyTorch versions of the flash-attention kernels: masked softmax
attention with the whole score matrix in float32 (counterpart of
``repro.kernels.flash_attention.ref``), and its backward from the forward's
lse in the same three modes (counterpart of the custom VJP ``_bw_attn_b`` of
``repro.models.layers``, whose mask is ``_tile_mask``)."""
from __future__ import annotations

import math

import torch


def _causal(Sq: int, Sk: int, window: int, device):
    i, j = torch.arange(Sq, device=device), torch.arange(Sk, device=device)
    mask = j[None, :] <= i[:, None]
    if window > 0:
        mask &= j[None, :] > i[:, None] - window
    return mask


def flash_attention_ref(q, k, v, window: int = 0, causal: bool = True, *,
                        return_lse: bool = False):
    """q (B,Sq,H,D); k,v (B,Sk,KVH,D) -> (B,Sq,H,D) in q.dtype.  Causal
    (Sq = Sk): query i sees keys j <= i, and with ``window`` > 0 (sliding
    window) only i - window < j <= i.  ``causal=False``: every key.
    ``return_lse``: also each query row's log-sum-exp of its scaled scores,
    (B, H, Sq) float32, as the kernel's lse output lays it out."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qr = q.reshape(B, Sq, KVH, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k.float()) / math.sqrt(D)
    if causal:
        mask = _causal(Sq, Sk, window, q.device)
        s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    o = o.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)                     # (B, Sq, KVH, G)
    return o, lse.permute(0, 2, 3, 1).reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, dout, window: int = 0,
                            causal: bool = True):
    """Gradients of GQA attention, recomputed from the forward's lse: q, o,
    dout (B, Sq, H, D), k, v (B, Sk, KVH, D), lse (B, H, Sq) float32 ->
    (dq, dk, dv) in the inputs' dtypes, in float32 throughout.  The mask is
    the forward's: causal (Sq = Sk), key j <= query i, and with ``window``
    > 0 only i - window < j <= i; ``causal=False``, every key j < Sk.
    P = exp(s - lse) under the mask, dV = P^T.dO, dS = P * (dO.V^T -
    rowsum(dO * O)) / sqrt(D), dQ = dS.K, dK = dS^T.Q, dK and dV summed over
    each kv head's group of G query heads."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qf = q.reshape(B, Sq, KVH, G, D).float()
    dof = dout.reshape(B, Sq, KVH, G, D).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kf) * scale
    if causal:
        mask = _causal(Sq, Sk, window, q.device)[None, :, None, None, :]
        s = s.masked_fill(~mask, float("-inf"))
    lse_r = lse.reshape(B, KVH, G, Sq).permute(0, 3, 1, 2)  # (B, Sq, KVH, G)
    p = torch.exp(s - lse_r[..., None])
    dv = torch.einsum("bqhgk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vf)
    delta = (dof * o.reshape(B, Sq, KVH, G, D).float()).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqhgk,bkhd->bqhgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bqhgk,bqhgd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
