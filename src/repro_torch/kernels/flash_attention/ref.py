"""Plain PyTorch versions of the flash-attention kernels: masked softmax
attention with the whole score matrix in float32 (counterpart of
``repro.kernels.flash_attention.ref``), and its backward from the forward's
lse in the same three modes (counterpart of the custom VJP ``_bw_attn_b`` of
``repro.models.layers``, whose mask is ``_tile_mask``).
``flash_attention_bwd_split_ref`` is the card's backward algorithm
(csrc/flash_attention_bwd.cuh) in plain PyTorch: a block per (query head,
64-key tile), the query tiles it visits, P and dS rounded to the inputs'
dtype before their products, and dK/dV summed over each group's heads in
head order."""
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


# the card's backward: keys per block, and queries per tile at head_dim D
BWD_BKV = 64


def bwd_query_tile(D: int) -> int:
    return 64 if D > 128 else 128


def bwd_tiles(Sq: int, Sk: int, D: int, window: int = 0,
              causal: bool = True) -> list:
    """The card's backward blocks of one (query head, request), in launch
    order (the key tile slowest, so the causal grid starts with its longest
    blocks): [(k0, [q0 of each query tile it visits])].  Causal, the tiles
    from the one holding key k0 on, and with a window only those before
    k0 + 63 + window; non-causal, every query tile."""
    BQ = bwd_query_tile(D)
    out = []
    for k0 in range(0, Sk, BWD_BKV):
        q_lo = k0 // BQ * BQ if causal else 0
        q_hi = min(Sq, k0 + BWD_BKV - 1 + window) if causal and window > 0 \
            else Sq
        out.append((k0, list(range(q_lo, q_hi, BQ))))
    return out


def flash_attention_bwd_split_ref(q, k, v, o, lse, dout, window: int = 0,
                                  causal: bool = True):
    """``flash_attention_bwd_ref``'s function by the card's algorithm, in
    float32 with the kernel's roundings: per (query head, 64-key tile) block
    (``bwd_tiles``) and per query tile it visits, S^T = K.Q^T and dP^T =
    V.dO^T, P^T = exp(S^T / sqrt(D) - lse) under the mask, dS^T = P^T
    (dP^T - Delta) / sqrt(D); dV += P^T.dO and dK += dS^T.Q into the
    block's per-head partials, and dQ += dS.K in key-tile order, with P and
    dS rounded to the inputs' dtype before these products (float16 and
    bfloat16; float32 inputs are not rounded).  dK and dV are the group's G
    partials summed in head order.  -> (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    rnd = (lambda t: t.to(q.dtype).float()) if q.dtype in (
        torch.float16, torch.bfloat16) else (lambda t: t)
    qf, dof = q.float(), dout.float()
    kh = k.float().repeat_interleave(G, dim=2)           # a head's own K, V
    vh = v.float().repeat_interleave(G, dim=2)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)   # (B, H, Sq)
    BQ = bwd_query_tile(D)
    dq = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
    part_k = torch.zeros((B, Sk, H, D), dtype=torch.float32, device=q.device)
    part_v = torch.zeros_like(part_k)
    for k0, q0s in bwd_tiles(Sq, Sk, D, window, causal):
        keys = slice(k0, min(k0 + BWD_BKV, Sk))
        kt, vt = kh[:, keys], vh[:, keys]                 # (B, nk, H, D)
        key = torch.arange(keys.start, keys.stop, device=q.device)[:, None]
        for q0 in q0s:
            rows = slice(q0, min(q0 + BQ, Sq))
            qt, dot = qf[:, rows], dof[:, rows]           # (B, nq, H, D)
            qi = torch.arange(rows.start, rows.stop, device=q.device)[None]
            ok = torch.ones((key.shape[0], qi.shape[1]), dtype=torch.bool,
                            device=q.device)
            if causal:
                ok = key <= qi
                if window > 0:
                    ok &= key > qi - window
            st = torch.einsum("bkhd,bqhd->bhkq", kt, qt) * scale
            pt = torch.where(ok, torch.exp(st - lse[:, :, None, rows]), 0.0)
            dpt = torch.einsum("bkhd,bqhd->bhkq", vt, dot)
            dst = pt * (dpt - delta[:, :, None, rows]) * scale
            part_v[:, keys] += torch.einsum("bhkq,bqhd->bkhd", rnd(pt), dot)
            part_k[:, keys] += torch.einsum("bhkq,bqhd->bkhd", rnd(dst), qt)
            dq[:, rows] += torch.einsum("bhkq,bkhd->bqhd", rnd(dst), kt)

    def group_sum(part):
        part = part.view(B, Sk, KVH, G, D)
        acc = part[..., 0, :]
        for g in range(1, G):
            acc = acc + part[..., g, :]
        return acc

    return (dq.to(q.dtype), group_sum(part_k).to(k.dtype),
            group_sum(part_v).to(v.dtype))
