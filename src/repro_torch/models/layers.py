"""Layer primitives of the attention families (OPT, yi, minitron, gemma3,
and the MoE models dbrx and grok) and of the SSM family (mamba2), as plain
functions on tensors.

Counterparts of ``repro.models.layers``: the norms compute in float32 and cast
back to the input dtype at the same point, so the port rounds where the
reference rounds.  The SSD scan of prefill goes through the hand-written
kernel's wrapper; the one-token SSD step, the causal conv and the MoE
dispatch are plain torch, as the reference has no kernel for them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan


# --------------------------------------------------------------------------- norms

def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


#: epsilon of each norm type, as the functions above default it
NORM_EPS = {"rmsnorm": 1e-6, "layernorm": 1e-5}


def apply_norm(x, params, norm_type: str):
    if norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


# --------------------------------------------------------------------------- rope

def rope_sin_cos(positions, head_dim: int, theta: float):
    """positions (..., S) int -> sin/cos (..., S, head_dim//2) float32."""
    half = head_dim // 2
    # the frequencies in float64, rounded once: torch's float32 pow is an ulp
    # off the reference's in some of them, an error the angle multiplies by
    # the position (~1e-4 in sin at position 1e5)
    freq = (theta ** (-torch.arange(0, half, dtype=torch.float64,
                                    device=positions.device) / half)).float()
    angle = positions.float()[..., None] * freq
    return torch.sin(angle), torch.cos(angle)


def mrope_sin_cos(positions3, head_dim: int, theta: float,
                  sections=(1, 1, 1)):
    """Qwen2-VL's multimodal RoPE: positions3 (B, S, 3) int, the (temporal,
    height, width) position ids -> sin/cos (B, S, head_dim//2) float32.
    The rotary half-dim is split into three contiguous sections sized in
    proportion to ``sections`` (the remainder on the last), each rotated by
    its own position stream; with three equal streams (text) it is
    ``rope_sin_cos`` exactly.  Frequencies as ``rope_sin_cos`` takes them."""
    half = head_dim // 2
    total = sum(sections)
    sizes = [half * s // total for s in sections]
    sizes[-1] = half - sizes[0] - sizes[1]
    dev = positions3.device
    freq = (theta ** (-torch.arange(0, half, dtype=torch.float64, device=dev)
                      / half)).float()
    sec_id = torch.repeat_interleave(torch.arange(3, device=dev),
                                     torch.tensor(sizes, device=dev))
    pos = positions3.float()[..., sec_id]      # (B, S, half): each frequency's id
    angle = pos * freq
    return torch.sin(angle), torch.cos(angle)


def apply_rope(x, sin, cos):
    """x (B, S, H, D); sin/cos (B, S, D//2) -> rotated x (half-split layout),
    computed in float32 and cast back to x's dtype."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin, cos = sin[..., None, :], cos[..., None, :]    # broadcast over heads
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(dtype)


# --------------------------------------------------------------------------- attention

def decode_attention(q, k_cache, v_cache, *, kv_len):
    """Single-token attention: q (B, 1, H, D) vs cache (B, S, KVH, D).

    kv_len (B,) tensor or int: number of valid cache positions (the new
    token's K/V must already be written at kv_len-1).
    """
    B, _, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qr = q.reshape(B, KVH, G, D).float()
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                             device=q.device).expand(B)
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float()) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# --------------------------------------------------------------------------- ffn

def _act(x, kind: str):
    if kind in ("gated_silu", "silu"):
        return F.silu(x)
    if kind in ("gated_gelu", "gelu"):
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if kind == "relu":
        return F.relu(x)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def dense_ffn(params, x, ffn_type: str):
    """x (..., d) -> (..., d).  Gated variants hold w1 (in), w3 (gate), w2 (out)."""
    h = x @ params["w1"]
    if ffn_type.startswith("gated"):
        h = _act(h, ffn_type) * (x @ params["w3"])
    else:
        h = _act(h, ffn_type)
    return h @ params["w2"]


# --------------------------------------------------------------------------- moe

def _moe_groups(T: int, want: int = 32) -> int:
    for g in (want, 16, 8, 4, 2):
        if T % g == 0:
            return g
    return 1


def moe_capacity(tokens_per_group: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """C: each expert's slots per dispatch group, a multiple of 8, at least 8."""
    Tk = tokens_per_group * top_k
    return max(int(math.ceil(capacity_factor * Tk / num_experts / 8) * 8), 8)


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first among equals (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _renormalise(gate):
    return gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)


def _group_ranks(sorted_e, E: int):
    """sorted_e (G, Tk): each group's pairs' experts, sorted.  -> (counts
    (G, E): each expert's pairs in the group, starts (G, E): its first
    sorted position, rank (G, Tk): each pair's place among its expert's)."""
    G, Tk = sorted_e.shape
    counts = torch.zeros((G, E), dtype=torch.int64, device=sorted_e.device) \
        .scatter_add_(1, sorted_e, torch.ones_like(sorted_e))
    starts = counts.cumsum(1) - counts                          # exclusive
    rank = torch.arange(Tk, device=sorted_e.device)[None] \
        - starts.gather(1, sorted_e)
    return counts, starts, rank


def _inverse(order):
    """The permutation that takes sorted positions back to pair order."""
    return torch.argsort(order, dim=1, stable=True)


class MoeRoute(NamedTuple):
    """The dispatch of ``T = G·Tg`` tokens: ``probs`` (G, Tg, E) float32,
    ``gate``/``idx`` (G, Tg, k) each token's renormalised gates and experts,
    ``sorted_e``/``order`` (G, Tk) its group's pairs sorted by expert and
    where each came from, ``counts``/``starts`` (G, E), ``rank`` (G, Tk) each
    sorted pair's place among its expert's, ``C`` the capacity."""
    probs: torch.Tensor
    gate: torch.Tensor
    idx: torch.Tensor
    sorted_e: torch.Tensor
    order: torch.Tensor
    counts: torch.Tensor
    starts: torch.Tensor
    rank: torch.Tensor
    C: int


def moe_route(router, x, *, num_experts: int, top_k: int,
              capacity_factor: float) -> MoeRoute:
    """x (T, d): float32 router softmax, top-k gates renormalised;
    ``_moe_groups(T)`` groups of contiguous tokens, each sorting its (token,
    choice) pairs by expert (stable) and ranking them within their expert."""
    T, d = x.shape
    G = _moe_groups(T)
    Tg = T // G
    logits = x.reshape(G, Tg, d).float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                       # (G, Tg, E)
    gate, idx = _top_k(probs, top_k)
    gate = _renormalise(gate)
    sorted_e, order = torch.sort(idx.reshape(G, Tg * top_k), dim=1,
                                 stable=True)
    counts, starts, rank = _group_ranks(sorted_e, num_experts)
    return MoeRoute(probs, gate, idx, sorted_e, order, counts, starts, rank,
                    moe_capacity(Tg, top_k, num_experts, capacity_factor))


def moe_dropped(route: MoeRoute, top_k: int):
    """-> (T,) int64: each token's pairs ranked at or past the capacity."""
    G, Tk = route.order.shape
    tok = route.order // top_k + (torch.arange(G, device=route.order.device)
                                  * (Tk // top_k))[:, None]
    drop = (route.rank >= route.C).long()
    return torch.zeros(G * Tk // top_k, dtype=torch.int64,
                       device=drop.device).index_add_(0, tok.reshape(-1),
                                                      drop.reshape(-1))


def moe_ffn(params, x, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, ffn_type: str = "gated_silu"):
    """Token-choice MoE with group-local, sort-based capacity dispatch.
    x (T, d) flattened tokens -> (y (T, d) in x's dtype, Switch aux loss).

    The reference's semantics (``moe_route``): a pair ranked at or past
    the capacity C is dropped, a zero row whose gate is not renormalised
    away.  Every shape is static and nothing reads the device: the expert
    buffer is built by gather, the experts' products are one batched matmul
    each, a dropped pair reads an appended zero row.  The buffer is laid out
    experts first, (E, G, C), where the reference's is (G, E, C); both hold
    the same rows."""
    T, d = x.shape
    E, k = num_experts, top_k
    r = moe_route(params["router"], x, num_experts=E, top_k=k,
                  capacity_factor=capacity_factor)
    G, Tk = r.order.shape
    Tg, C, dev = Tk // k, r.C, x.device

    # slot c of expert e in group g: the pair at sorted position
    # starts[g, e] + c when c < counts[g, e], else a zero row
    c = torch.arange(C, device=dev)
    posn = (r.starts[:, :, None] + c).clamp(0, Tk - 1).reshape(G, E * C)
    tok = (r.order // k).gather(1, posn).reshape(G, E, C) \
        + (torch.arange(G, device=dev) * Tg)[:, None, None]
    valid = c < r.counts[:, :, None]                            # (G, E, C)
    buf = x[tok.transpose(0, 1)].masked_fill(
        ~valid.transpose(0, 1)[..., None], 0).reshape(E, G * C, d)

    h = torch.bmm(buf, params["we1"])                           # (E, G*C, f)
    if ffn_type.startswith("gated"):
        h = _act(h, ffn_type) * torch.bmm(buf, params["we3"])
    else:
        h = _act(h, ffn_type)
    out = torch.bmm(h, params["we2"]).reshape(E * G * C, d)
    out = torch.cat([out, out.new_zeros((1, d))])               # the drop row

    g_idx = torch.arange(G, device=dev)[:, None]
    row = torch.where(r.rank < C, (r.sorted_e * G + g_idx) * C + r.rank,
                      E * G * C)
    y_pairs = out[row.gather(1, _inverse(r.order))].reshape(G, Tg, k, d)
    y = (r.gate.to(x.dtype).float()[..., None] * y_pairs.float()).sum(2)

    # load-balance auxiliary loss (Switch-style, group-averaged)
    frac_tokens = r.counts.float().sum(0) / max(G * Tk, 1)
    frac_prob = r.probs.mean(dim=(0, 1))
    aux = E * (frac_tokens * frac_prob).sum()
    return y.reshape(T, d).to(x.dtype), aux


# --------------------------------------------------------------------------- mamba2 SSD

def ssd_chunked(x, dt, A, B, C, *, chunk: int):
    """Mamba-2 SSD forward over a whole sequence, from a zero state (every
    caller's): x (b, s, h, p); dt (b, s, h) float32, already softplus'ed; A
    (h,) negative; B, C (b, s, n), one group.  -> (y (b, s, h, p) in x's
    dtype, final state (b, h, p, n) float32).  The ``ssd_scan`` kernel on
    the card, its plain version on the CPU."""
    return ssd_scan(x, dt, A, B, C, chunk=chunk)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token SSD recurrence: state (b, h, p, n); x_t (b, h, p); dt_t
    (b, h); B_t, C_t (b, g, n).  -> (y (b, h, p) in x_t's dtype, new state
    in state's dtype)."""
    b, h, _, n = state.shape
    g = B_t.shape[1]
    # each group's row repeated over its h / g heads (jnp.repeat), by a view
    per_head = lambda t: t.float()[:, :, None].expand(b, g, h // g, n) \
        .reshape(b, h, n)
    Bh, Ch = per_head(B_t), per_head(C_t)                       # (b, h, n)
    dA = torch.exp(dt_t.float() * A.float())                    # (b, h)
    upd = (dt_t[..., None].float() * x_t.float())[..., None] \
        * Bh[:, :, None, :]
    new_state = state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state.to(state.dtype)


def causal_conv1d(x, w, cache=None):
    """Depthwise causal conv: x (b, s, ch), w (ch, width), as a float32 sum
    of ``width`` shifted products in order.  With ``cache`` (b, width - 1,
    ch), the rows before x, the conv is streaming (decode).  -> (y in x's
    dtype, new cache: the last width - 1 input rows, before any activation)."""
    width = w.shape[-1]
    pad = x.new_zeros((x.shape[0], width - 1, x.shape[2])) if cache is None \
        else cache
    xp = torch.cat([pad, x], 1)                                 # (b, s+w-1, ch)
    s = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        y = y + xp[:, i: i + s].float() * w[:, i].float()[None, None, :]
    new_cache = xp[:, -(width - 1):] if width > 1 else pad
    return y.to(x.dtype), new_cache
