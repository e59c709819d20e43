"""Layer primitives of the attention families (OPT, yi, minitron, gemma3)
and of the SSM family (mamba2), as plain functions on tensors.

Counterparts of ``repro.models.layers``: the norms compute in float32 and cast
back to the input dtype at the same point, so the port rounds where the
reference rounds.  The SSD scan of prefill goes through the hand-written
kernel's wrapper; the one-token SSD step and the causal conv are plain torch,
as the reference has no kernel for them.
"""
from __future__ import annotations

import math

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
