"""Wrappers of the hand-written CUDA flash-attention kernels: the forward
(prefill and training) and its backward (training), each causal, with a
sliding window, or non-causal.

A CUDA tensor launches ``csrc/flash_attention.cu`` (and, for a gradient, its
backward in ``csrc/flash_attention_bwd.cuh``, built into the same library)
on PyTorch's current stream, or raises; a
CPU or ``meta`` tensor takes the plain versions in ``ref.py``, under
autograd too.
``flash_attention.launches`` counts the forward kernel's launches,
``flash_attention.window_launches`` again those of its sliding-window mode,
``flash_attention.noncausal_launches`` again those of its non-causal mode,
and ``flash_attention.bwd_launches`` the backward's (one C call: the Delta
pre-pass, the main pass on ``wgmma`` with one block per (query head, request,
64-key tile), and a last pass that rounds dQ and, for G > 1, sums each
group's per-head dK/dV partials in head order; ``flash_attention_bwd_split_ref``
in ``ref.py`` is the same algorithm in plain PyTorch), ``.bwd_window_launches``,
``.bwd_noncausal_launches`` and ``.bwd_hd256_launches`` again those of its
window mode, its non-causal mode and head_dim 256.

Where q, k or v requires a gradient, ``flash_attention`` runs as a
``torch.autograd.Function``: its forward launches the kernel with the lse
output ((B, H, S) float32, m + log l of each query row), and its backward
launches the backward kernel on the saved q, k, v, output and lse, in the
forward's mode (causal, window or non-causal with Sk free), at D 64, 128 or
256 (``BWD_D``: the head_dims of the models the port trains).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
MAX_D = 256
BWD_D = (64, 128, 256)
# planted faults of the backward kernel (``flags``; 0 on every model path),
# and a diagnostic: the main pass adds no dQ (what the dQ adds cost)
FAULTS = {"no_causal_mask": 1, "no_group_sum": 2, "no_window": 4,
          "sk_as_sq": 8, "diag_no_dq_add": 16}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
TRAINS = (f"the flash kernel's gradient is built for head_dim {BWD_D} (the "
          "models the port trains); another head_dim has no instantiation")


def _launch(q, k, v, out, window: int, causal: bool, lse=None) -> None:
    lib, fn = _build.entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    B, Sq, H, D = q.shape
    dev = q.device.index
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, Sq, k.shape[1], H, k.shape[2], D, window, int(causal),
                 DTYPES[q.dtype], _build.current_stream(dev))
    _build.check(lib, err, "flash_attention_fwd")


def _check(q, k, v, causal: bool, window: int) -> None:
    """The card kernel's refusals (shapes, dtypes, layout)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B \
            or (causal and k.shape[1] != Sq) or k.shape[3] != D \
            or H % k.shape[2]:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if D > MAX_D or D % 16:
        raise ValueError(f"flash_attention: head_dim {D} not a multiple of 16 "
                         f"up to {MAX_D}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k, v must be contiguous and "
                             "16-byte aligned on one device (TMA reads them)")


def _check_grad(D: int) -> None:
    if D not in BWD_D:
        raise ValueError(f"flash_attention: no gradient at head_dim {D}; "
                         + TRAINS)


def _count(window: int, causal: bool) -> None:
    flash_attention.launches += 1
    flash_attention.window_launches += window > 0
    flash_attention.noncausal_launches += not causal


def _check_mode(causal: bool, window: int) -> None:
    if window < 0:
        raise ValueError(f"flash_attention: window={window}")
    if not causal and window:
        raise ValueError(f"flash_attention: window={window} with causal=False "
                         "(no path attends through a bidirectional window)")


def flash_attention_lse(q, k, v, window: int = 0, causal: bool = True):
    """The forward with each query row's log-sum-exp, in any of its modes:
    -> (out (B, Sq, H, D) in q.dtype, lse (B, H, Sq) float32).  On the card
    one launch of the kernel (counted as ``flash_attention``'s); a CPU
    tensor takes the plain version."""
    _check_mode(causal, window)
    if _build.plain(q):
        return flash_attention_ref(q, k, v, window, causal, return_lse=True)
    _check(q, k, v, causal, window)
    B, Sq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch(q, k, v, out, window, causal, lse)
    _count(window, causal)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The kernel with a gradient: the forward saves (q, k, v, out, lse) and
    the mode, the backward launches ``flash_attention_bwd`` in that mode."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        out, lse = flash_attention_lse(q, k, v, window, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        return flash_attention_bwd(*ctx.saved_tensors, dout.contiguous(),
                                   window=ctx.window, causal=ctx.causal) \
            + (None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """GQA attention forward: q (B,Sq,H,D), k/v (B,Sk,KVH,D) -> (B,Sq,H,D)
    in q.dtype.  Any lengths (the ragged tails are masked in-kernel).
    Causal (Sq = Sk): query i sees keys j <= i; ``window`` > 0 (sliding
    window): only i - window < j <= i (the local layers of the windowed
    family; ``.window_launches`` counts those launches again).
    ``causal=False``: every key, Sk free (the encoder's self-attention and
    the decoder's cross attention over the encoder's frames;
    ``.noncausal_launches`` counts those again); no window.  Where autograd
    records (grad mode on and q, k or v requiring a gradient), the card runs
    the kernel with its hand-written backward in the same mode (head_dims
    ``BWD_D``); a CPU tensor differentiates the plain version."""
    _check_mode(causal, window)
    if _build.plain(q):
        return flash_attention_ref(q, k, v, window, causal)
    _check(q, k, v, causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _check_grad(q.shape[3])
        return _FlashAttention.apply(q, k, v, window, causal)
    out = torch.empty_like(q)
    _launch(q, k, v, out, window, causal)
    _count(window, causal)
    return out


def _launch_bwd(q, k, v, o, lse, dout, window: int, causal: bool, flags: int):
    lib, fn = _build.entry("flash_attention", "flash_attention_bwd",
                           _BWD_ARGTYPES)
    B, Sq, H, D = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # scratch: dQ's float32 accumulator and Delta, written by the pre-pass;
    # with G > 1 the per-head float32 dK and dV partials the last pass sums
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    kv_part = torch.empty((2, B, k.shape[1], H, D), dtype=torch.float32,
                          device=q.device) if H > k.shape[2] else None
    dev = q.device.index
    with _build.on_device(dev):
        err = fn(*(t.data_ptr() for t in (q, k, v, o, lse, dout, dq, dk, dv,
                                          dq_acc, delta)),
                 None if kv_part is None else kv_part.data_ptr(),
                 B, Sq, k.shape[1], H, k.shape[2], D, window, int(causal),
                 DTYPES[q.dtype], flags, _build.current_stream(dev))
    _build.check(lib, err, "flash_attention_bwd")
    return dq, dk, dv


def _flash_attention_bwd(q, k, v, o, lse, dout, *, window: int = 0,
                         causal: bool = True, flags: int = 0):
    """``flash_attention_bwd`` with ``flags``, the card's planted faults
    (``FAULTS``); the launch is counted in ``flash_attention.bwd_launches``
    (and its mode's counter) only with ``flags`` 0."""
    _check_mode(causal, window)
    if _build.plain(q):
        return flash_attention_bwd_ref(q, k, v, o, lse, dout, window, causal)
    _check(q, k, v, causal, window)
    _check_grad(q.shape[3])
    B, Sq, H, D = q.shape
    for t in (o, dout):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention_bwd: o and dout must be "
                             "contiguous, 16-byte aligned, of q's shape and "
                             "dtype on its device")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want ({B}, {H}, {Sq}) float32")
    out = _launch_bwd(q, k, v, o, lse, dout, window, causal, flags)
    if flags == 0:
        flash_attention.bwd_launches += 1
        flash_attention.bwd_window_launches += window > 0
        flash_attention.bwd_noncausal_launches += not causal
        flash_attention.bwd_hd256_launches += D == 256
    return out


def flash_attention_bwd(q, k, v, o, lse, dout, *, window: int = 0,
                        causal: bool = True):
    """Gradients of GQA attention in the forward's mode: q, o, dout (B, Sq,
    H, D), k, v (B, Sk, KVH, D), lse (B, H, Sq) float32 from the forward ->
    (dq, dk, dv) in the inputs' dtypes.  Causal (Sq = Sk) with an optional
    sliding ``window``, or ``causal=False`` over every key.  One launch of
    the backward kernel on the card (counted in
    ``flash_attention.bwd_launches``); a CPU tensor takes
    ``flash_attention_bwd_ref``."""
    return _flash_attention_bwd(q, k, v, o, lse, dout, window=window,
                                causal=causal)


flash_attention.launches = 0
flash_attention.window_launches = 0
flash_attention.noncausal_launches = 0
flash_attention.bwd_launches = 0
flash_attention.bwd_window_launches = 0
flash_attention.bwd_noncausal_launches = 0
flash_attention.bwd_hd256_launches = 0
