"""Wrapper of the hand-written CUDA flash-attention kernel (prefill).

A CUDA tensor launches ``csrc/flash_attention.cu`` on PyTorch's current
stream, or raises; a CPU tensor takes the plain version in ``ref.py``.
``flash_attention.launches`` counts the kernel's launches,
``flash_attention.window_launches`` again those of its sliding-window mode,
and ``flash_attention.noncausal_launches`` again those of its non-causal
mode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
MAX_D = 256
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _launch(q, k, v, out, window: int, causal: bool) -> None:
    lib, fn = _build.entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    B, Sq, H, D = q.shape
    dev = q.device.index
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, k.shape[1], H, k.shape[2], D, window, int(causal),
                 DTYPES[q.dtype], _build.current_stream(dev))
    _build.check(lib, err, "flash_attention_fwd")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """GQA attention forward: q (B,Sq,H,D), k/v (B,Sk,KVH,D) -> (B,Sq,H,D)
    in q.dtype.  Any lengths (the ragged tails are masked in-kernel).
    Causal (Sq = Sk): query i sees keys j <= i; ``window`` > 0 (sliding
    window): only i - window < j <= i (the local layers of the windowed
    family; ``.window_launches`` counts those launches again).
    ``causal=False``: every key, Sk free (the encoder's self-attention and
    the decoder's cross attention over the encoder's frames;
    ``.noncausal_launches`` counts those again); no window."""
    if window < 0:
        raise ValueError(f"flash_attention: window={window}")
    if not causal and window:
        raise ValueError(f"flash_attention: window={window} with causal=False "
                         "(no path attends through a bidirectional window)")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window, causal)
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
    out = torch.empty_like(q)
    _launch(q, k, v, out, window, causal)
    flash_attention.launches += 1
    flash_attention.window_launches += window > 0
    flash_attention.noncausal_launches += not causal
    return out


flash_attention.launches = 0
flash_attention.window_launches = 0
flash_attention.noncausal_launches = 0
