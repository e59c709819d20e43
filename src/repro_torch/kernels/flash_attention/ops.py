"""Wrapper of the hand-written CUDA flash-attention kernel (prefill).

A CUDA tensor launches ``csrc/flash_attention.cu`` on PyTorch's current
stream, or raises; a CPU tensor takes the plain version in ``ref.py``.
``flash_attention.launches`` counts the kernel's launches, and
``flash_attention.window_launches`` again those of its sliding-window mode.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
MAX_D = 256
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _launch(q, k, v, out, window: int) -> None:
    lib, fn = _build.entry("flash_attention", "flash_attention_fwd", _ARGTYPES)
    B, S, H, D = q.shape
    dev = q.device.index
    with _build.on_device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], D, window, DTYPES[q.dtype],
                 _build.current_stream(dev))
    _build.check(lib, err, "flash_attention_fwd")


def flash_attention(q, k, v, *, window: int = 0):
    """Causal GQA attention forward: q (B,S,H,D), k/v (B,S,KVH,D) ->
    (B,S,H,D) in q.dtype.  Any S (the ragged tail is masked in-kernel).
    ``window`` > 0: sliding window, query i sees keys i - window < j <= i
    (the local layers of the windowed family); ``.window_launches`` counts
    those launches again."""
    if window < 0:
        raise ValueError(f"flash_attention: window={window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, S) \
            or k.shape[3] != D or H % k.shape[2]:
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
    _launch(q, k, v, out, window)
    flash_attention.launches += 1
    flash_attention.window_launches += window > 0
    return out


flash_attention.launches = 0
flash_attention.window_launches = 0
