"""Wrapper of the hand-written CUDA SSD scan kernel (Mamba-2 prefill).

A CUDA tensor launches ``csrc/ssd_scan.cu`` on PyTorch's current stream, or
raises; a CPU tensor takes the plain version in ``ref.py``.  On the card one
call runs two kernels: a Gram pass (C B^T once per request and chunk, into a
float32 scratch) and the scan, split across blocks along the head dim, its
chunk products on the tensor cores with each float32-derived operand split
into hi + lo pieces (bfloat16 pieces for bfloat16 inputs, TF32 for float16;
``ssd_scan_split_ref`` in ``ref.py`` is the same algorithm in plain
PyTorch).  ``ssd_scan.launches`` counts the calls that launch them.

Layout (as ``repro.kernels.ssd_scan.kernel``, one group of B/C):
  x      (b, s, h, p)   float16 or bfloat16 on the card
  dt     (b, s, h)      float32, already softplus'ed
  A      (h,)           float32, negative
  B, C   (b, s, n)      x's dtype
  -> y (b, s, h, p) in x's dtype, final state (b, h, p, n) float32

x, B and C come to the model's ``ssd_full`` as slices of one projection; the
kernel reads them through their batch and row strides (by TMA), so they are
passed as they are, with no copy.  Each needs its last dim contiguous (and
x's heads ``p`` apart), a 16-byte aligned start and strides of multiples of
8 elements.  Any s: the ragged tail is masked in the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
MAX_CHUNK, MAX_P, MAX_N = 64, 64, 128
# planted faults and diagnostics of the card's kernels (``flags``; 0 on the
# model's path)
FAULTS = {"drop_lo_terms": 1, "previous_chunk_gram": 2}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
    [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch(x, dt, A, B, C, y, state, chunk: int, flags: int) -> None:
    """The card's two kernels on the current stream, C B^T in a float32
    scratch of b * ceil(s / chunk) * 64 * 64 values."""
    b, s, h, p = x.shape
    gram = torch.empty(b * -(-s // chunk) * 64 * 64, dtype=torch.float32,
                       device=x.device)
    lib, fn = _build.entry("ssd_scan", "ssd_scan_fwd", _ARGTYPES)
    idx = x.device.index
    with _build.on_device(idx):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), state.data_ptr(), gram.data_ptr(),
                 b, s, h, p, B.shape[-1], chunk, x.stride(0), x.stride(1),
                 B.stride(0), B.stride(1), C.stride(0), C.stride(1),
                 DTYPES[x.dtype], flags, _build.current_stream(idx))
    _build.check(lib, err, "ssd_scan_fwd")


def _validate(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} is not (b, s, h, p)")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) \
            or C.shape != (b, s, n):
        raise ValueError(f"ssd_scan: bad shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} A{tuple(A.shape)} "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype \
            or dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dtypes x {x.dtype}, B {B.dtype}, "
                         f"C {C.dtype}, dt {dt.dtype}, A {A.dtype}")
    for what, v, top in (("chunk", chunk, MAX_CHUNK), ("p", p, MAX_P),
                         ("n", n, MAX_N)):
        if v <= 0 or v % 16 or v > top:
            raise ValueError(f"ssd_scan: {what}={v} not a multiple of 16 up "
                             f"to {top}")
    if s == 0:
        raise ValueError("ssd_scan: empty sequence")
    if x.stride(3) != 1 or x.stride(2) != p or B.stride(2) != 1 \
            or C.stride(2) != 1 or not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_scan: x, B, C need their last dim contiguous "
                         "(x's heads p apart), dt and A contiguous")
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("ssd_scan: tensors on more than one device")
    steps = [t.stride(1) for t in (x, B, C)] + \
        ([t.stride(0) for t in (x, B, C)] if b > 1 else [])
    if any(st % 8 for st in steps) or any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan: x, B and C need 16-byte aligned starts and "
                         "strides of multiples of 8 elements (TMA)")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64):
    """Mamba-2 chunked SSD forward from a zero state -> (y, final_state);
    see the module docstring for the layout."""
    return _ssd_scan(x, dt, A, B, C, chunk=chunk)


def _ssd_scan(x, dt, A, B, C, *, chunk: int = 64, flags: int = 0):
    """``ssd_scan`` with ``flags``, the card's planted faults and its
    diagnostic (``FAULTS``; chip_smoke.py reads them)."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    _validate(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, B.shape[-1]), dtype=torch.float32,
                        device=x.device)
    _launch(x, dt, A, B, C, y, state, chunk, flags)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
