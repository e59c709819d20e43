"""Wrapper of the hand-written CUDA SSD scan kernel (Mamba-2 prefill).

A CUDA tensor launches ``csrc/ssd_scan.cu`` on PyTorch's current stream, or
raises; a CPU or ``meta`` tensor takes the plain version in ``ref.py``.
On the card one call runs two kernels: a Gram pass (C B^T once per request
and chunk, into a float32 scratch) and the scan, split across blocks along
the head dim, its chunk products on the tensor cores with each
float32-derived operand split into hi + lo pieces (bfloat16 pieces for bfloat16 inputs, TF32 for float16;
``ssd_scan_split_ref`` in ``ref.py`` is the same algorithm in plain
PyTorch).  ``ssd_scan.launches`` counts the calls that launch them.

Where autograd records (grad mode on and any input requiring a gradient),
``ssd_scan`` runs as a ``torch.autograd.Function``: its forward launches the
same kernels and saves x, dt, A, B and C (x, B and C as the strided slices
they came as), and its backward launches ``csrc/ssd_scan_bwd.cuh`` (built
into the same library) with dy and the final state's cotangent (None where
nothing reads the state).  The backward is built for P = 64, N = 128 and
chunk 64 (``BWD_SHAPE``: mamba2-2.7b's and jamba's); on the card another
shape raises.  ``ssd_scan.bwd_launches`` counts its C calls.  On the card a
call runs three kernels: a state pass (each chunk's entering state and its
cotangent, walked once each way per (head, request), stored as hi + lo
pieces), a chunk pass on ``wgmma`` (one block per (head group, chunk,
request); dB and dC summed over the group's heads inside the block, in head
order) and a last pass that sums the head groups' parts and dA's in order;
``ssd_scan_bwd_split_ref`` in ``ref.py`` is the same algorithm in plain
PyTorch.  A CPU tensor differentiates the plain version.

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
from repro_torch.kernels.ssd_scan.ref import (head_groups, ssd_chunked_ref,
                                              ssd_scan_bwd_ref)

# the dtypes the kernel is built and checked on the card for
DTYPES = {torch.float16: 1, torch.bfloat16: 2}
MAX_CHUNK, MAX_P, MAX_N = 64, 64, 128
# (p, n, chunk): the one shape the backward kernel is built for
BWD_SHAPE = (64, 128, 64)
# planted faults and diagnostics of the card's kernels (``flags``; 0 on the
# model's path): the forward's, then the backward's
FAULTS = {"drop_lo_terms": 1, "previous_chunk_gram": 2,
          "bwd_state_not_carried": 4, "bwd_heads_not_summed": 8,
          "diag_bwd_no_state_stores": 16, "diag_bwd_chunk_loads_only": 64,
          "diag_bwd_chunk_compute_only": 128}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + \
    [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + \
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


class _SsdScan(torch.autograd.Function):
    """The kernel with a gradient: the forward saves x, dt, A, B and C, the
    backward launches ``ssd_scan_bwd`` with dy and the final state's
    cotangent."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _ssd_scan(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return ssd_scan_bwd(x, dt, A, B, C, dy, dfinal, chunk=ctx.chunk) \
            + (None,)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64):
    """Mamba-2 chunked SSD forward from a zero state -> (y, final_state);
    see the module docstring for the layout.  Where autograd records, the
    card runs it with its hand-written backward (``BWD_SHAPE``); a CPU
    tensor differentiates the plain version."""
    if x.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        _check_bwd(x, B, chunk)
        return _SsdScan.apply(x, dt, A, B, C, chunk)
    return _ssd_scan(x, dt, A, B, C, chunk=chunk)


def _ssd_scan(x, dt, A, B, C, *, chunk: int = 64, flags: int = 0):
    """``ssd_scan`` with ``flags``, the card's planted faults and its
    diagnostic (``FAULTS``; chip_smoke.py reads them)."""
    if _build.plain(x):
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


def _check_bwd(x, B, chunk: int) -> None:
    shape = (x.shape[-1], B.shape[-1], chunk)
    if shape != BWD_SHAPE:
        raise ValueError(f"ssd_scan: no gradient at (p, n, chunk) {shape}; "
                         f"the backward kernel is built for {BWD_SHAPE} "
                         "(the models the port trains)")


def _launch_bwd(x, dt, A, B, C, dy, dfinal, chunk: int, flags: int):
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    nc = -(-s // chunk)
    hg = head_groups(b, nc, h, torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dA = torch.empty((h,), dtype=torch.float32, device=dev)
    dB, dC = (torch.empty((b, s, n), dtype=x.dtype, device=dev)
              for _ in range(2))
    # scratch: each chunk's entering state and its cotangent as hi + lo
    # pieces, the head groups' float32 parts of dC and dB, dA's parts per
    # (request, chunk, head)
    planes = torch.empty((4, b, nc, h, 2, p, n // 2), dtype=x.dtype, device=dev)
    part_bc = torch.empty((2, b, s, hg, n), dtype=torch.float32, device=dev)
    part_a = torch.empty((b, nc, h), dtype=torch.float32, device=dev)
    lib, fn = _build.entry("ssd_scan", "ssd_scan_bwd", _BWD_ARGTYPES)
    with _build.on_device(dev.index):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), dy.data_ptr(),
                 None if dfinal is None else dfinal.data_ptr(),
                 dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                 dC.data_ptr(), planes.data_ptr(), part_bc.data_ptr(),
                 part_a.data_ptr(), b, s, h, p, n, chunk, hg, x.stride(0),
                 x.stride(1), B.stride(0), B.stride(1), C.stride(0),
                 C.stride(1), DTYPES[x.dtype], flags,
                 _build.current_stream(dev.index))
    _build.check(lib, err, "ssd_scan_bwd")
    return dx, ddt, dA, dB, dC


def _ssd_scan_bwd(x, dt, A, B, C, dy, dfinal=None, *, chunk: int = 64,
                  flags: int = 0):
    """``ssd_scan_bwd`` with ``flags``, the card's planted faults
    (``FAULTS``); the launch is counted in ``ssd_scan.bwd_launches`` only
    with ``flags`` 0."""
    if _build.plain(x):
        return ssd_scan_bwd_ref(x, dt, A, B, C, dy, dfinal, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {x.device}")
    _validate(x, dt, A, B, C, chunk)
    _check_bwd(x, B, chunk)
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} on {dy.device}, "
                         f"want x's {tuple(x.shape)} on {x.device}")
    if dfinal is not None:
        b, _, h, p = x.shape
        if dfinal.shape != (b, h, p, B.shape[-1]) or dfinal.device != x.device:
            raise ValueError(f"ssd_scan_bwd: dfinal {tuple(dfinal.shape)}, "
                             f"want {(b, h, p, B.shape[-1])}")
        dfinal = dfinal.float().contiguous()
    out = _launch_bwd(x, dt, A, B, C, dy, dfinal, chunk, flags)
    if flags == 0:
        ssd_scan.bwd_launches += 1
    return out


def ssd_scan_bwd(x, dt, A, B, C, dy, dfinal=None, *, chunk: int = 64):
    """Gradients of ``ssd_scan`` (from a zero state): dy (b, s, h, p), the
    cotangent of y, and ``dfinal`` (b, h, p, n), that of the final state
    (None: zero) -> (dx, ddt, dA, dB, dC) of the inputs' shapes; dx, dB and
    dC in x's dtype, ddt and dA float32.  One C call on the card (the state
    pass, the chunk pass and the last pass; every sum in a fixed order: the
    same gradients every run; counted in ``ssd_scan.bwd_launches``); a CPU
    tensor takes ``ssd_scan_bwd_ref``."""
    return _ssd_scan_bwd(x, dt, A, B, C, dy, dfinal, chunk=chunk)


ssd_scan.launches = 0
ssd_scan.bwd_launches = 0
