"""The collectives between mesh positions of the single-controller serving
path: a sum over the model axis, an elementwise max over it, an all-gather
along a dimension, and the vocabulary argmax.  The reference has no counterpart: XLA inserts its
collectives.

A call takes one tensor per position (in the order of ``devices``) and
returns one per position.  Tensors move with ``.to(device)`` and are added or
concatenated on the first position's device, so a call works whether the
positions share a card or not; where they share one, ``.to`` moves nothing
and every position gets the same result tensor.  No call reads a value back
from the device.

Each call adds the bytes a ring algorithm would move between the positions
(summed over positions) to ``COUNTER``, whether or not the positions share a
device: a sum or a max of n bytes over m positions 2(m-1)n, an all-gather of
m parts of n bytes (m-1)mn.  The tracer and the metrics registry read it
(``record``)."""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence

import torch


class CollectiveCounter:
    """Bytes per collective kind (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes: Dict[str, int] = {}

    def add(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)

    def reset(self) -> None:
        with self._lock:
            self.bytes.clear()

    def read(self) -> Dict[str, int]:
        """``{kind: bytes}`` and ``"total"``."""
        with self._lock:
            out = dict(self.bytes)
        out["total"] = sum(out.values())
        return out


#: the process's collective traffic (reset by whoever measures a run)
COUNTER = CollectiveCounter()


def record(metrics) -> None:
    """Copy ``COUNTER`` into a ``MetricsRegistry`` as
    ``collective_bytes{kind=...}`` gauges."""
    for kind, n in COUNTER.read().items():
        metrics.gauge("collective_bytes", kind=kind).set(n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fan_out(t: torch.Tensor, devices) -> List[torch.Tensor]:
    return [t.to(d) for d in devices]


def sum_model(parts: Sequence[torch.Tensor], devices,
              kind: str = "sum") -> List[torch.Tensor]:
    """All-reduce: the sum of the positions' partials, left to right, on
    every position."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    m = len(parts)
    if m > 1:
        COUNTER.add(kind, 2 * (m - 1) * _nbytes(parts[0]))
    return _fan_out(acc, devices)


def max_model(parts: Sequence[torch.Tensor], devices,
              kind: str = "max") -> List[torch.Tensor]:
    """All-reduce: the elementwise max of the positions' parts, on every
    position (exact in any order)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(acc.device))
    m = len(parts)
    if m > 1:
        COUNTER.add(kind, 2 * (m - 1) * _nbytes(parts[0]))
    return _fan_out(acc, devices)


def all_gather(parts: Sequence[torch.Tensor], dim: int, devices,
               kind: str = "gather") -> List[torch.Tensor]:
    """The positions' parts concatenated along ``dim``, on every position
    (``devices``; one device gathers to that one)."""
    if len(parts) == 1:
        return _fan_out(parts[0], devices)
    dev = devices[0]
    full = torch.cat([p.to(dev) for p in parts], dim)
    m = len(parts)
    COUNTER.add(kind, (m - 1) * sum(_nbytes(p) for p in parts)
                * len(devices) // m)
    return _fan_out(full, devices)


def vocab_argmax(logits: Sequence[torch.Tensor], offsets: Sequence[int],
                 devices) -> List[torch.Tensor]:
    """Greedy tokens from vocabulary-split logits: each position's (max,
    index) over its slice (``logits[c]`` (..., V/m) float32, its first
    token id ``offsets[c]``), combined to the lowest global index among
    equal maxima, as ``argmax`` over the whole vocabulary takes the first.
    -> int32 (...) on every position."""
    if len(logits) == 1:
        return _fan_out(logits[0].argmax(-1).int(), devices)
    dev = devices[0]
    vals, idx = [], []
    for lg, off in zip(logits, offsets):
        m, i = lg.max(-1)           # the first maximal index of the slice
        vals.append(m.to(dev))
        idx.append((i + off).to(dev))
    vals, idx = torch.stack(vals), torch.stack(idx)
    # the first shard holding the maximum holds its lowest global index
    best = vals.argmax(0, keepdim=True)
    tok = idx.gather(0, best)[0].int()
    m = len(logits)
    COUNTER.add("argmax", (m - 1) * m * (_nbytes(vals[0]) + _nbytes(idx[0])))
    return _fan_out(tok, devices)
