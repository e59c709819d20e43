"""Pinned host-side pools for the offload runtime (paper §4.1, Fig. 7);
counterpart of ``repro.offload.host_pool`` for one device.

Two pools, both allocated ONCE and reused across groups:

* ``HostWeightPool`` — per-layer weight shards copied to host memory at
  construction (the streamed tier) plus the small resident tree (embedding,
  positions, final norm, unembedding), which lives on the device.  Each
  layer's leaves are views of ONE flat host buffer, so a layer crosses the
  link as one copy.  On CUDA the buffers are page-locked (``pin_memory``),
  which is what lets a copy from them run as an asynchronous DMA; a pinning
  failure raises and never falls back to pageable memory.  For the CPU
  (``device="cpu"``, the tests) they are plain tensors.
* ``HostBlockPool`` — a byte arena sized in BLOCK_TOKENS-granular cache
  blocks, with a contiguous-run allocator.  Spilled KV regions live here
  between decode steps; ``Region.view`` carves typed torch views out of an
  allocated region, so spill data is written and read in place with no
  steady-state host allocation (the CPU lane reads them through ``.numpy()``).

``BlockManager`` (core/blocks.py) accounts the same blocks logically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import BLOCK_TOKENS, kv_block_bytes


def host_empty(nbytes: int, device) -> torch.Tensor:
    """A flat uint8 host buffer, page-locked when ``device`` is a CUDA
    device (raises if it cannot be pinned)."""
    pin = torch.device(device).type == "cuda"
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class LayerLayout:
    """Byte layout of one layer's weights in a flat buffer: each leaf at a
    16-byte-aligned offset.  Every layer of a uniform model shares it."""

    def __init__(self, layer_tree):
        self.leaves: List[Tuple[tuple, tuple, torch.dtype, int]] = []
        off = 0
        for path, t in _flatten(layer_tree):
            off = -(-off // 16) * 16
            self.leaves.append((path, tuple(t.shape), t.dtype, off))
            off += t.numel() * t.element_size()
        self.nbytes = off

    def views(self, buf: torch.Tensor) -> Dict[str, Any]:
        """The layer tree as views of the flat uint8 ``buf``."""
        tree: Dict[str, Any] = {}
        for path, shape, dtype, off in self.leaves:
            n = int(torch.Size(shape).numel()) * dtype.itemsize
            _set(tree, path, buf[off:off + n].view(dtype).view(shape))
        return tree


class HostWeightPool:
    """Per-layer weight shards on the host + the device-resident remainder.

    ``params`` is the port's params dict (stacked ``params["layers"]``,
    leading axis = layer), on any device.  Each layer is copied into its
    own flat host buffer, pinned when ``device`` is CUDA; the rest of the
    tree is copied to ``device``.  Several engines may share one pool.
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *,
                 device="cuda"):
        assert "layers" in params, "host offload drives uniform-family models"
        self.cfg = cfg
        self.device = torch.device(device)
        self.resident = {k: _to(v, self.device) for k, v in params.items()
                         if k != "layers"}
        stacked = params["layers"]
        first = _index(stacked, 0)
        self.layout = LayerLayout(first)
        self._bufs: List[torch.Tensor] = []
        self._layers: List[Dict[str, Any]] = []
        for l in range(cfg.num_layers):
            buf = host_empty(self.layout.nbytes, self.device)
            tree = self.layout.views(buf)
            for path, src in _flatten(_index(stacked, l)):
                dst = tree
                for k in path:
                    dst = dst[k]
                dst.copy_(src)
            self._bufs.append(buf)
            self._layers.append(tree)
        self.layer_nbytes = [self.layout.nbytes] * cfg.num_layers

    def layer(self, l: int):
        """Host tree of layer ``l``'s weights (views of ``buffer(l)``)."""
        return self._layers[l]

    def buffer(self, l: int) -> torch.Tensor:
        """Layer ``l``'s flat host buffer (what one copy moves)."""
        return self._bufs[l]

    @property
    def pinned(self) -> bool:
        return all(b.is_pinned() for b in self._bufs)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclass
class Region:
    """A contiguous run of blocks carved from the ``HostBlockPool`` arena."""
    pool: "HostBlockPool"
    offset: int               # first block slot
    n_blocks: int

    @property
    def nbytes(self) -> int:
        return self.n_blocks * self.pool.block_bytes

    def view(self, shape: Tuple[int, ...], dtype: torch.dtype,
             at: int = 0) -> torch.Tensor:
        """Reinterpret the region's bytes from byte ``at`` on as a tensor
        (in-place view); ``at`` a multiple of the dtype's size."""
        need = int(torch.Size(shape).numel()) * dtype.itemsize
        if at + need > self.nbytes or at % dtype.itemsize:
            raise ValueError(f"view of {need} B at {at} does not fit a region "
                             f"of {self.nbytes} B")
        start = self.offset * self.pool.block_bytes + at
        return self.pool.arena[start: start + need].view(dtype).view(shape)

    def free(self) -> None:
        self.pool.free(self)


class HostBlockPool:
    """Fixed-capacity host arena for spilled cache blocks (pinned when its
    device is CUDA).

    One block slot holds ``block_bytes`` (all-layer bytes of BLOCK_TOKENS
    tokens of one representation).  Allocation is contiguous-run first-fit
    with coalescing frees, so a whole per-group KV region comes out as a
    single viewable span.
    """

    def __init__(self, capacity_blocks: int, block_bytes: int, device="cuda"):
        assert capacity_blocks >= 0 and block_bytes > 0
        self.capacity = int(capacity_blocks)
        self.block_bytes = int(block_bytes)
        self.arena = host_empty(self.capacity * self.block_bytes, device)
        self.arena.zero_()
        # free runs as sorted, disjoint, non-adjacent (start, length) pairs
        self._runs: List[Tuple[int, int]] = (
            [(0, self.capacity)] if self.capacity else [])
        self.allocated_blocks = 0
        self._live: Dict[int, int] = {}       # offset -> n_blocks

    # ------------------------------------------------------------------ alloc
    def alloc(self, n_blocks: int) -> Optional[Region]:
        """First-fit a contiguous run; None when no run is large enough."""
        if n_blocks <= 0:
            raise ValueError("n_blocks must be positive")
        for i, (start, length) in enumerate(self._runs):
            if length >= n_blocks:
                if length == n_blocks:
                    self._runs.pop(i)
                else:
                    self._runs[i] = (start + n_blocks, length - n_blocks)
                self.allocated_blocks += n_blocks
                self._live[start] = n_blocks
                return Region(self, start, n_blocks)
        return None

    def free(self, region: Region) -> None:
        n = self._live.pop(region.offset, None)
        if n is None:
            raise ValueError(f"double free / unknown region @{region.offset}")
        assert n == region.n_blocks
        self.allocated_blocks -= n
        self._runs.append((region.offset, n))
        self._runs.sort()
        # coalesce adjacent runs so reuse stays contiguous
        merged: List[Tuple[int, int]] = []
        for start, length in self._runs:
            if merged and merged[-1][0] + merged[-1][1] == start:
                merged[-1] = (merged[-1][0], merged[-1][1] + length)
            else:
                merged.append((start, length))
        self._runs = merged

    # ---------------------------------------------------------------- queries
    @property
    def free_blocks(self) -> int:
        return self.capacity - self.allocated_blocks

    def check_invariants(self) -> None:
        """Free runs disjoint+sorted+coalesced; accounting conserves blocks."""
        total_free = 0
        prev_end = -1
        for start, length in self._runs:
            assert length > 0 and start > prev_end, self._runs
            if prev_end == start:               # adjacency => not coalesced
                raise AssertionError(f"uncoalesced runs: {self._runs}")
            prev_end = start + length
            total_free += length
        assert prev_end <= self.capacity
        assert total_free == self.free_blocks
        assert sum(self._live.values()) == self.allocated_blocks
        # live regions disjoint from free runs and from each other
        spans = sorted([(o, n) for o, n in self._live.items()]
                       + list(self._runs))
        for (a, la), (b, _) in zip(spans, spans[1:]):
            assert a + la <= b, f"overlap in {spans}"


def kv_region_blocks(B: int, kv_cap: int) -> int:
    """Blocks needed to back one group's (L, B, kv_cap) KV region."""
    assert kv_cap % BLOCK_TOKENS == 0, "kv_cap must be block-aligned"
    return B * (kv_cap // BLOCK_TOKENS)


def make_spill_pool(cfg: ModelConfig, *, max_requests: int, kv_cap: int,
                    quant=None, device="cuda") -> HostBlockPool:
    """The engine's once-allocated KV staging pool: enough host blocks to
    back the largest group's KV region, plus one group of slack.  This is
    the *staging* arena the executor spills into, not the full Algorithm-1
    host cache.  (ACT blocks prefer device residency and are never spilled,
    so no ACT arena exists.)  ``quant`` sizes each block by the quantized
    layout, int8 codes and float16 scales: the arena shrinks with it."""
    kv_blocks = 2 * kv_region_blocks(max_requests, kv_cap)
    return HostBlockPool(kv_blocks, kv_block_bytes(cfg, quant=quant),
                         device=device)
