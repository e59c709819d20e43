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

Under a ``ShardPlan`` the weight pool holds, instead of whole layers, each
mesh position's slice of every layer under the serve specs (``lane_view``):
each position streams only its own bytes through its own lane.  Spilled KV
regions then live in one arena per model-axis shard (``ShardedSpillPool``,
``make_spill_pool(shards=)``), each holding its shard's slice of every block.

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

    ``plan`` (a ``ShardPlan``): the host copy is cut per mesh position
    instead, under the plan's serve specs with the layer dim dropped
    (``layer_leaf_specs``); ``lane_view(i)`` is position ``i``'s slice of
    every layer, one flat buffer per layer, with the pool's interface for
    its ``WeightStreamer``.  No whole-layer buffer is kept then, and the
    pool serves position 0's device (what ``models.sharded.resolve_plan``
    gives its executor: ``cuda:0`` where ``device`` says ``cuda``).
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *,
                 plan=None, device="cuda"):
        assert "layers" in params, "host offload drives uniform-family models"
        self.cfg = cfg
        self.plan = plan
        self.device = torch.device(device) if plan is None else \
            plan.mesh.devices[0]
        if self.device.type != torch.device(device).type:
            raise ValueError(f"a pool for {device} under a plan on "
                             f"{self.device}")
        self.resident = {k: _to(v, self.device) for k, v in params.items()
                         if k != "layers"}
        stacked = params["layers"]
        first = _index(stacked, 0)
        self.layout = LayerLayout(first)
        self._bufs: List[torch.Tensor] = []
        self._layers: List[Dict[str, Any]] = []
        self._lanes: List["LaneView"] = []
        self.layer_leaf_specs: Dict[tuple, tuple] = {}
        if plan is not None:
            specs = plan.param_specs_for(params)["layers"]
            for path, _ in _flatten(first):
                self.layer_leaf_specs[path] = plan.layer_leaf_spec(
                    _get(specs, path))
            self._lanes = [LaneView(self, stacked, pos)
                           for pos in plan.lane_devices()]
            self.layer_nbytes = [sum(ln.layout.nbytes for ln in self._lanes)
                                 ] * cfg.num_layers
            return
        for l in range(cfg.num_layers):
            buf = host_empty(self.layout.nbytes, self.device)
            _fill(self.layout.views(buf), _index(stacked, l))
            self._bufs.append(buf)
            self._layers.append(self.layout.views(buf))
        self.layer_nbytes = [self.layout.nbytes] * cfg.num_layers

    def layer(self, l: int):
        """Host tree of layer ``l``'s weights (views of ``buffer(l)``)."""
        return self._layers[l]

    def buffer(self, l: int) -> torch.Tensor:
        """Layer ``l``'s flat host buffer (what one copy moves)."""
        return self._bufs[l]

    def lane_view(self, lane: int) -> "LaneView":
        return self._lanes[lane]

    @property
    def pinned(self) -> bool:
        bufs = self._bufs + [b for ln in self._lanes for b in ln._bufs]
        return all(b.is_pinned() for b in bufs)


class LaneView:
    """One mesh position's slice of a ``HostWeightPool``: every layer's
    leaves cut to the position's index (``plan.device_slices``) and packed
    into one flat host buffer per layer; it has the pool's interface for a
    ``WeightStreamer`` (``device``, ``layout``, ``layer``, ``buffer``,
    ``layer_nbytes``)."""

    def __init__(self, pool: HostWeightPool, stacked, pos):
        plan = pool.plan
        self.pos, self.device = pos, pos.device
        first = _index(stacked, 0)
        idx = {path: plan.device_slices(pool.layer_leaf_specs[path],
                                        tuple(t.shape))[pos]
               for path, t in _flatten(first)}
        sliced = lambda tree: _tree({p: t[idx[p]] for p, t in _flatten(tree)})
        self.layout = LayerLayout(sliced(first))
        self._bufs, self._layers = [], []
        for l in range(pool.cfg.num_layers):
            buf = host_empty(self.layout.nbytes, pos.device)
            _fill(self.layout.views(buf), sliced(_index(stacked, l)))
            self._bufs.append(buf)
            self._layers.append(self.layout.views(buf))
        self.layer_nbytes = [self.layout.nbytes] * pool.cfg.num_layers

    def layer(self, l: int):
        return self._layers[l]

    def buffer(self, l: int) -> torch.Tensor:
        return self._bufs[l]


def _fill(dst_tree, src_tree) -> None:
    for path, src in _flatten(src_tree):
        _get(dst_tree, path).copy_(src)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree(leaves: Dict[tuple, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, t in leaves.items():
        _set(out, path, t)
    return out


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


class ShardedRegion:
    """Per-model-shard spill regions allocated together, one per arena of a
    ``ShardedSpillPool``."""

    def __init__(self, regions: List[Region]):
        self.regions = regions

    def free(self) -> None:
        for r in self.regions:
            r.free()


class ShardedSpillPool:
    """One pinned arena per model-axis shard, each holding that shard's
    slice of every spilled block (``kv_block_bytes(cfg, shards)`` per
    block), so spill traffic is per lane.  ``alloc`` is all-or-nothing
    across the arenas; the interface is ``HostBlockPool``'s."""

    def __init__(self, lanes: List[HostBlockPool]):
        assert lanes
        self.lanes = lanes

    def alloc(self, n_blocks: int) -> Optional[ShardedRegion]:
        regions: List[Region] = []
        for lane in self.lanes:
            r = lane.alloc(n_blocks)
            if r is None:
                for got in regions:
                    got.free()
                return None
            regions.append(r)
        return ShardedRegion(regions)

    @property
    def allocated_blocks(self) -> int:
        """Logical blocks allocated (each arena holds one slice of each)."""
        return self.lanes[0].allocated_blocks

    @property
    def free_blocks(self) -> int:
        return min(lane.free_blocks for lane in self.lanes)

    def check_invariants(self) -> None:
        for lane in self.lanes:
            lane.check_invariants()


def make_spill_pool(cfg: ModelConfig, *, max_requests: int, kv_cap: int,
                    shards: int = 1, quant=None, device="cuda"):
    """The engine's once-allocated KV staging pool: enough host blocks to
    back the largest group's KV region, plus one group of slack.  This is
    the *staging* arena the executor spills into, not the full Algorithm-1
    host cache.  (ACT blocks prefer device residency and are never spilled,
    so no ACT arena exists.)  ``quant`` sizes each block by the quantized
    layout, int8 codes and float16 scales: the arena shrinks with it.
    ``shards`` > 1: a ``ShardedSpillPool``, one arena per model-axis shard
    sized for its 1/N block slices."""
    kv_blocks = 2 * kv_region_blocks(max_requests, kv_cap)
    if shards == 1:
        return HostBlockPool(kv_blocks, kv_block_bytes(cfg, quant=quant),
                             device=device)
    return ShardedSpillPool([
        HostBlockPool(kv_blocks, kv_block_bytes(cfg, shards, quant=quant),
                      device=device) for _ in range(shards)])
