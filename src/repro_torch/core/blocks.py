"""Hybrid cache blocks: PagedAttention-style tables extended with block TYPE.

A copy of ``repro.core.blocks`` with the offload runtime's residency moves,
the CPU lane's ``host_attend`` tag, the quantized block layout (``quant=``:
int8 payloads with float16 scales, priced by ``core.quant``) and the
continuous-batching server's preemption demotion and the adaptive
controller's capacity retags, without the sharding hooks.

Each logical block covers BLOCK_TOKENS tokens of one request's context across
all layers, stored either as K/V tensors (KV block) or as activation
checkpoints (ACT block, half the bytes for MHA), resident on HOST or DEVICE
(paper §4.1-4.2, Fig. 7).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant as Q

BLOCK_TOKENS = 16           # vLLM default; MXU-friendly sublane count


class BlockType(enum.Enum):
    KV = "kv"
    ACT = "act"


class Location(enum.Enum):
    HOST = "host"
    DEVICE = "device"


def kv_block_bytes(cfg: ModelConfig,
                   quant: "Q.QuantConfig | None" = None) -> int:
    """S_KV: one KV block, all layers; ``quant`` prices the 1-byte payload
    and its scales."""
    return BLOCK_TOKENS * Q.kv_bytes_per_token(cfg, quant) * cfg.num_layers


def act_block_bytes(cfg: ModelConfig,
                    quant: "Q.QuantConfig | None" = None) -> int:
    """S_ACT: one ACT block, all layers (= S_KV/2 for MHA); ``quant`` as in
    ``kv_block_bytes``."""
    return BLOCK_TOKENS * Q.act_bytes_per_token(cfg, quant) * cfg.num_layers


@dataclass
class LogicalBlock:
    kind: BlockType
    location: Location
    pbn: int                 # physical block number within its (kind, location) pool
    ntokens: int = 0         # filled tokens (<= BLOCK_TOKENS)
    # storage format: payload dtype of the block's rows, and the absmax-scale
    # dtype when quantized (None: an unquantized block in the config dtype)
    dtype: str = ""
    scale_dtype: Optional[str] = None
    # host-attend residency tag: a HOST KV block placed on the cpu lane —
    # attended in place by the host executor, never loaded over PCIe and
    # never regenerated.  Only meaningful for KV@HOST; a migration to DEVICE
    # clears it.
    host_attend: bool = False

    @property
    def full(self) -> bool:
        return self.ntokens >= BLOCK_TOKENS


class PhysicalPool:
    """Allocator for one (kind, location) pool.  Capacity is fixed between
    ``grow``/``shrink`` calls: the adaptive controller retags free capacity
    between the ACT and KV pools of a tier.  Block numbers go out in the
    reference's order (its free list, popped from the end: the last freed
    or grown first, else the lowest never handed out).  The free list is
    kept as runs of numbers, not listed: a host pool priced for int8 holds
    tens of millions of blocks."""

    def __init__(self, capacity_blocks: int):
        self.capacity = int(capacity_blocks)
        # free block numbers as a stack of ranges, the next one out last
        self._free: List[range] = ([range(self.capacity - 1, -1, -1)]
                                   if self.capacity else [])
        self._n_free = self.capacity
        self._next_pbn = self.capacity          # unique ids across regrowth
        self.allocated = 0

    def alloc(self) -> Optional[int]:
        if not self._n_free:
            return None
        run = self._free[-1]
        pbn = run[-1]
        if len(run) == 1:
            self._free.pop()
        else:
            self._free[-1] = run[:-1]
        self._n_free -= 1
        self.allocated += 1
        return pbn

    def free(self, pbn: int) -> None:
        self.allocated -= 1
        self._free.append(range(pbn, pbn + 1))
        self._n_free += 1

    @property
    def free_blocks(self) -> int:
        return self._n_free

    def grow(self, n_blocks: int) -> None:
        """Add ``n_blocks`` of fresh capacity (new, never-used numbers)."""
        assert n_blocks >= 0
        if n_blocks:
            self._free.append(range(self._next_pbn, self._next_pbn + n_blocks))
        self._next_pbn += n_blocks
        self.capacity += n_blocks
        self._n_free += n_blocks

    def shrink(self, n_blocks: int) -> int:
        """Remove up to ``n_blocks`` of FREE capacity, the next ones out
        first; allocated blocks are never reclaimed.  -> blocks removed."""
        assert n_blocks >= 0
        n = left = min(n_blocks, self._n_free)
        while left:
            run = self._free[-1]
            if len(run) <= left:
                self._free.pop()
                left -= len(run)
            else:
                self._free[-1] = run[:len(run) - left]
                left = 0
        self.capacity -= n
        self._n_free -= n
        return n


class BlockManager:
    """Two-tier, two-type physical pools + per-request block tables.

    Pool capacities come from the Algorithm-1 host allocation and the GPU
    buffer budget; the engine asks for blocks in ratio (Eq. 11) order.
    ``quant``: new blocks carry the quantized payload and scale dtypes, and
    byte queries price the quantized layout; None keeps the config dtype.
    """

    def __init__(self, cfg: ModelConfig, *,
                 host_kv_blocks: int, host_act_blocks: int,
                 dev_kv_blocks: int, dev_act_blocks: int,
                 quant: "Q.QuantConfig | None" = None):
        self.cfg = cfg
        self.quant = quant
        self.pools: Dict[Tuple[BlockType, Location], PhysicalPool] = {
            (BlockType.KV, Location.HOST): PhysicalPool(host_kv_blocks),
            (BlockType.ACT, Location.HOST): PhysicalPool(host_act_blocks),
            (BlockType.KV, Location.DEVICE): PhysicalPool(dev_kv_blocks),
            (BlockType.ACT, Location.DEVICE): PhysicalPool(dev_act_blocks),
        }
        self.tables: Dict[int, List[LogicalBlock]] = {}
        # HOST<->DEVICE residency transitions, counted per (kind, from, to):
        # the offload runtime migrates blocks when its memory budget allows
        # device residency and spills them back when it doesn't.
        self.transitions: Dict[Tuple[BlockType, Location, Location], int] = {}
        # KV<->ACT capacity retags, counted per (location, from, to): the
        # adaptive controller's bounded role migrations (free capacity only)
        self.retags: Dict[Tuple[Location, BlockType, BlockType], int] = {}
        # live-block representation changes, counted per (from, to): the
        # preemption path demotes a victim's KV blocks to ACT checkpoints
        self.kind_transitions: Dict[Tuple[BlockType, BlockType], int] = {}

    # -- allocation ----------------------------------------------------------
    def new_request(self, rid: int) -> None:
        assert rid not in self.tables
        self.tables[rid] = []

    def free_request(self, rid: int) -> None:
        for blk in self.tables.pop(rid, []):
            self.pools[(blk.kind, blk.location)].free(blk.pbn)

    def _alloc_block(self, kind: BlockType) -> Optional[LogicalBlock]:
        # ACT blocks prefer DEVICE residency (paper §4.2.1: ACT is half-sized,
        # keeping it on-device maximises recompute with zero PCIe cost);
        # KV blocks live on HOST.
        order = ([Location.DEVICE, Location.HOST] if kind == BlockType.ACT
                 else [Location.HOST, Location.DEVICE])
        for loc in order:
            pbn = self.pools[(kind, loc)].alloc()
            if pbn is not None:
                return LogicalBlock(kind, loc, pbn, dtype=self._block_dtype(kind),
                                    scale_dtype=None if self.quant is None
                                    else self.quant.scale_dtype)
        return None

    def _block_dtype(self, kind: BlockType) -> str:
        if self.quant is None:
            return str(self.cfg.dtype)
        return (self.quant.kv_dtype if kind == BlockType.KV
                else self.quant.act_dtype)

    def append_token(self, rid: int, kind: BlockType) -> Optional[LogicalBlock]:
        """Account one more token of the given representation; allocates a new
        physical block at block boundaries.  Returns the block written to, or
        None if out of memory."""
        table = self.tables[rid]
        last = next((b for b in reversed(table) if b.kind == kind and not b.full), None)
        if last is None:
            last = self._alloc_block(kind)
            if last is None:
                return None
            table.append(last)
        last.ntokens += 1
        return last

    # -- residency transitions (offload runtime) ------------------------------
    def move_block(self, rid: int, index: int, new_loc: Location) -> bool:
        """Migrate one block to the other tier.  Allocates in the target pool
        first — on exhaustion the block stays put and False is returned, so a
        failed migration never loses accounting.  Transitions are counted in
        ``self.transitions``; the offload executor's physical pools
        (``offload.host_pool``) are the data-plane mirror of these moves."""
        blk = self.tables[rid][index]
        if blk.location == new_loc:
            return True
        pbn = self.pools[(blk.kind, new_loc)].alloc()
        if pbn is None:
            return False
        self.pools[(blk.kind, blk.location)].free(blk.pbn)
        key = (blk.kind, blk.location, new_loc)
        self.transitions[key] = self.transitions.get(key, 0) + 1
        blk.location, blk.pbn = new_loc, pbn
        if new_loc == Location.DEVICE:
            blk.host_attend = False     # cpu-lane tag is host-only residency
        return True

    def migrate(self, rid: int, kind: BlockType, new_loc: Location) -> int:
        """Best-effort migration of every ``kind`` block of a request;
        returns how many moved (stops counting failures, keeps going so a
        mixed-residency table still converges toward the target tier)."""
        moved = 0
        for i, blk in enumerate(self.tables[rid]):
            if blk.kind == kind and blk.location != new_loc:
                moved += self.move_block(rid, i, new_loc)
        return moved

    # -- preemption demotion (the server's pressure recovery) -----------------
    def demote_request_kv(self, rid: int) -> int:
        """Demote every KV block of ``rid`` to an ACT block in place: the
        checkpoint costs d_model per token instead of 2·L·d_kv, and a resume
        regenerates the KV from it.  Each block allocates in the ACT pools
        first (ACT's device-first order) and only then frees its KV slot, so
        a mid-table exhaustion loses no accounting: blocks that could not
        demote stay KV.  Token counts are kept.  -> blocks demoted, counted
        in ``kind_transitions[(KV, ACT)]``."""
        moved = 0
        for blk in self.tables[rid]:
            if blk.kind != BlockType.KV:
                continue
            new = self._alloc_block(BlockType.ACT)
            if new is None:
                break
            self.pools[(blk.kind, blk.location)].free(blk.pbn)
            blk.kind, blk.location, blk.pbn = BlockType.ACT, new.location, new.pbn
            blk.dtype, blk.scale_dtype = new.dtype, new.scale_dtype
            blk.host_attend = False     # ACT blocks regenerate, never cpu-attend
            moved += 1
        if moved:
            key = (BlockType.KV, BlockType.ACT)
            self.kind_transitions[key] = self.kind_transitions.get(key, 0) + moved
        return moved

    # -- cpu-attend lane residency --------------------------------------------
    def tag_host_attend(self, rid: int, on: bool = True) -> int:
        """Set the cpu-lane residency tag on every HOST KV block of a
        request (the engine routes a whole spilled KV region to the host
        executor at once).  Only KV@HOST blocks are eligible; returns how
        many blocks changed state."""
        changed = 0
        for blk in self.tables[rid]:
            eligible = (blk.kind == BlockType.KV
                        and blk.location == Location.HOST)
            target = bool(on) and eligible
            if blk.host_attend != target:
                blk.host_attend = target
                changed += 1
        return changed

    def free_blocks(self, kind: BlockType) -> int:
        """Total free capacity of ``kind`` across both tiers."""
        return sum(pool.free_blocks for (k, _), pool in self.pools.items()
                   if k == kind)

    # -- role retagging (adaptive controller) ---------------------------------
    def retag_capacity(self, loc: Location, src: BlockType, dst: BlockType,
                       n_blocks: int) -> int:
        """Move up to ``n_blocks`` of FREE capacity from the ``src`` pool to
        the ``dst`` pool of one tier: the controller re-deciding a block's
        role (KV or ACT) between groups or chunks.  Live tables are never
        touched.  -> blocks moved, counted in ``self.retags``."""
        assert src != dst
        moved = self.pools[(src, loc)].shrink(max(n_blocks, 0))
        self.pools[(dst, loc)].grow(moved)
        if moved:
            key = (loc, src, dst)
            self.retags[key] = self.retags.get(key, 0) + moved
        return moved

    # -- byte accounting ------------------------------------------------------
    def block_bytes(self, kind: BlockType) -> int:
        """Bytes of one block: under ``quant`` the 1-byte payload and its
        scales, the bytes the spill arena and the host link carry."""
        f = kv_block_bytes if kind == BlockType.KV else act_block_bytes
        return f(self.cfg, quant=self.quant)

    def explain(self) -> str:
        """Report of the pool capacities and the block byte math (the
        reference's, without its per-shard column)."""
        qdesc = ("off (config dtype)" if self.quant is None else
                 f"kv={self.quant.kv_dtype} act={self.quant.act_dtype} "
                 f"scales={self.quant.scale_dtype}")
        lines = [f"BlockManager quant={qdesc}"]
        for (kind, loc), pool in self.pools.items():
            tot = self.block_bytes(kind)
            extra = ""
            if self.quant is not None:
                raw = (kv_block_bytes if kind == BlockType.KV
                       else act_block_bytes)(self.cfg)
                extra = f" [{raw / tot:.2f}x vs {self.cfg.dtype}]"
            lines.append(
                f"  {loc.value:6s} {kind.value:3s}: capacity={pool.capacity} "
                f"blocks x {tot} B{extra}, allocated={pool.allocated}")
        return "\n".join(lines)

    # -- queries --------------------------------------------------------------
    def counts(self, rid: int) -> Dict[str, int]:
        t = self.tables[rid]
        return {
            "kv_blocks": sum(1 for b in t if b.kind == BlockType.KV),
            "act_blocks": sum(1 for b in t if b.kind == BlockType.ACT),
            "kv_tokens": sum(b.ntokens for b in t if b.kind == BlockType.KV),
            "act_tokens": sum(b.ntokens for b in t if b.kind == BlockType.ACT),
            "host_blocks": sum(1 for b in t if b.location == Location.HOST),
            "dev_blocks": sum(1 for b in t if b.location == Location.DEVICE),
            "host_attend_blocks": sum(1 for b in t if b.host_attend),
        }
