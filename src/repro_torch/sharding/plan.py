"""ShardPlan: one mesh and partition plan that every serving subsystem reads
(counterpart of ``repro.sharding.plan``, the same decisions and the same
``explain`` text).

The plan holds the serve-mode weight specs (``rules.params_specs``), the
hybrid cache's placement (``cache_spec``: batch over 'data', KV heads over
'model', ACT checkpoints over d_model, the sequence never split) and the
``shard_factor`` the per-shard block math and the cost model divide by (1
when the cache dims do not divide, so the accounting never claims a split
that placement dropped).

Placement is the port's own: a ``Sharded`` leaf is its global shape, its
spec and one tensor per mesh position, exactly the slice the reference's
``NamedSharding.devices_indices_map`` gives that position
(``device_slices``), so each position holds the bytes its spec implies
(``launch.dryrun.leaf_bytes``).  Replicated dimensions are copies: every
position owns its tensor.  The tensor-parallel compute over these leaves is
``models.sharded``'s; the collectives between positions are
``sharding.collectives``'.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import DeviceMesh, Position
from repro_torch.sharding import rules

Spec = Tuple[Any, ...]


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape[name]) if name in mesh.axis_names else 1


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def slices_of(mesh: DeviceMesh, spec: Spec, shape, pos: Position) -> tuple:
    """The index tuple of ``pos``'s shard of a global array of ``shape``
    under ``spec``, as ``devices_indices_map`` writes it: ``slice(None)``
    on a replicated dimension, ``slice(start, stop)`` on a split one (the
    spec's axes combined row-major)."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for size, entry in zip(shape, spec):
        axes = _axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        n, idx = 1, 0
        for a in axes:
            k = _axis_size(mesh, a)
            idx = idx * k + mesh.coord(pos, a)
            n *= k
        if size % n:
            raise ValueError(f"dim {size} does not divide {n} ways ({spec})")
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


class Sharded:
    """A tensor laid out on a mesh: global ``shape`` and ``dtype``, its
    ``spec``, and ``shards[i]``, the tensor of position ``i`` (row-major),
    on that position's device."""

    __slots__ = ("mesh", "spec", "shape", "dtype", "shards")

    def __init__(self, mesh: DeviceMesh, spec: Spec, shape, dtype,
                 shards: List[torch.Tensor]):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.dtype = tuple(shape), dtype
        self.shards = list(shards)

    def shard(self, pos) -> torch.Tensor:
        return self.shards[pos if isinstance(pos, int) else pos.index]

    def nbytes(self, pos) -> int:
        t = self.shard(pos)
        return t.numel() * t.element_size()

    def full(self, device=None) -> torch.Tensor:
        """The global tensor assembled from the shards, on ``device``
        (default: position 0's)."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for pos in self.mesh.positions:
            out[slices_of(self.mesh, self.spec, self.shape, pos)] = \
                self.shards[pos.index].to(dev)
        return out

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, "
                f"{rules.spec_str(self.spec)})")


def place(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> Sharded:
    """``t`` laid out under ``spec``: each position gets its own copy of its
    slice, on its device."""
    shards = []
    for pos in mesh.positions:
        src = t[slices_of(mesh, spec, t.shape, pos)]
        shards.append(torch.empty(src.shape, dtype=t.dtype,
                                  device=pos.device).copy_(src))
    return Sharded(mesh, spec, t.shape, t.dtype, shards)


def layout_of(mesh, spec: Spec, ndim: int) -> Spec:
    """``spec``'s layout on ``mesh``: padded to ``ndim`` entries, each axis
    of size 1 dropped (a dimension split one way is not split), so two
    specs that place every element alike compare equal."""
    out = []
    for entry in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        axes = tuple(a for a in _axes(entry) if _axis_size(mesh, a) > 1)
        out.append(axes or None)
    return tuple(out)


def relayout(x: Sharded, spec: Spec) -> Sharded:
    """``x`` under another spec: ``x`` itself where the two lay it out
    alike, else assembled and placed again (its bytes counted as the
    ``relayout`` collective)."""
    spec = tuple(spec)
    n = len(x.shape)
    if layout_of(x.mesh, spec, n) == layout_of(x.mesh, x.spec, n):
        return x
    from repro_torch.sharding.collectives import COUNTER
    COUNTER.add("relayout", sum(x.nbytes(p) for p in x.mesh.positions))
    return place(x.full(), spec, x.mesh)


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def local(tree, pos):
    """Position ``pos``'s tensors of a tree of ``Sharded`` leaves, as the
    plain nested dict the model functions take."""
    return _map(tree, lambda _, x: x.shard(pos))


@dataclass
class ShardPlan:
    """Mesh + partition plan for the serving stack (built by
    ``make_shard_plan``; every subsystem reads this, never the mesh)."""
    cfg: ModelConfig
    mesh: DeviceMesh
    param_specs: Any                      # tree of specs matching the params
    log: rules.ShardLog
    data_shards: int                      # 'data' axis size
    model_shards: int                     # 'model' axis size
    kv_head_shards: int                   # factor really applied to KV heads
    act_shards: int                       # factor really applied to act d_model
    shard_factor: int                     # per-shard block-math divisor

    # ------------------------------------------------------------ cache specs
    def cache_spec(self, key: str, shape) -> Spec:
        """Hybrid-cache leaf spec (serving layout; no sequence sharding).
        An int8 cache's scale planes go with their payloads: ``k_s``/``v_s``
        split with the KV heads, ``act_s`` (one scale per whole ACT row)
        replicated over 'model'."""
        shp = tuple(shape)
        b = "data" if self.data_shards > 1 else None
        t = "model" if self.model_shards > 1 else None

        def fit(size, ax):
            return ax if (ax is not None and size % _axis_size(self.mesh, ax)
                          == 0) else None

        b = b if self.batch_split(shp[0 if len(shp) < 4 else 1]) else None
        if key in ("k", "v", "k_s", "v_s"):   # (L, B, S, KVH, D or 1)
            return (None, fit(shp[1], b), None, fit(shp[3], t), None)
        if key == "act":                 # (L, B, S, d_model)
            return (None, fit(shp[1], b), None, fit(shp[3], t))
        if key == "act_s":               # (L, B, S, 1): one scale per row
            return (None, fit(shp[1], b), None, None)
        if key == "act_pos":             # (B, act_cap)
            return (fit(shp[0], b), None)
        if key in ("kv_len", "act_len"):  # (B,)
            return (fit(shp[0], b),)
        return (None,) * len(shp)

    def batch_split(self, B: int) -> bool:
        """Whether a batch of ``B`` rows splits over 'data' (the cache
        spec's ``fit``); otherwise every data row holds all of it.  An MoE
        model splits only over a data axis that divides 32: its capacity
        groups are ``_moe_groups`` of the whole batch's tokens (fault N),
        and only then does each data row hold whole groups."""
        d = self.data_shards
        if self.cfg.is_moe and 32 % d:
            return False
        return d > 1 and B % d == 0

    # -------------------------------------------------------------- placement
    def param_specs_for(self, params):
        """Serve-mode TP specs for ``params``: the stored full-tree specs
        when the key paths match (``make_shard_plan(..., params)``),
        recomputed otherwise (callers also place subtrees, e.g. the offload
        executor's resident remainder)."""
        if self.param_specs is not None and \
                [p for p, _ in rules._flatten(self.param_specs)] == \
                [p for p, _ in rules._flatten(params)]:
            return self.param_specs
        return rules.params_specs(self.cfg, params, self.mesh, train=False)

    def place_params(self, params):
        """The weight tree laid out under the serve TP specs: a tree of
        ``Sharded`` leaves."""
        specs = self.param_specs_for(params)
        return _map(params, lambda path, a: place(a, _get(specs, path),
                                                  self.mesh))

    def place_replicated(self, tree):
        """A small tree replicated on every position (the offload executor's
        resident remainder)."""
        return _map(tree, lambda _, a: place(a, (None,) * a.dim(), self.mesh))

    def place_cache(self, cache):
        """A materialised hybrid cache laid out under ``cache_spec``."""
        return {k: place(v, self.cache_spec(k, v.shape), self.mesh)
                for k, v in cache.items()}

    def constrain_cache(self, cache):
        """Every cache leaf held to ``cache_spec``: a ``Sharded`` leaf in
        another layout is re-laid out, a plain tensor placed."""
        out = {}
        for k, v in cache.items():
            spec = self.cache_spec(k, v.shape)
            out[k] = relayout(v, spec) if isinstance(v, Sharded) \
                else place(v, spec, self.mesh)
        return out

    # ------------------------------------------------------- per-lane weights
    def layer_leaf_spec(self, spec: Spec) -> Spec:
        """Spec of one layer's slice of a stacked ``params['layers']`` leaf
        (the leading layer dim dropped)."""
        return tuple(spec)[1:]

    def lane_devices(self) -> List[Position]:
        """All mesh positions, row-major: the offload weight lanes are keyed
        by these (each position has its own host shard and copy stream)."""
        return list(self.mesh.positions)

    def device_slices(self, spec: Spec, shape) -> Dict[Position, tuple]:
        """position -> index tuple of that position's shard of a global
        array."""
        return {pos: slices_of(self.mesh, spec, shape, pos)
                for pos in self.mesh.positions}

    # ------------------------------------------------------- per-row compute
    def rows(self) -> List[List[Position]]:
        """The positions of each data row, in model order: a row computes
        its slice of the batch, its model positions split each layer."""
        m = self.model_shards
        pos = self.mesh.positions
        return [list(pos[r * m:(r + 1) * m]) for r in range(self.data_shards)]

    # ----------------------------------------------------------------- report
    def explain(self) -> str:
        head = [
            f"ShardPlan mesh={dict(self.mesh.shape)} "
            f"(data={self.data_shards}, model={self.model_shards})",
            f"  kv_head_shards={self.kv_head_shards} "
            f"act_shards={self.act_shards} -> shard_factor={self.shard_factor}"
            f" (per-shard block bytes divide by this; 1 means the cache "
            f"dims did not divide and accounting stays single-shard)",
        ]
        return "\n".join(head + self.log.lines())


def make_shard_plan(cfg: ModelConfig, mesh: DeviceMesh,
                    params=None) -> ShardPlan:
    """Build the plan: serve-mode param specs and the cache decisions, all
    logged.  ``params`` (a tree with ``.shape`` leaves) is optional; without
    it the specs are derived at placement and the log holds the cache
    decisions only."""
    log = rules.ShardLog()
    param_specs = None
    if params is not None:
        param_specs = rules.params_specs(cfg, params, mesh, train=False,
                                         log=log)
    data = _axis_size(mesh, "data")
    model = _axis_size(mesh, "model")
    kvh = max(cfg.num_kv_heads, 1)
    kv_head_shards = model if kvh % model == 0 else 1
    act_shards = model if cfg.d_model % model == 0 else 1
    # the block math divides by the factor BOTH cache representations really
    # split by; a one-sided divide would misprice the other region's lane
    shard_factor = model if (kv_head_shards == model
                             and act_shards == model) else 1
    log.add("cache/k,v", 3, kvh, "model",
            "model" if kv_head_shards == model else None,
            "sharded" if kv_head_shards == model else
            f"replicated ({kvh} KV heads do not divide model={model})")
    log.add("cache/act", 3, cfg.d_model, "model",
            "model" if act_shards == model else None,
            "sharded" if act_shards == model else
            f"replicated (d_model={cfg.d_model} does not divide model={model})")
    log.add("blocks/shard_factor", 0, shard_factor, "model",
            "model" if shard_factor == model else None,
            f"per-shard block bytes divide by {shard_factor}")
    return ShardPlan(cfg=cfg, mesh=mesh, param_specs=param_specs, log=log,
                     data_shards=data, model_shards=model,
                     kv_head_shards=kv_head_shards, act_shards=act_shards,
                     shard_factor=shard_factor)

