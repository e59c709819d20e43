"""Partition rules for every architecture family and step kind (a copy of
``repro.sharding.rules``, the same decisions).

Strategy:
  serve  — tensor parallel on 'model' (heads / ff / experts / vocab),
           batch on 'data' (x 'pod'); batch=1 long-context decodes get
           sequence-sharded caches instead (context-parallel decode).
  train  — the serve TP specs + FSDP: the largest replicated weight dim is
           additionally sharded over ('pod','data') when divisible, which the
           optimizer state inherits (ZeRO-3).

A dim is sharded over an axis only when its size divides evenly; otherwise it
stays replicated (whisper's 8 heads on a 16-way model axis, grok's 8 experts,
...).  All decisions are recorded by `explain()` for the dry-run log.

The rules read shapes and mesh sizes only: a mesh is anything with
``shape[name]`` and ``axis_names`` (``repro_torch.launch.mesh.Mesh``), a
tree is nested dicts whose leaves have ``.shape`` (tensors on ``meta``), and
a spec is a plain tuple with one entry per leading dimension: ``None``
(replicated), an axis name, or a tuple of axis names.  Key paths join the
dict keys with "/", as the reference's ``_key_str`` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig

Spec = Tuple[Any, ...]


def P(*axes) -> Spec:
    """A spec: the per-dimension axes (the reference's ``PartitionSpec``)."""
    return tuple(axes)


def spec_str(spec: Spec) -> str:
    """The reference's text for a spec: ``PartitionSpec(None, 'model')``."""
    return "PartitionSpec" + repr(tuple(spec))


def _flatten(tree, path=()):
    """(key path, leaf) pairs of a nested dict, keys sorted at each level
    (the order ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (_key_str(k),))
    else:
        yield path, tree


def _tree_map_with_path(fn, tree, path=()):
    """``fn(key path, leaf)`` over a nested dict, visiting in ``_flatten``'s
    order (so a ``ShardLog`` records the reference's decisions in its
    order)."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, tree[k], path + (_key_str(k),))
                for k in sorted(tree)}
    return fn(path, tree)


@dataclass(frozen=True)
class ShardDecision:
    """One per-dimension sharding decision, drops included.

    ``explain()`` formats these; the coverage test asserts every dim of
    every leaf produced exactly one decision and no axis was used twice
    within a leaf — the silent-replication blind spot the decision log
    closes (a spec that *looks* sharded can still replicate every dim it
    matters on, and before the log only param decisions were visible)."""
    key: str                  # tree path of the leaf
    dim: int                  # dimension index within the leaf
    size: int                 # dimension size
    want: Any                 # axis the rule preferred (None = replicate)
    got: Any                  # axis actually assigned
    reason: str               # "sharded" | "replicated (<why>)"

    @property
    def dropped(self) -> bool:
        return self.want is not None and self.got is None


class ShardLog:
    """Collects ``ShardDecision``s while specs are built."""

    def __init__(self):
        self.decisions: List[ShardDecision] = []

    def add(self, key: str, dim: int, size: int, want, got, reason: str):
        self.decisions.append(ShardDecision(key, dim, size, want, got, reason))

    def record_dim(self, key: str, dim: int, size: int, want, got):
        """Standard outcome wording for a (wanted, got) pair."""
        if want is None:
            self.add(key, dim, size, None, None, "replicated (by rule)")
        elif got is None:
            self.add(key, dim, size, want, None,
                     f"replicated (size {size} does not divide axis "
                     f"'{want}' or axis already used)")
        else:
            self.add(key, dim, size, want, got, "sharded")

    def lines(self) -> List[str]:
        out = []
        for d in self.decisions:
            mark = "DROP" if d.dropped else ("  tp" if d.got else "    ")
            out.append(f"  [{mark}] {d.key}[{d.dim}] size={d.size:<8d} "
                       f"want={str(d.want):<18s} got={str(d.got):<18s} "
                       f"{d.reason}")
        return out


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(math.prod(mesh.shape[a] for a in axis))
    return int(mesh.shape[axis])


def _fits(dim: int, mesh, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _maybe(dim: int, mesh, axis):
    return axis if axis is not None and _fits(dim, mesh, axis) else None


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], cfg: ModelConfig,
               mesh, *, fsdp=None, log: Optional[ShardLog] = None) -> Spec:
    """Spec for one parameter leaf; `path` is the key path in the tree.

    ``log`` records one ``ShardDecision`` per dimension (drops included)."""
    name = path[-1]
    key = "/".join(path)
    tp = "model"

    def spec_for(dims_rules):
        """dims_rules: list of preferred axis per trailing dim (None = repl)."""
        n_lead = len(shape) - len(dims_rules)
        out = [None] * n_lead
        used = set()
        if log is not None:
            for i in range(n_lead):
                log.record_dim(key, i, shape[i], None, None)
        for i, (d, want) in enumerate(zip(shape[n_lead:], dims_rules)):
            ax = _maybe(d, mesh, want)
            if ax in used:
                ax = None
            if ax is not None:
                used.add(ax)
            out.append(ax)
            if log is not None:
                log.record_dim(key, n_lead + i, d, want, ax)
        return P(*out)

    if name in ("embed",):
        return spec_for([tp, fsdp])
    if name in ("unembed",):
        return spec_for([fsdp, tp])
    if name in ("pos_embed", "enc_pos"):
        return spec_for([None, tp])
    if name in ("scale", "bias", "qnorm", "knorm", "A_log", "D", "dt_bias", "norm"):
        return spec_for([None] * len(shape))
    if name == "wq":
        return spec_for([fsdp, tp])
    if name in ("wk", "wv"):
        return spec_for([fsdp, tp])
    if name == "wo":
        return spec_for([tp, fsdp])
    if name in ("w1", "w3"):
        return spec_for([fsdp, tp])
    if name == "w2":
        return spec_for([tp, fsdp])
    if name == "router":
        return spec_for([fsdp, None])
    if name in ("we1", "we3"):
        # expert-parallel when E divides the model axis, else TP on d_ff
        if _fits(shape[-3], mesh, tp):
            return spec_for([tp, fsdp, None])
        return spec_for([None, fsdp, tp])
    if name == "we2":
        if _fits(shape[-3], mesh, tp):
            return spec_for([tp, None, fsdp])
        return spec_for([None, tp, fsdp])
    if name == "in_proj":
        return spec_for([fsdp, tp])
    if name == "conv_w":
        return spec_for([tp, None])
    if name == "out_proj":
        return spec_for([tp, fsdp])
    # fallback: replicate
    return spec_for([None] * len(shape))


def params_specs(cfg: ModelConfig, params_shape, mesh, *, train: bool,
                 weights_2d: bool = False, log: Optional[ShardLog] = None):
    """Tree of specs matching the param tree (tensors on ``meta``).

    ``weights_2d`` (serve mode): additionally shard the non-TP weight dim over
    'data' — 2D tensor parallelism.  Decode activations are tiny, so XLA
    resolves the d-sharded contractions with partial sums + psum instead of
    gathering weights; per-device weight residency drops by the data-axis
    factor (§Perf iteration 1).
    """
    fsdp = None
    if train or weights_2d:
        fsdp = ("pod", "data") if "pod" in mesh.axis_names else "data"

    def walk(keys, leaf):
        return param_spec(keys, tuple(leaf.shape), cfg, mesh, fsdp=fsdp,
                          log=log)

    return _tree_map_with_path(walk, params_shape)


def _key_str(k) -> str:
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "idx"):
        return f"#{k.idx}"
    return str(k)


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def batch_specs(cfg: ModelConfig, batch_shape: Dict[str, Any], mesh) -> Dict[str, Spec]:
    """Specs for the input batch dict (tokens/labels/frames/patches)."""
    bx = batch_axes(mesh)
    out = {}
    for k, v in batch_shape.items():
        B = v.shape[0]
        ax = bx if _fits(B, mesh, bx) else (
            "data" if _fits(B, mesh, "data") else None)
        out[k] = P(ax, *([None] * (len(v.shape) - 1)))
    return out


def cache_specs(cfg: ModelConfig, cache_shape: Dict[str, Any], mesh,
                log: Optional[ShardLog] = None) -> Dict[str, Spec]:
    """Decode-cache specs.

    Batch dim shards over data (x pod); KV-head dim over 'model' when it
    divides.  batch=1 long-context: the SEQUENCE dim of attention caches
    shards over 'data' instead (context-parallel decode) — the attention
    reductions over S then lower to psums.

    ``log`` records one ``ShardDecision`` per dimension, closing the old
    blind spot where only param decisions were explained and a cache that
    silently replicated every dim looked identical to a sharded one.
    """
    bx = batch_axes(mesh)
    tp = "model"
    out = {}

    def _record(key, shp, wants, spec):
        if log is None:
            return
        got = tuple(spec) + (None,) * (len(shp) - len(tuple(spec)))
        for i, (size, want) in enumerate(zip(shp, wants)):
            log.record_dim(key, i, size, want, got[i])

    # keys in sorted order, as a jax tree's dict comes back from eval_shape
    # (the order the reference's log records them in)
    for k, v in sorted(cache_shape.items()):
        shp = tuple(v.shape)
        if k == "kv_len":
            out[k] = P(_maybe(shp[0], mesh, bx))
            _record(k, shp, (bx,), out[k])
            continue
        if k in ("k", "v", "self_k", "self_v", "cross_k", "cross_v",
                 "global_k", "global_v", "attn_k", "attn_v"):
            # (L?, B, S, KVH, D) — layer-stacked leading dim
            L, B, S, KVH, D = shp
            b_ax = _maybe(B, mesh, bx) or _maybe(B, mesh, "data")
            kv_ax = _maybe(KVH, mesh, tp)
            # sequence axis picks up whatever is left idle:
            #  - batch=1 long-context: 'data' (context-parallel decode)
            #  - kv heads too few for the model axis: 'model' (§Perf iter. 1)
            s_axes = []
            if b_ax is None:
                s_axes.append("data")
            if kv_ax is None:
                s_axes.append(tp)
            s_ax = tuple(s_axes) if len(s_axes) > 1 else (s_axes[0] if s_axes else None)
            if s_ax is not None and not _fits(S, mesh, s_ax):
                s_ax = None
            out[k] = P(None, b_ax, s_ax, kv_ax, None)
            _record(k, shp, (None, bx, tuple(s_axes) or None, tp, None),
                    out[k])
        elif k in ("local_k", "local_v", "tail_k", "tail_v"):
            # (n, per, B, W, KVH, D) or (n, B, W, KVH, D)
            B_idx = len(shp) - 4
            b_ax = _maybe(shp[B_idx], mesh, bx) or _maybe(shp[B_idx], mesh, "data")
            spec = [None] * len(shp)
            spec[B_idx] = b_ax
            spec[-2] = _maybe(shp[-2], mesh, tp)
            out[k] = P(*spec)
            wants = [None] * len(shp)
            wants[B_idx], wants[-2] = bx, tp
            _record(k, shp, wants, out[k])
        elif k == "state":
            # (L, B, H, Pd, N) or (n_per, n_ssd, B, H, Pd, N)
            B_idx = len(shp) - 4
            spec = [None] * len(shp)
            spec[B_idx] = _maybe(shp[B_idx], mesh, bx) or _maybe(shp[B_idx], mesh, "data")
            spec[-3] = _maybe(shp[-3], mesh, tp)    # SSD heads
            out[k] = P(*spec)
            wants = [None] * len(shp)
            wants[B_idx], wants[-3] = bx, tp
            _record(k, shp, wants, out[k])
        elif k == "conv":
            B_idx = len(shp) - 3
            spec = [None] * len(shp)
            spec[B_idx] = _maybe(shp[B_idx], mesh, bx) or _maybe(shp[B_idx], mesh, "data")
            spec[-1] = _maybe(shp[-1], mesh, tp)    # conv channels
            out[k] = P(*spec)
            wants = [None] * len(shp)
            wants[B_idx], wants[-1] = bx, tp
            _record(k, shp, wants, out[k])
        elif k in ("act",):
            # ACT checkpoints: d_model shards over 'model' (KV-gen contracts
            # over it -> psum); batch over data (§Perf iteration 5)
            L, B, S, D = shp
            b_ax = _maybe(B, mesh, bx) or _maybe(B, mesh, "data")
            s_ax = "data" if (b_ax is None and _fits(S, mesh, "data")) else None
            out[k] = P(None, b_ax, s_ax, _maybe(D, mesh, tp))
            _record(k, shp, (None, bx, "data" if b_ax is None else None, tp),
                    out[k])
        elif k in ("act_pos", "act_len"):
            out[k] = P(_maybe(shp[0], mesh, bx))
            _record(k, shp, (bx,) + (None,) * (len(shp) - 1), out[k])
        else:
            out[k] = P(*([None] * len(shp)))
            _record(k, shp, (None,) * len(shp), out[k])
    return out


def explain(cfg: ModelConfig, specs_tree, log: Optional[ShardLog] = None) -> str:
    """Format a spec tree for the dry-run log; with a ``ShardLog`` the
    per-dimension decision trail (drops included) is appended — cache and
    activation specs now leave the same audit trail params always did."""
    lines = []
    for path, spec in _flatten(specs_tree):
        key = "/".join(path)
        lines.append(f"  {key:60s} {spec_str(spec)}")
    if log is not None and log.decisions:
        lines.append("  -- decisions (every dim, drops logged) --")
        lines.extend(log.lines())
    return "\n".join(lines)


def check_plan(specs_tree, log: ShardLog) -> None:
    """Assert the decision log fully covers the spec tree and is
    contradiction-free: no mesh axis shards two dims of one leaf, and every
    leaf dimension has exactly one recorded decision.  Raises AssertionError
    with the offending leaf."""
    flat = list(_flatten(specs_tree))
    by_key: Dict[str, List[ShardDecision]] = {}
    for d in log.decisions:
        by_key.setdefault(d.key, []).append(d)
    for path, spec in flat:
        key = "/".join(path)
        decs = by_key.get(key)
        assert decs, f"no decisions recorded for {key}"
        dims = sorted(d.dim for d in decs)
        assert dims == list(range(len(dims))), \
            f"{key}: decision dims {dims} not contiguous"
        used = []
        for ax in tuple(spec):
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                assert a not in used, \
                    f"{key}: axis {a!r} sharded twice in {spec_str(spec)}"
                used.append(a)
        # every replicated-but-wanted dim must be an explicit, logged drop
        got = tuple(spec) + (None,) * (len(dims) - len(tuple(spec)))
        for d in decs:
            assert (got[d.dim] == d.got), \
                f"{key}[{d.dim}]: log says {d.got!r}, spec says {got[d.dim]!r}"
