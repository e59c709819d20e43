"""Sharding hints by logical axis (counterpart of
``repro.models.shardhints``).

The serving path installs the plan's mesh here (``serving.util.trace_ctx``)
and the model code calls ``constrain(x, ...logical axes...)`` where the
reference does.  An axis that does not divide its dimension, or that an
earlier dimension of the same tensor already took, is dropped (replicated),
so the same code serves every mesh.  ``constrain`` re-lays a ``Sharded``
value out to the resolved spec; on a plain tensor, or with no mesh
installed, it returns its input.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional

_STATE = threading.local()

BATCH = "batch"      # -> ('pod', 'data') or ('data',)
MODEL = "model"      # -> ('model',)
DATA = "data"        # -> ('data',)


def set_mesh(mesh) -> None:
    _STATE.mesh = mesh


def get_mesh():
    return getattr(_STATE, "mesh", None)


@contextmanager
def use_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(prev)


def _resolve(mesh, logical: Optional[str]):
    if logical is None:
        return None
    if logical == BATCH:
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        return axes if axes else None
    if logical in mesh.axis_names:
        return logical
    return None


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(math.prod(mesh.shape[a] for a in axis))
    return int(mesh.shape[axis])


def resolve_spec(mesh, shape, *logical_axes):
    """The spec ``constrain`` resolves for ``shape``: each logical axis
    resolved on ``mesh``, dropped where it does not divide or was used."""
    spec, used = [], set()
    for dim, logical in zip(shape, logical_axes):
        ax = _resolve(mesh, logical)
        if ax is not None and (ax in used or dim % _axis_size(mesh, ax) != 0):
            ax = None
        if ax is not None:
            used.add(ax)
        if isinstance(ax, tuple) and len(ax) == 1:
            ax = ax[0]               # PartitionSpec's normal form
        spec.append(ax)
    return tuple(spec)


def constrain(x, *logical_axes):
    """``x`` laid out by logical axis names: a no-op without a mesh or on a
    plain tensor; per-dimension fallback to replication where the size does
    not divide."""
    from repro_torch.sharding.plan import Sharded, relayout
    mesh = get_mesh()
    if mesh is None or not isinstance(x, Sharded):
        return x
    return relayout(x, resolve_spec(mesh, x.shape, *logical_axes))
