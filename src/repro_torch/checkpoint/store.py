"""Tree checkpoints to ``.npz`` with flattened path keys + a json sidecar,
in the on-disk format of ``repro.checkpoint.store``, so a checkpoint written
by either package restores in the other.

A tree is nested dicts, lists, tuples and NamedTuples (``AdamWState``) of
tensors, numpy arrays or scalars.  A leaf's key is its path joined by
``/``: a dict key, a NamedTuple field name, or ``#i`` for the i-th item of a
list or tuple (the names ``jax.tree_util`` gives the same paths).  npz has
no bfloat16: such a leaf is stored as its uint16 bits under ``<key>::bf16``.
The ``.meta.json`` sidecar holds the sorted keys, each stored member's
crc32 and the caller's metadata; ``restore`` checks the key set, the
checksums and every read, and rejects a mismatch, a truncated file or a
flipped bit loudly.  ``shard_suffix`` names a per-host shard file
(``<path><suffix>.npz``) beside one shared sidecar.
"""
from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

SEP = "/"
BF16 = "::bf16"


def _crc(arr: np.ndarray) -> int:
    """Content checksum of one saved leaf (bytes as stored in the npz)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _items(tree):
    """(path key, leaf) of every leaf, depth first."""
    if isinstance(tree, dict):
        kids = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        kids = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        kids = ((f"#{i}", v) for i, v in enumerate(tree))
    else:
        yield "", tree
        return
    for name, sub in kids:
        for rest, leaf in _items(sub):
            yield (name + SEP + rest if rest else name), leaf


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _items(tree):
        arr = _to_numpy(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            key = key + BF16
        flat[key] = np.asarray(arr, order="C")    # 0-d stays 0-d
    return flat


def save(path: str, tree, metadata: Optional[Dict[str, Any]] = None,
         shard_suffix: str = "") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    np.savez(path + shard_suffix + ".npz", **flat)
    with open(path + ".meta.json", "w") as f:
        json.dump({"keys": sorted(flat),
                   # per-leaf content checksums: restore verifies them, so a
                   # bit-flipped shard fails loudly instead of loading
                   # garbage tensors
                   "crc32": {k: _crc(v) for k, v in flat.items()},
                   "metadata": metadata or {}}, f, indent=1)


def _strip_bf16(keys) -> set:
    return {k[: -len(BF16)] if k.endswith(BF16) else k for k in keys}


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _leaf(raw: np.ndarray, bf16: bool) -> torch.Tensor:
    if bf16:
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(raw, order="C"))


def restore(path: str, like, shard_suffix: str = "",
            expect_metadata: Optional[Dict[str, Any]] = None, device=None):
    """Restore into the structure of ``like`` (shapes validated; each leaf
    cast to its ``like`` leaf's dtype, so a bfloat16 checkpoint restores
    into a float32 tree and back).  Each tensor lands on ``device``, or by
    default on the device of its ``like`` leaf (a ``meta`` tree, as
    ``launch.specs.params_shape`` makes, needs ``device``).

    The sidecar (when present) must describe the same key set as ``like``;
    ``expect_metadata`` pins metadata entries (e.g. ``{"arch": name}``).
    A truncated or corrupted file, a failed member read and a member whose
    crc32 differs from the sidecar's raise ``ValueError``."""
    has_meta = os.path.exists(path + ".meta.json")
    if expect_metadata and not has_meta:
        raise ValueError(
            f"checkpoint at {path!r} has no .meta.json sidecar; cannot "
            f"verify expected metadata {sorted(expect_metadata)}")
    meta = {}
    if has_meta:
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        stored = _strip_bf16(meta.get("keys", ()))
        expected = {k for k, _ in _items(like)}
        if stored != expected:
            missing = sorted(expected - stored)[:5]
            extra = sorted(stored - expected)[:5]
            raise ValueError(
                f"checkpoint at {path!r} does not match the target "
                f"structure: {len(expected - stored)} missing keys "
                f"(e.g. {missing}), {len(stored - expected)} unexpected "
                f"(e.g. {extra})")
        for k, want in (expect_metadata or {}).items():
            got = meta.get("metadata", {}).get(k)
            if got != want:
                raise ValueError(
                    f"checkpoint metadata mismatch for {k!r}: stored "
                    f"{got!r}, expected {want!r}")
    npz_path = path + shard_suffix + ".npz"
    # np.load defers member decompression, so both the open and every
    # member read are guarded (zip directory damage surfaces at open; member
    # CRC / truncation damage at read)
    try:
        data = np.load(npz_path)
    except (zipfile.BadZipFile, ValueError, EOFError, OSError) as e:
        raise ValueError(
            f"checkpoint shard {npz_path!r} is unreadable ({e}); the file "
            f"is truncated or corrupted — re-save or fetch it again") from e
    crcs = meta.get("crc32", {})
    out = []
    for key, leaf in _items(like):
        stored_key = key + BF16 if key + BF16 in data else key
        try:
            raw = data[stored_key]
        except (zipfile.BadZipFile, zlib.error, ValueError, EOFError,
                OSError, KeyError) as e:
            raise ValueError(
                f"checkpoint shard {npz_path!r} failed reading member "
                f"{stored_key!r} ({e}); the file is truncated or corrupted "
                f"— re-save or fetch it again") from e
        if stored_key in crcs and _crc(raw) != crcs[stored_key]:
            raise ValueError(
                f"checkpoint shard {npz_path!r} member {stored_key!r} "
                f"fails its content checksum; the file is bit-corrupted — "
                f"re-save or fetch it again")
        if tuple(raw.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {raw.shape} != {tuple(leaf.shape)}")
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else \
            torch.from_numpy(np.zeros((), np.asarray(leaf).dtype)).dtype
        dev = device if device is not None else \
            (leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        out.append(_leaf(raw, stored_key.endswith(BF16)).to(device=dev,
                                                            dtype=dtype))
    return _rebuild(like, iter(out))


def load_metadata(path: str) -> Dict[str, Any]:
    with open(path + ".meta.json") as f:
        return json.load(f)["metadata"]
