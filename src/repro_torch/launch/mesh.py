"""Production meshes (counterpart of ``repro.launch.mesh``).

A mesh here is a value: its axis names and sizes, nothing placed on a
device.  It answers what the partition rules read of a mesh
(``shape[name]``, ``axis_names``, ``size``), so ``repro_torch.sharding``
computes the reference's specs from it; the dry run divides each leaf's
bytes by its spec's axis sizes.  A mesh of devices that tensors are placed
on (``make_test_mesh``) is ROADMAP queue 1, item 5.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

SHARDING = "ROADMAP queue 1, item 5 (sharding)"


@dataclass(frozen=True)
class Mesh:
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and names "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the reference mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips with a leading 'pod' axis."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh() -> Mesh:
    """Single-device mesh: the one-card fit check."""
    return Mesh((1, 1), ("data", "model"))


def make_test_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh of devices that tensors are placed on: not
    ported yet; raises."""
    raise NotImplementedError(f"a {data}x{model} device mesh: {SHARDING}")
