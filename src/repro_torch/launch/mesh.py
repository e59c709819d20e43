"""Production meshes (counterpart of ``repro.launch.mesh``).

A ``Mesh`` is a value: its axis names and sizes, nothing placed on a
device.  It answers what the partition rules read of a mesh
(``shape[name]``, ``axis_names``, ``size``), so ``repro_torch.sharding``
computes the reference's specs from it; the dry run divides each leaf's
bytes by its spec's axis sizes.

A ``DeviceMesh`` (``make_test_mesh``) is that value plus one
``torch.device`` per position, row-major: what ``sharding.ShardPlan``
places tensors on.  One process drives every position, as the reference's
single controller drives its devices; positions may share a device (every
position of a mesh on the one card of a one-card host, or on the CPU in the
tests), and then the per-position tensors, kernels and accounting all run
as on separate devices while a collective costs no link.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

#: what sharding still lacks (training under a plan, the dry run's collective
#: bytes, one layer body)
SHARDING = "ROADMAP queue 1, item 5.2 (sharding)"


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


class Position(NamedTuple):
    """One mesh position: its row-major index, its coordinate along each
    axis, and the device its tensors live on."""
    index: int
    coords: Tuple[int, ...]
    device: torch.device


@dataclass(frozen=True)
class DeviceMesh(Mesh):
    """A mesh whose positions each name a device (row-major)."""
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size} positions")

    @property
    def positions(self) -> Tuple[Position, ...]:
        out, n = [], len(self.axis_sizes)
        for i, dev in enumerate(self.devices):
            coords, rest = [0] * n, i
            for a in range(n - 1, -1, -1):
                coords[a] = rest % self.axis_sizes[a]
                rest //= self.axis_sizes[a]
            out.append(Position(i, tuple(coords), dev))
        return tuple(out)

    def coord(self, pos: Position, axis: str) -> int:
        return pos.coords[self.axis_names.index(axis)]


def make_test_mesh(data: int = 1, model: int = 1,
                   device: Optional[str] = None) -> DeviceMesh:
    """A (data, model) mesh of devices.  ``device=None``: the positions go
    round-robin over the CUDA devices present (all on ``cuda:0`` on a
    one-card host; raises without one); a device name puts every position
    there (``"cpu"`` for the tests)."""
    n = data * model
    if n < 1:
        raise ValueError(f"a {data}x{model} mesh has no position")
    if device is None:
        count = torch.cuda.device_count()
        if not count:
            raise RuntimeError("make_test_mesh: no CUDA device; pass "
                               "device='cpu' for a mesh on the host")
        devs = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        devs = (torch.device(device),) * n
    return DeviceMesh((data, model), ("data", "model"), devs)
