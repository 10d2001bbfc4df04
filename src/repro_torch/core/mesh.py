"""One-card virtual mesh: every rank of a Cartesian process grid, stacked.

The JAX package runs its exchange SPMD over a device mesh (one shard per
device, a hop is a ``lax.ppermute``).  On one GPU the port keeps all ranks
in ONE tensor whose leading dims are the mesh dims: the stored layout is
``(*mesh_shape, *local_ghosted)``, and every pack, unpack and update works
on the free ``(R, *local_ghosted)`` view with ``R = prod(mesh_shape)``.
Rank ``r`` is the row-major linearization of its mesh coordinates over
:attr:`VirtualMesh.axis_names` — the order ``lax.ppermute`` uses for
multi-axis collectives, so composed hop tables carry over unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.compat import resolve_device


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """Ordered named axes and their sizes, plus the device that holds every
    rank.  ``.shape`` reads like ``jax.sharding.Mesh.shape``."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError((self.axis_sizes, self.axis_names))
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axes: {self.axis_names}")
        if any(k < 1 for k in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be >= 1: {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Number of ranks ``R``."""
        return math.prod(self.axis_sizes)

    def axis_index(self, name: str) -> int:
        return self.axis_names.index(name)

    def coords(self, rank: int) -> tuple[int, ...]:
        """Row-major mesh coordinates of a linear rank."""
        out = []
        for k in reversed(self.axis_sizes):
            out.append(rank % k)
            rank //= k
        return tuple(reversed(out))

    def rank(self, coords: Sequence[int]) -> int:
        idx = 0
        for c, k in zip(coords, self.axis_sizes):
            idx = idx * k + c
        return idx


def make_mesh(
    axis_shapes: Sequence[int],
    axis_names: Sequence[str],
    *,
    device: str | torch.device | None = None,
) -> VirtualMesh:
    """The port's ``make_mesh``: the card unless ``device="cpu"``."""
    return VirtualMesh(
        tuple(int(k) for k in axis_shapes), tuple(axis_names),
        resolve_device(device),
    )
