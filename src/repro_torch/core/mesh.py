"""Virtual mesh: every rank of a Cartesian process grid, stacked per process.

The JAX package runs its exchange SPMD over a device mesh (one shard per
device, a hop is a ``lax.ppermute``).  The port keeps the ranks of a
process in ONE tensor on its device.  In one process (the default) that is
every rank: the stored layout is ``(*mesh_shape, *local_ghosted)``, and
every pack, unpack and update works on the free ``(R, *local_ghosted)``
view with ``R = prod(mesh_shape)``.  Rank ``r`` is the row-major
linearization of its mesh coordinates over :attr:`VirtualMesh.axis_names`
— the order ``lax.ppermute`` uses for multi-axis collectives, so composed
hop tables carry over unchanged.

A process-to-node mapping (:mod:`repro_torch.launch.mapping`) is the
mesh's :attr:`~VirtualMesh.placement`: the rank placed at each row-major
coordinate, the counterpart of the permuted device list the JAX package
hands ``jax.make_mesh``.

A mesh may also span :attr:`~VirtualMesh.processes` processes of a
``torch.distributed`` grid (:mod:`repro_torch.launch.stencil`).  Process
``p`` owns the coordinates whose placed rank falls in its block of
``size // processes`` ranks, as each device of JAX's permuted device list
belongs to one process; it stacks them in coordinate order as
``(local_size, *local_ghosted)`` (:attr:`~VirtualMesh.local_coords`).  In
one process a placement is a label: every mapping moves the same data and
only decides which coordinates share a modeled node
(:func:`repro_torch.launch.mapping.mesh_node_ids`).  On a grid it decides
which coordinates each process holds, so a mapping moves data between
processes and sets which hops cross a process boundary.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.compat import resolve_device


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """Ordered named axes and their sizes, plus the device that holds this
    process's ranks.  ``.shape`` reads like ``jax.sharding.Mesh.shape``.
    ``placement[c]`` is the rank at row-major coordinate ``c`` (``()``
    becomes the identity).  ``processes`` and ``process_index`` place this
    process in its grid (1 and 0: one process holds every rank)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]
    device: torch.device
    placement: tuple[int, ...] = ()
    processes: int = 1
    process_index: int = 0
    #: the row-major coordinates this process stacks, in order (derived)
    local_coords: tuple[int, ...] = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError((self.axis_sizes, self.axis_names))
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axes: {self.axis_names}")
        if any(k < 1 for k in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be >= 1: {self.axis_sizes}")
        n = math.prod(self.axis_sizes)
        placement = tuple(int(r) for r in self.placement) or tuple(range(n))
        if sorted(placement) != list(range(n)):
            raise ValueError(f"placement is not a permutation of {n} ranks: {self.placement}")
        object.__setattr__(self, "placement", placement)
        if self.processes < 1 or n % self.processes:
            raise ValueError(f"{n} ranks do not split over {self.processes} processes")
        if not 0 <= self.process_index < self.processes:
            raise ValueError(f"process_index {self.process_index} of {self.processes}")
        object.__setattr__(self, "local_coords", self.coords_of_process(self.process_index))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Number of ranks of the whole mesh."""
        return math.prod(self.axis_sizes)

    @property
    def local_size(self) -> int:
        """Number of ranks ``R`` this process stacks."""
        return self.size // self.processes

    @property
    def stacked_dims(self) -> tuple[int, ...]:
        """Leading dims of this process's stored layout: the mesh shape in
        one process, ``(local_size,)`` on a grid."""
        return self.axis_sizes if self.processes == 1 else (self.local_size,)

    def process_of(self, coord: int) -> int:
        """The process holding row-major coordinate ``coord``."""
        return self.placement[coord] // self.local_size

    def coords_of_process(self, process: int) -> tuple[int, ...]:
        """The coordinates ``process`` stacks, in row-major order."""
        return tuple(c for c in range(self.size) if self.process_of(c) == process)

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
    placement: Sequence[int] = (),
    processes: int = 1,
    process_index: int = 0,
) -> VirtualMesh:
    """The port's ``make_mesh``: the card unless ``device="cpu"``;
    ``placement`` as :attr:`VirtualMesh.placement` (default the identity);
    ``processes``/``process_index`` this process's place in its grid."""
    return VirtualMesh(
        tuple(int(k) for k in axis_shapes), tuple(axis_names),
        resolve_device(device), tuple(placement), int(processes), int(process_index),
    )
