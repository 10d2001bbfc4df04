"""Topology-aware process-to-node mapping (PyTorch port of
``src/repro/launch/mapping.py``, pure Python, kept as the port's own copy).

On a multi-node grid, *which ranks share a node* decides whether a halo
message crosses the wire at all: the default row-major assignment of ranks
to mesh coordinates strings each node's ranks along one mesh row, so every
face exchange along the other axes is inter-node.  A **blocked** mapping
places each node's ranks on a compact sub-block of the mesh, turning the
heaviest face exchanges into intra-node copies; **recursive bisection**
generalizes that to mesh shapes a block grid cannot tile.

A :class:`Mapping` does NOT change the exchange schedule: the
:class:`~repro_torch.core.transport.Message` tables are a pure function of
the mesh *shape*.  It only permutes which rank sits at each mesh
coordinate.  On one card the seam is :attr:`~repro_torch.core.mesh.
VirtualMesh.placement` (``make_mesh(..., placement=mapping.placement(...))``):
the stacked layout stays per coordinate, so every mapping moves the same
data, and the placement shows in the hop-locality tables
(:func:`~repro_torch.core.transport.schedule_locality`) and in plan keys.

Conventions used throughout:

* mesh coordinates enumerate **row-major** over ``mesh_shape`` (the order
  ``itertools.product(*map(range, mesh_shape))`` yields);
* ``placement[flat_coord]`` is the **rank** (index into the original,
  node-contiguous rank list) placed at that coordinate;
* ranks are node-contiguous: node id = ``rank // node_size``.
"""

from __future__ import annotations

import abc
import itertools
import math
from typing import ClassVar, Sequence


def _flat(coords: Sequence[int], shape: Sequence[int]) -> int:
    """Row-major linearization (``lax.ppermute``'s multi-axis rule)."""
    idx = 0
    for c, k in zip(coords, shape):
        idx = idx * k + c
    return idx


def _prime_factors(n: int) -> list[int]:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    if n > 1:
        out.append(n)
    return out


class Mapping(abc.ABC):
    """One rank-placement policy: mesh coordinate -> rank.

    Subclasses implement :meth:`placement`; :meth:`permute_devices` and
    :meth:`node_of` derive from it.  Placements must be permutations of
    ``range(prod(mesh_shape))`` (asserted) and pure functions of
    ``(mesh_shape, node_size)`` — every rank of a grid derives the same
    placement independently, exactly as the re-plan purity contract
    requires.
    """

    #: registry key; subclasses must override.
    name: ClassVar[str] = ""

    @abc.abstractmethod
    def placement(
        self, mesh_shape: Sequence[int], node_size: int
    ) -> tuple[int, ...]:
        """``placement[flat_coord] = rank`` for every row-major coordinate.

        ``node_size`` is the number of ranks per node (devices per process
        on a real grid); mappings that cannot honor it for this shape must
        degrade to a valid placement, never fail.
        """

    def permute_devices(
        self, devices: Sequence, mesh_shape: Sequence[int], node_size: int
    ) -> list:
        """The list whose coordinate ``c`` holds ``devices[placement[flat(c)]]``
        (the JAX package hands it to ``jax.make_mesh``; on one card
        :attr:`~repro_torch.core.mesh.VirtualMesh.placement` carries the
        placement itself)."""
        placement = self.placement(mesh_shape, node_size)
        assert len(placement) == len(devices), (placement, len(devices))
        return [devices[r] for r in placement]

    def node_of(
        self, mesh_shape: Sequence[int], node_size: int
    ) -> tuple[int, ...]:
        """Node id at each row-major mesh coordinate (ranks are
        node-contiguous) — the vector the hop-locality classifier consumes
        (:func:`repro_torch.core.transport.schedule_locality`)."""
        assert node_size >= 1, node_size
        return tuple(r // node_size for r in self.placement(mesh_shape,
                                                            node_size))

    def _check(self, placement: Sequence[int], n: int) -> tuple[int, ...]:
        assert sorted(placement) == list(range(n)), (
            f"{self.name}: placement is not a permutation of {n} ranks: "
            f"{placement}"
        )
        return tuple(placement)


class RowMajorMapping(Mapping):
    """The historical default: rank *i* at the *i*-th row-major coordinate
    (nodes string along mesh rows)."""

    name = "row-major"

    def placement(self, mesh_shape, node_size):
        return tuple(range(math.prod(mesh_shape)))


class BlockedMapping(Mapping):
    """Each node's ranks tile one compact ``node_size``-cell sub-block.

    ``node_size`` is factored into per-axis block dims by assigning its
    prime factors greedily to the axis with the largest remaining quotient
    ``mesh_shape[a] / dims[a]`` among the axes the factor divides — the
    near-cubic blocks of Hunold et al.  Blocks tile the mesh row-major;
    ranks fill each block row-major, so node ``b`` owns exactly block ``b``
    and every within-block face neighbor is intra-node.  When ``node_size``
    cannot tile the shape (a factor divides no axis) or is degenerate
    (``<= 1`` or ``>= prod(shape)``), the placement degrades to row-major;
    a 1-D mesh degrades the same way (contiguous ranks are already blocks).
    """

    name = "blocked"

    def block_dims(
        self, mesh_shape: Sequence[int], node_size: int
    ) -> tuple[int, ...] | None:
        """Per-axis block extents tiling the mesh, or ``None`` when
        ``node_size`` does not factor over this shape."""
        n = math.prod(mesh_shape)
        if node_size <= 1 or node_size >= n or n % node_size != 0:
            return None
        dims = [1] * len(mesh_shape)
        for p in sorted(_prime_factors(node_size), reverse=True):
            best, best_q = None, 0
            for a, k in enumerate(mesh_shape):
                q = k // dims[a]
                if q % p == 0 and q > best_q:
                    best, best_q = a, q
            if best is None:
                return None  # factor tiles no axis: shape not blockable
            dims[best] *= p
        return tuple(dims)

    def placement(self, mesh_shape, node_size):
        n = math.prod(mesh_shape)
        dims = self.block_dims(mesh_shape, node_size)
        if dims is None:
            return RowMajorMapping().placement(mesh_shape, node_size)
        blocks = tuple(k // d for k, d in zip(mesh_shape, dims))
        out = []
        for coords in itertools.product(*map(range, mesh_shape)):
            block = [c // d for c, d in zip(coords, dims)]
            within = [c % d for c, d in zip(coords, dims)]
            out.append(
                _flat(block, blocks) * node_size + _flat(within, dims)
            )
        return self._check(out, n)


class RecursiveBisectionMapping(Mapping):
    """Recursively bisect the mesh box, assigning contiguous rank ranges.

    Each step splits the current coordinate box along its longest axis into
    two halves (sizes ``ceil``/``floor``) and hands each half the
    proportional contiguous slice of its rank range — so nearby ranks (and
    therefore whole nodes, ranks being node-contiguous) land on compact
    sub-boxes even when no block grid tiles the shape.  ``node_size`` only
    enters through the rank numbering; the recursion itself is shape-driven
    (the graph-partitioning form of Hunold et al.'s bisection mapping).
    """

    name = "recursive-bisection"

    def placement(self, mesh_shape, node_size):
        n = math.prod(mesh_shape)
        out = [0] * n

        def assign(box: list[tuple[int, int]], rank0: int) -> None:
            cells = math.prod(hi - lo for lo, hi in box)
            if cells == 1:
                coords = [lo for lo, _ in box]
                out[_flat(coords, mesh_shape)] = rank0
                return
            axis = max(range(len(box)),
                       key=lambda a: box[a][1] - box[a][0])
            lo, hi = box[axis]
            mid = lo + (hi - lo + 1) // 2
            left = list(box)
            left[axis] = (lo, mid)
            right = list(box)
            right[axis] = (mid, hi)
            left_cells = math.prod(h - l for l, h in left)
            assign(left, rank0)
            assign(right, rank0 + left_cells)

        assign([(0, k) for k in mesh_shape], 0)
        return self._check(out, n)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_MAPPINGS: dict[str, Mapping] = {}
#: short CLI aliases -> canonical registry names
ALIASES = {"rb": "recursive-bisection"}


def register_mapping(mapping: Mapping) -> Mapping:
    """Add a mapping instance to the registry under ``mapping.name``."""
    if not mapping.name:
        raise ValueError(f"{type(mapping).__name__} must carry a name")
    if mapping.name in _MAPPINGS:
        raise ValueError(f"mapping {mapping.name!r} already registered")
    _MAPPINGS[mapping.name] = mapping
    return mapping


def available_mappings() -> tuple[str, ...]:
    """Registered canonical mapping names, registration order."""
    return tuple(_MAPPINGS)


def canonical_mapping(name: str) -> str:
    """Resolve aliases (``"rb"``) to the canonical registry name; unknown
    names fail with the registered list (mirrors get_packer)."""
    name = ALIASES.get(name, name)
    if name not in _MAPPINGS:
        raise KeyError(
            f"unknown mapping {name!r}; registered: "
            f"{', '.join(_MAPPINGS) or '(none)'} "
            f"(aliases: {', '.join(f'{a}={c}' for a, c in ALIASES.items())})"
        )
    return name


def get_mapping(name: str) -> Mapping:
    return _MAPPINGS[canonical_mapping(name)]


register_mapping(RowMajorMapping())
register_mapping(BlockedMapping())
register_mapping(RecursiveBisectionMapping())


# ---------------------------------------------------------------------------
# node-id derivation for live meshes
# ---------------------------------------------------------------------------


def default_node_size(n_devices: int, processes: int = 1) -> int:
    """The sweep's auto rule for ranks-per-node: the real devices-per-process
    count on a multi-process grid; a modeled two-node split of the device
    list when everything runs in one process (so in-process CI still has an
    inter-node boundary to classify against)."""
    assert n_devices >= 1 and processes >= 1, (n_devices, processes)
    if processes > 1 and n_devices % processes == 0:
        return n_devices // processes
    return max(1, n_devices // 2)


def mesh_node_ids(mesh, node_size: int = 0) -> tuple[int, ...]:
    """Node id at each row-major coordinate of a LIVE mesh.

    One card holds every rank of a :class:`~repro_torch.core.mesh.
    VirtualMesh`, so nodes are modeled as ``node_size`` consecutive ranks
    (``rank // node_size``; the JAX package reads ``device.id`` the same
    way).  The rank at each coordinate is the mesh's own ``placement``, so
    this reflects whatever mapping the mesh was built under: the ground
    truth the static :meth:`Mapping.node_of` vectors are tested against.
    """
    if node_size <= 0:
        node_size = default_node_size(mesh.size)
    return tuple(r // node_size for r in mesh.placement)
