"""N-dimensional halo (ghost-cell) exchange over a virtual mesh (PyTorch port).

The port of ``src/repro/core/halo.py``: this module only *assembles
schedules* (which slab goes where) as :class:`~repro_torch.core.transport.
Message` tables and hands every pack -> move -> unpack to the transport
layer.  Mesh axis sizes are passed in from the
:class:`~repro_torch.core.mesh.VirtualMesh` (the JAX version reads them
inside ``shard_map``).

Corner/edge handling uses the axis-by-axis trick: exchanging full-extent
slabs (including the ghost rims of previously exchanged axes) propagates
edge and corner values in D passes; the fused schedule instead posts all
``3^D - 1`` face/edge/corner messages in one independent group.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

import torch

from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.transport import (
    Message,
    ScheduleInfo,
    exchange_messages,
    get_packer,
    get_transport,
)
from repro_torch.launch.mapping import canonical_mapping


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Describes one halo exchange; fields as ``repro.core.halo.HaloSpec``
    (the transport defaults to the one-card ``loopback``)."""

    mesh_axes: tuple[str, ...]
    array_axes: tuple[int, ...]
    halo: int = 1
    periodic: bool = True
    strategy: str = "standard"
    n_parts: int = 1
    packer: str = "slice"
    transport: str = "loopback"
    coalesce: bool = True
    mapping: str = "row-major"
    #: autotune provenance ("trace"/"model"/"calibration"/...) when the
    #: cell was picked by :mod:`repro_torch.core.autotune`; part of the plan
    #: identity, so an autotuned plan never aliases a hand-pinned one
    selected_by: str | None = None
    epoch: int | None = None

    def __post_init__(self):
        if len(self.mesh_axes) != len(self.array_axes):
            raise ValueError((self.mesh_axes, self.array_axes))
        if not self.strategy:
            raise ValueError("strategy label must be non-empty")
        if self.n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {self.n_parts}")
        get_packer(self.packer)
        get_transport(self.transport)
        object.__setattr__(self, "mapping", canonical_mapping(self.mapping))

    def with_(self, **kw) -> "HaloSpec":
        return dataclasses.replace(self, **kw)

    def schedule_info(self, kind: str) -> ScheduleInfo:
        return ScheduleInfo(
            kind=kind, mesh_axes=self.mesh_axes, packer=self.packer,
            transport=self.transport, coalesce=self.coalesce,
            mapping=self.mapping, selected_by=self.selected_by, epoch=self.epoch,
        )


# ---------------------------------------------------------------------------
# schedule assembly: HaloSpec + block shape -> Message tables
# ---------------------------------------------------------------------------


def _neighbor_perms(k: int, periodic: bool) -> tuple[tuple, tuple]:
    """(to_left, to_right) source-target tables."""
    to_left = tuple((i, (i - 1) % k) for i in range(k) if periodic or i > 0)
    to_right = tuple((i, (i + 1) % k) for i in range(k) if periodic or i < k - 1)
    return to_left, to_right


def _tangent_axis(shape: Sequence[int], array_axis: int) -> int:
    """Pick the largest non-exchange axis to partition a slab along."""
    best, best_size = (array_axis + 1) % len(shape), -1
    for a in range(len(shape)):
        if a != array_axis and shape[a] > best_size:
            best, best_size = a, shape[a]
    return best


def mesh_sizes(spec: HaloSpec, mesh: VirtualMesh) -> dict[str, int]:
    return {name: mesh.shape[name] for name in spec.mesh_axes}


def axis_message_group(
    shape: tuple[int, ...],
    axis_name: str,
    array_axis: int,
    *,
    k: int,
    halo: int,
    periodic: bool = True,
    n_parts: int = 1,
) -> tuple[Message, ...]:
    """The two messages of one sequential axis pass (full-extent slabs of
    width ``halo``; ``k == 1`` periodic is a hop-free self-wrap, ``k == 1``
    non-periodic sends nothing)."""
    size = shape[array_axis]
    if size < 3 * halo:
        raise ValueError(f"axis {array_axis} of {shape} thinner than 3*halo={3 * halo}")
    if k == 1 and not periodic:
        return ()
    to_left, to_right = _neighbor_perms(k, periodic)
    left_hops = ((axis_name, to_left),) if k > 1 else ()
    right_hops = ((axis_name, to_right),) if k > 1 else ()

    # a 1-D face has no tangent axis to partition along
    part_axis = None
    if n_parts > 1 and len(shape) > 1:
        part_axis = _tangent_axis(shape, array_axis)
    eff_parts = n_parts if part_axis is not None else 1

    def window(src_edge: int, dst_edge: int) -> tuple[tuple, tuple, tuple]:
        src, dst, sz = [0] * len(shape), [0] * len(shape), list(shape)
        src[array_axis], dst[array_axis], sz[array_axis] = src_edge, dst_edge, halo
        return tuple(src), tuple(dst), tuple(sz)

    # left interiors travel left and fill the *right* ghosts there
    left = Message(*window(halo, size - halo), left_hops,
                   n_parts=eff_parts, part_axis=part_axis)
    right = Message(*window(size - 2 * halo, 0), right_hops,
                    n_parts=eff_parts, part_axis=part_axis)
    return (left, right)


def sequential_message_groups(
    shape: tuple[int, ...], spec: HaloSpec, sizes: Mapping[str, int],
) -> tuple[tuple[Message, ...], ...]:
    """The sequential schedule: one message group per decomposed axis."""
    return tuple(
        axis_message_group(
            shape, axis_name, array_axis, k=sizes[axis_name], halo=spec.halo,
            periodic=spec.periodic, n_parts=spec.n_parts,
        )
        for axis_name, array_axis in zip(spec.mesh_axes, spec.array_axes)
    )


def _local_shape(x: torch.Tensor, mesh: VirtualMesh) -> tuple[int, ...]:
    if x.shape[0] != mesh.local_size:
        raise ValueError(f"expected (R={mesh.local_size}, *local), got {tuple(x.shape)}")
    return tuple(x.shape[1:])


def exchange(x: torch.Tensor, spec: HaloSpec, mesh: VirtualMesh) -> torch.Tensor:
    """Full sequential halo exchange of ``x`` (R, *local) in place."""
    groups = sequential_message_groups(_local_shape(x, mesh), spec, mesh_sizes(spec, mesh))
    return exchange_messages(x, groups, mesh=mesh, packer=spec.packer,
                             transport=spec.transport, coalesce=spec.coalesce)


# ---------------------------------------------------------------------------
# fused multi-axis exchange (all faces/edges/corners in one pass)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedSlab:
    """One message of the fused exchange: a face, edge or corner block;
    ``offsets[i]`` is its direction (-1/0/+1) along decomposed axis i."""

    offsets: tuple[int, ...]
    src_start: tuple[int, ...]
    dst_start: tuple[int, ...]
    shape: tuple[int, ...]


def fused_slab_table(shape: tuple[int, ...], spec: HaloSpec) -> tuple[FusedSlab, ...]:
    """Every neighbor message of one fused step, from the original buffer."""
    h = spec.halo
    table = []
    for offs in itertools.product((-1, 0, 1), repeat=len(spec.array_axes)):
        if not any(offs):
            continue
        src, dst, size = [0] * len(shape), [0] * len(shape), list(shape)
        for o, a in zip(offs, spec.array_axes):
            s = shape[a]
            if s < 3 * h:
                raise ValueError(f"axis {a} of {shape} thinner than 3*halo={3 * h}")
            if o == +1:  # rightmost interior -> right neighbor's left ghost
                src[a], size[a], dst[a] = s - 2 * h, h, 0
            elif o == -1:  # leftmost interior -> left neighbor's right ghost
                src[a], size[a], dst[a] = h, h, s - h
            else:  # not travelling along this axis: span its interior
                src[a], size[a], dst[a] = h, s - 2 * h, h
        table.append(FusedSlab(offs, tuple(src), tuple(dst), tuple(size)))
    return tuple(table)


def fused_message_group(
    shape: tuple[int, ...], spec: HaloSpec, sizes: Mapping[str, int],
) -> tuple[Message, ...]:
    """The fused schedule as ONE independent message group (one hop per
    non-zero direction offset; single-shard non-periodic axes elided)."""
    perms = {name: _neighbor_perms(sizes[name], spec.periodic) for name in spec.mesh_axes}
    group = []
    for slab in fused_slab_table(shape, spec):
        if not spec.periodic and any(
            o != 0 and sizes[name] == 1 for o, name in zip(slab.offsets, spec.mesh_axes)
        ):
            continue
        hops = []
        for o, name in zip(slab.offsets, spec.mesh_axes):
            if o == +1:
                hops.append((name, perms[name][1]))  # to_right
            elif o == -1:
                hops.append((name, perms[name][0]))  # to_left
        group.append(Message(slab.src_start, slab.dst_start, slab.shape, tuple(hops)))
    return tuple(group)


def exchange_fused(x: torch.Tensor, spec: HaloSpec, mesh: VirtualMesh) -> torch.Tensor:
    """Full halo exchange of ``x`` (R, *local) as ONE fused pass, in place;
    bit-identical ghosts to :func:`exchange`."""
    group = fused_message_group(_local_shape(x, mesh), spec, mesh_sizes(spec, mesh))
    return exchange_messages(x, (group,), mesh=mesh, packer=spec.packer,
                             transport=spec.transport, coalesce=spec.coalesce)
