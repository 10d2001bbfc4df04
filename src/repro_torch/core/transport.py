"""Unified pack/transport layer beneath every exchange path (PyTorch port).

The port of ``src/repro/core/transport.py``.  Every exchange describes its
data movement as :class:`Message` tables; a :class:`Packer` (how a slab
window becomes a contiguous wire buffer and back) and a :class:`Transport`
(how a packed buffer crosses the mesh) are chosen by *name*:

* packers: ``"slice"`` (plain tensor copies), ``"cuda"`` (the hand-written
  copy/gather kernels of :mod:`repro_torch.kernels.pack`, the counterpart of
  the JAX ``"pallas"`` packer), and the wire-compressed ``"bf16"`` and
  ``"scaled-int8"``.
* transports: ``"loopback"`` — all ranks of the :class:`~repro_torch.core.
  mesh.VirtualMesh` live stacked on one device, and one hop is ONE index
  gather over the rank dim (``lax.ppermute``'s counterpart, ranks receiving
  nothing get zeros).

Tensors here are the stacked block's free view ``x`` of shape
``(R, *local_ghosted)``: one pack covers the same window of every rank (the
SPMD property), and the wire buffers are ``(R, ...)``.  The port updates
``x`` in place.  Within a delivery group every source slab is disjoint from
every destination ghost window, so writing arrivals in place is equivalent
to the JAX package's "every round packs from the group's original buffer".

:class:`PreparedExchange` is the persistent half: message tables, wire
layouts, route tables, device-resident segment tables and preallocated wire
buffers built once; :func:`exchange_messages` builds one per call (the
standard baseline's per-step setup) and runs it.
"""

from __future__ import annotations

import abc
import dataclasses
import itertools
import math
from typing import Any, ClassVar, Iterable, Mapping, Sequence

import torch

from repro_torch.core.compat import torch_dtype
from repro_torch.core.mesh import VirtualMesh


# ---------------------------------------------------------------------------
# Partitioner: the equal-partition (+padding) rule from the paper
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Partitioner:
    """Splits an axis into ``n_parts`` equal partitions, the tail clipped
    when the size does not divide (the paper's equal-size constraint)."""

    n_parts: int
    axis: int = 0

    def pad_amount(self, size: int) -> int:
        return (-size) % self.n_parts

    def part_size(self, size: int) -> int:
        return (size + self.pad_amount(size)) // self.n_parts

    def slices(self, size: int) -> list[tuple[int, int]]:
        """(offset, valid width) of each partition within the *un-padded*
        axis; the tail partition's width is clipped (0 when fully padding)."""
        c = self.part_size(size)
        return [
            (i * c, max(0, min(c, size - i * c))) for i in range(self.n_parts)
        ]


# ---------------------------------------------------------------------------
# Message tables
# ---------------------------------------------------------------------------

#: one transport hop: (mesh axis name, source->target permutation table)
Hop = tuple[str, tuple[tuple[int, int], ...]]


@dataclasses.dataclass(frozen=True)
class Message:
    """One message of an exchange: src slab -> (hops) -> dst ghost window.

    Same fields and meaning as ``repro.core.transport.Message``: windows in
    local ghosted-block coordinates, one ``(axis_name, perm)`` hop per mesh
    axis crossed (empty = hop-free self-copy), ``n_parts`` equal partitions
    along ``part_axis``.
    """

    src_start: tuple[int, ...]
    dst_start: tuple[int, ...]
    shape: tuple[int, ...]
    hops: tuple[Hop, ...] = ()
    n_parts: int = 1
    part_axis: int | None = None

    def __post_init__(self):
        if not len(self.src_start) == len(self.dst_start) == len(self.shape):
            raise ValueError((self.src_start, self.dst_start, self.shape))
        if self.n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {self.n_parts}")
        if self.n_parts > 1 and self.part_axis is None:
            raise ValueError("partitioned message needs part_axis")

    def partitions(self) -> tuple["Message", ...]:
        """Per-partition single messages on the equal-size grid; windows
        clipped to the slab, all-padding tail partitions elided."""
        if self.n_parts <= 1:
            return (self,)
        a = self.part_axis
        out = []
        for off, width in Partitioner(self.n_parts, a).slices(self.shape[a]):
            if width <= 0:
                continue
            src, dst, shape = list(self.src_start), list(self.dst_start), list(self.shape)
            src[a] += off
            dst[a] += off
            shape[a] = width
            out.append(Message(tuple(src), tuple(dst), tuple(shape), self.hops))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class WireSegment:
    """One slab's place inside a coalesced wire buffer (offset in wire
    elements; windows as on :class:`Message`)."""

    offset: int
    src_start: tuple[int, ...]
    dst_start: tuple[int, ...]
    shape: tuple[int, ...]

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class WireLayout:
    """Static offset table of ONE coalesced wire buffer (one hop chain)."""

    hops: tuple[Hop, ...]
    segments: tuple[WireSegment, ...]
    total: int
    wire_itemsize: int

    @property
    def wire_bytes(self) -> int:
        return self.total * self.wire_itemsize


def coalesced_layout(
    parts: Sequence[Message], hops: tuple[Hop, ...], packer: "Packer", dtype: Any,
) -> WireLayout:
    """Lay single-partition messages sharing ``hops`` end to end in one wire
    buffer (segment order = message order, offsets in wire elements)."""
    segments, offset = [], 0
    for m in parts:
        assert m.hops == hops, (m.hops, hops)
        assert m.n_parts == 1, "layouts are built from expanded partitions"
        segments.append(WireSegment(offset, m.src_start, m.dst_start, m.shape))
        offset += math.prod(m.shape)
    return WireLayout(
        hops=tuple(hops), segments=tuple(segments), total=offset,
        wire_itemsize=packer.wire_itemsize(dtype),
    )


def coalesced_rounds(
    messages: Iterable[Message],
) -> list[list[tuple[tuple[Hop, ...], list[Message]]]]:
    """The pipelined partition schedule of one delivery group: round *r*
    holds every message's *r*-th partition, grouped by hop chain in
    first-seen order (one coalesced buffer per ``(chain, parts)`` cell)."""
    per_msg = [m.partitions() for m in messages]
    n_rounds = max((len(p) for p in per_msg), default=0)
    rounds = []
    for r in range(n_rounds):
        chains: dict[tuple[Hop, ...], list[Message]] = {}
        for parts in per_msg:
            if r < len(parts):
                chains.setdefault(parts[r].hops, []).append(parts[r])
        rounds.append(list(chains.items()))
    return rounds


def composed_hop(hops: Sequence[Hop], sizes: Mapping[str, int]):
    """Compose a hop chain into ONE joint permutation over the row-major
    linearization of its axis names (``lax.ppermute``'s multi-axis rule).

    A source reaches the product of its per-axis targets iff every per-axis
    table defines the hop (clipped edges drop the whole path).  ``sizes``
    are the mesh axis sizes (the JAX version reads them inside
    ``shard_map``).  ``None`` means a hop-free self-copy.
    """
    hops = tuple(hops)
    if not hops:
        return None
    if len(hops) == 1:
        return hops[0]
    names = tuple(name for name, _ in hops)
    ks = [sizes[name] for name in names]
    maps = [dict(perm) for _, perm in hops]

    def lin(coords: Sequence[int]) -> int:
        idx = 0
        for c, k in zip(coords, ks):
            idx = idx * k + c
        return idx

    pairs = []
    for coords in itertools.product(*[range(k) for k in ks]):
        if all(c in m for c, m in zip(coords, maps)):
            pairs.append((lin(coords), lin([m[c] for c, m in zip(coords, maps)])))
    return (names, tuple(pairs))


def scheduled_collective_count(
    groups: Sequence[Sequence[Message]], *, coalesce: bool
) -> int:
    """Collectives (here: rank gathers) one schedule launches per step;
    hop-free self-copies are free.  Uncoalesced: one per hop of every
    partition; coalesced: one per non-empty (round, hop chain) cell."""
    total = 0
    for group in groups:
        if coalesce:
            for chains in coalesced_rounds(group):
                total += sum(1 for hops, _ in chains if hops)
        else:
            for msg in group:
                for part in msg.partitions():
                    total += len(part.hops)
    return total


def schedule_layouts(
    groups: Sequence[Sequence[Message]], packer: "str | Packer", dtype: Any,
) -> tuple[WireLayout, ...]:
    """All wire-buffer offset tables of a coalesced schedule, in delivery
    order (group, partition round, hop chain)."""
    p = resolve_packer(packer)
    out = []
    for group in groups:
        for chains in coalesced_rounds(group):
            for hops, parts in chains:
                out.append(coalesced_layout(parts, hops, p, dtype))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ScheduleInfo:
    """Identity of one transport schedule (plan names and keys); fields as
    ``repro.core.transport.ScheduleInfo``."""

    kind: str
    mesh_axes: tuple[str, ...]
    packer: str = "slice"
    transport: str = "loopback"
    coalesce: bool = False
    mapping: str = "row-major"
    epoch: int | None = None

    def tag(self) -> str:
        axes = "x".join(self.mesh_axes) or "-"
        base = f"{self.kind}[{axes}]@{self.packer}/{self.transport}"
        if self.mapping != "row-major":
            base += f"%{self.mapping}"
        if self.epoch is not None:
            base += f"!e{self.epoch}"
        return base + ("+coalesced" if self.coalesce else "")


# ---------------------------------------------------------------------------
# Packer: slab window <-> contiguous wire buffer
# ---------------------------------------------------------------------------


def window(x: torch.Tensor, start: Sequence[int], shape: Sequence[int]) -> torch.Tensor:
    """The ``[start, start+shape)`` window of every rank of ``x`` (R, *local)
    as a strided view."""
    return x[(slice(None), *(slice(b, b + n) for b, n in zip(start, shape)))]


class Packer(abc.ABC):
    """Packs a slab window of every rank into a contiguous ``(R, *shape)``
    wire buffer, and writes a received one into a ghost window in place."""

    name: ClassVar[str] = ""

    def wire_dtype(self, dtype: torch.dtype) -> torch.dtype:
        """What one element is on the wire (exact packers: unchanged)."""
        return dtype

    @abc.abstractmethod
    def pack(self, x: torch.Tensor, start, shape, out: torch.Tensor | None = None) -> torch.Tensor:
        """Stage the window as one contiguous wire buffer (into ``out``)."""

    @abc.abstractmethod
    def unpack(self, x: torch.Tensor, buf: torch.Tensor, dst_start, shape) -> None:
        """Write a received wire buffer into the ghost window of ``x``."""

    # -- coalesced wire buffers (one buffer per neighbor) -------------------
    def table(self, layout: WireLayout, local_shape, device) -> torch.Tensor | None:
        """Device-side description of ``layout`` a persistent plan uploads
        once (kernel packers); ``None`` when the packer needs none."""
        return None

    def pack_coalesced(self, x, layout: WireLayout, *, table=None, out=None) -> torch.Tensor:
        """Fill one ``(R, total)`` coalesced buffer, segment by segment
        (kernel packers override with one gather launch)."""
        if out is None:
            out = torch.empty((x.shape[0], layout.total),
                              dtype=self.wire_dtype(x.dtype), device=x.device)
        for s in layout.segments:
            seg = out[:, s.offset:s.offset + s.numel].unflatten(1, s.shape)
            self.pack(x, s.src_start, s.shape, out=seg)
        return out

    def unpack_coalesced(self, x, buf: torch.Tensor, layout: WireLayout) -> None:
        """Scatter an arrived coalesced buffer into its ghost windows."""
        for s in layout.segments:
            seg = buf[:, s.offset:s.offset + s.numel].unflatten(1, s.shape)
            self.unpack(x, seg, s.dst_start, s.shape)

    # -- wire-format introspection -----------------------------------------
    def wire_itemsize(self, dtype: Any) -> int:
        return self.wire_dtype(torch_dtype(dtype)).itemsize

    def wire_tolerance(self, dtype: Any) -> tuple[float, float]:
        """``(rtol, atol)`` of ``unpack(pack(window))``; ``(0, 0)`` = exact."""
        return (0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class SlicePacker(Packer):
    """Plain tensor copies: the wire buffer *is* the slab."""

    name: str = "slice"

    def pack(self, x, start, shape, out=None):
        win = window(x, start, shape)
        return win.clone(memory_format=torch.contiguous_format) if out is None else out.copy_(win)

    def unpack(self, x, buf, dst_start, shape):
        window(x, dst_start, shape).copy_(buf.reshape(x.shape[0], *shape))


@dataclasses.dataclass(frozen=True)
class CudaPacker(Packer):
    """The hand-written CUDA copy kernels (the JAX ``pallas`` packer's
    counterpart): ``copy_convert`` reads each slab in place and writes each
    arrival straight into its ghost window; a coalesced buffer is filled by
    ONE ``gather_pack`` launch from a device segment table.  On a CPU
    tensor the plain versions run (:mod:`repro_torch.kernels.pack.ops`)."""

    name: str = "cuda"

    def pack(self, x, start, shape, out=None):
        from repro_torch.kernels.pack.ops import pack_slab

        return pack_slab(window(x, start, shape),
                         out_dtype=self.wire_dtype(x.dtype), out=out)

    def unpack(self, x, buf, dst_start, shape):
        from repro_torch.kernels.pack.ops import unpack_slab

        unpack_slab(buf, window(x, dst_start, shape))

    def table(self, layout, local_shape, device):
        from repro_torch.kernels.pack.pack import segment_table

        if device.type != "cuda":
            return None
        return segment_table(layout.segments, local_shape, device)

    def pack_coalesced(self, x, layout, *, table=None, out=None):
        from repro_torch.kernels.pack.ops import gather_pack

        return gather_pack(x, layout.segments, total=layout.total,
                           out_dtype=self.wire_dtype(x.dtype), table=table, out=out)


@dataclasses.dataclass(frozen=True)
class Bf16Packer(CudaPacker):
    """Wire-compressed: the slab crosses the wire as ``bfloat16`` through
    the same CUDA kernels (round-to-nearest-even); unpack restores the block
    dtype.  Lossy for f32: tolerance 2x the bf16 half-ulp (2^-7)."""

    name: str = "bf16"

    def wire_dtype(self, dtype):
        return torch.bfloat16

    def wire_tolerance(self, dtype):
        if torch_dtype(dtype) == torch.bfloat16:
            return (0.0, 0.0)  # the cast is the identity
        return (1.0 / 128.0, 1e-6)


@dataclasses.dataclass(frozen=True)
class ScaledInt8Packer(Packer):
    """Wire-compressed: fixed-scale symmetric int8, ``round(x * 127 / amax)``
    (half to even) clipped to +-127; unpack rescales and restores the block
    dtype.  Plain tensor ops, as in the JAX package."""

    name: str = "scaled-int8"
    amax: float = 8.0

    def wire_dtype(self, dtype):
        return torch.int8

    def pack(self, x, start, shape, out=None):
        slab = window(x, start, shape).to(torch.float32)
        q = torch.clamp(torch.round(slab * (127.0 / self.amax)), -127.0, 127.0)
        return q.to(torch.int8) if out is None else out.copy_(q)

    def unpack(self, x, buf, dst_start, shape):
        vals = buf.reshape(x.shape[0], *shape).to(torch.float32) * (self.amax / 127.0)
        window(x, dst_start, shape).copy_(vals)

    def wire_tolerance(self, dtype):
        return (0.0, self.amax / 127.0)  # 2x the half-step rounding bound


# ---------------------------------------------------------------------------
# Transport: how packed buffers cross the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Route:
    """One (composed) hop as a gather over the rank dim: receiver ``r``
    takes row ``src[r]``; ``missing[r]`` marks receivers with no sender
    (``None`` when every rank receives)."""

    src: torch.Tensor
    missing: torch.Tensor | None


def rank_sources(axis_name, perm, mesh: VirtualMesh) -> list[int | None]:
    """Sending rank of every receiving rank for one hop over ``axis_name``
    (a name or, for a composed hop, a tuple of names linearized row-major
    in that order); ranks along the other mesh axes keep their coordinates."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    ks = [mesh.shape[n] for n in names]
    idx = [mesh.axis_index(n) for n in names]
    dst_of = dict(perm)
    src_of: list[int | None] = [None] * mesh.size
    for r in range(mesh.size):
        coords = list(mesh.coords(r))
        sub = 0
        for i, k in zip(idx, ks):
            sub = sub * k + coords[i]
        if sub not in dst_of:
            continue
        d = dst_of[sub]
        for i, k in reversed(list(zip(idx, ks))):
            coords[i] = d % k
            d //= k
        src_of[mesh.rank(coords)] = r
    return src_of


class Transport(abc.ABC):
    """Moves packed ``(R, ...)`` buffers between the stacked ranks."""

    name: ClassVar[str] = ""

    @abc.abstractmethod
    def route_table(self, hop: Hop, mesh: VirtualMesh) -> Route:
        """The device-side table of one (composed) hop, built once per plan."""

    @abc.abstractmethod
    def move(self, buf: torch.Tensor, route: Route, out: torch.Tensor | None = None) -> torch.Tensor:
        """One collective: ranks receiving nothing get zeros (ppermute rule)."""

    def validate(self) -> None:
        """Runtime sanity check when the backend is resolved for a schedule."""


@dataclasses.dataclass(frozen=True)
class LoopbackTransport(Transport):
    """All ranks on one device: a hop is ONE ``index_select`` over the rank
    dim from a precomputed source index, plus a zero-fill of the receivers
    that have no sender (non-periodic edges)."""

    name: str = "loopback"

    def route_table(self, hop, mesh):
        axis_name, perm = hop
        src_of = rank_sources(axis_name, perm, mesh)
        src = torch.tensor([0 if s is None else s for s in src_of],
                           dtype=torch.int64, device=mesh.device)
        missing = None
        if any(s is None for s in src_of):
            missing = torch.tensor([s is None for s in src_of], device=mesh.device)
        return Route(src, missing)

    def move(self, buf, route, out=None):
        if out is None:
            out = torch.empty_like(buf)
        torch.index_select(buf, 0, route.src, out=out)
        if route.missing is not None:
            out.masked_fill_(route.missing.view(-1, *([1] * (buf.dim() - 1))), 0)
        return out


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

_PACKERS: dict[str, Packer] = {}
_TRANSPORTS: dict[str, Transport] = {}


def register_packer(packer: Packer) -> Packer:
    if not packer.name:
        raise ValueError(f"{type(packer).__name__} must carry a name")
    if packer.name in _PACKERS:
        raise ValueError(f"packer {packer.name!r} already registered")
    _PACKERS[packer.name] = packer
    return packer


def register_transport(transport: Transport) -> Transport:
    if not transport.name:
        raise ValueError(f"{type(transport).__name__} must carry a name")
    if transport.name in _TRANSPORTS:
        raise ValueError(f"transport {transport.name!r} already registered")
    _TRANSPORTS[transport.name] = transport
    return transport


def available_packers() -> tuple[str, ...]:
    return tuple(_PACKERS)


def available_transports() -> tuple[str, ...]:
    return tuple(_TRANSPORTS)


def get_packer(name: str) -> Packer:
    try:
        return _PACKERS[name]
    except KeyError:
        raise KeyError(f"unknown packer {name!r}; registered: "
                       f"{', '.join(_PACKERS) or '(none)'}") from None


def get_transport(name: str) -> Transport:
    try:
        return _TRANSPORTS[name]
    except KeyError:
        raise KeyError(f"unknown transport {name!r}; registered: "
                       f"{', '.join(_TRANSPORTS) or '(none)'}") from None


def resolve_packer(packer: str | Packer) -> Packer:
    return packer if isinstance(packer, Packer) else get_packer(packer)


def resolve_transport(transport: str | Transport) -> Transport:
    t = transport if isinstance(transport, Transport) else get_transport(transport)
    t.validate()
    return t


register_packer(SlicePacker())
register_packer(CudaPacker())
register_packer(Bf16Packer())
register_packer(ScaledInt8Packer())
register_transport(LoopbackTransport())


# ---------------------------------------------------------------------------
# delivery choreography
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _Coalesced:
    """One (round, hop chain) cell: its layout, route, segment table and
    send/receive wire buffers."""

    layout: WireLayout
    route: Route | None
    table: torch.Tensor | None
    send: torch.Tensor
    recv: torch.Tensor | None


@dataclasses.dataclass(eq=False)
class _Single:
    """One uncoalesced partition: per-hop routes and a ping-pong pair of
    wire buffers."""

    part: Message
    routes: list[Route]
    bufs: tuple[torch.Tensor, torch.Tensor | None]


class PreparedExchange:
    """A schedule ready to start: everything that does not depend on the
    data is built here, once — route tables and segment tables uploaded,
    wire buffers allocated (the ``MPI_Send_init`` work).  :meth:`run`
    then only packs, moves and unpacks.

    Groups run in order (group *i+1* packs from what group *i* unpacked —
    the sequential corner trick).  Uncoalesced: every partition of every
    message is packed and moved before any unpack.  Coalesced: one buffer
    and one gather per (round, hop chain); round *k+1* packs after round
    *k* unpacked, which equals packing from the group's original buffer
    because a group's sources and ghost windows are disjoint.
    """

    def __init__(
        self,
        groups: Sequence[Sequence[Message]],
        *,
        mesh: VirtualMesh,
        local_shape: Sequence[int],
        dtype: torch.dtype,
        packer: str | Packer = "slice",
        transport: str | Transport = "loopback",
        coalesce: bool = False,
    ):
        self.groups = tuple(tuple(g) for g in groups)
        self.packer = p = resolve_packer(packer)
        self.transport = t = resolve_transport(transport)
        self.coalesce = coalesce
        self.local_shape = tuple(local_shape)
        dev, ranks = mesh.device, mesh.size
        wire = p.wire_dtype(dtype)
        self.layouts: list[WireLayout] = []
        self._groups: list[list] = []
        for group in self.groups:
            if coalesce:
                rounds = []
                for chains in coalesced_rounds(group):
                    cells = []
                    for hops, parts in chains:
                        layout = coalesced_layout(parts, hops, p, dtype)
                        hop = composed_hop(hops, mesh.shape)
                        route = None if hop is None else t.route_table(hop, mesh)
                        send = torch.empty((ranks, layout.total), dtype=wire, device=dev)
                        cells.append(_Coalesced(
                            layout, route, p.table(layout, self.local_shape, dev), send,
                            None if route is None else torch.empty_like(send),
                        ))
                        self.layouts.append(layout)
                    rounds.append(cells)
                self._groups.append(rounds)
            else:
                singles = []
                for msg in group:
                    for part in msg.partitions():
                        send = torch.empty((ranks, *part.shape), dtype=wire, device=dev)
                        singles.append(_Single(
                            part, [t.route_table(h, mesh) for h in part.hops],
                            (send, torch.empty_like(send) if part.hops else None),
                        ))
                self._groups.append(singles)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """Deliver the whole schedule into ``x`` (R, *local) in place."""
        if tuple(x.shape[1:]) != self.local_shape:
            raise ValueError(f"block {tuple(x.shape[1:])} != plan's {self.local_shape}")
        p, t = self.packer, self.transport
        for group in self._groups:
            if not self.coalesce:
                arrived = []
                for s in group:
                    cur, spare = s.bufs
                    p.pack(x, s.part.src_start, s.part.shape, out=cur)
                    for route in s.routes:
                        t.move(cur, route, out=spare)
                        cur, spare = spare, cur
                    arrived.append((s.part, cur))
                for part, buf in arrived:
                    p.unpack(x, buf, part.dst_start, part.shape)
                continue
            for cells in group:
                for c in cells:
                    p.pack_coalesced(x, c.layout, table=c.table, out=c.send)
                for c in cells:
                    buf = c.send if c.route is None else t.move(c.send, c.route, out=c.recv)
                    p.unpack_coalesced(x, buf, c.layout)
        return x


def exchange_messages(
    x: torch.Tensor,
    groups: Sequence[Sequence[Message]],
    *,
    mesh: VirtualMesh,
    packer: str | Packer = "slice",
    transport: str | Transport = "loopback",
    coalesce: bool = False,
) -> torch.Tensor:
    """Deliver a full schedule into ``x`` (R, *local) in place, building
    every table and buffer in this call."""
    return PreparedExchange(
        groups, mesh=mesh, local_shape=x.shape[1:], dtype=x.dtype,
        packer=packer, transport=transport, coalesce=coalesce,
    ).run(x)


def deliver(
    x: torch.Tensor,
    messages: Iterable[Message],
    *,
    mesh: VirtualMesh,
    packer: str | Packer = "slice",
    transport: str | Transport = "loopback",
    coalesce: bool = False,
) -> torch.Tensor:
    """Deliver one *group* of independent messages (see
    :func:`exchange_messages`)."""
    return exchange_messages(x, (tuple(messages),), mesh=mesh, packer=packer,
                             transport=transport, coalesce=coalesce)
