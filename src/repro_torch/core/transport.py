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
  nothing get zeros); ``"multihost"`` — the mesh spans the processes of a
  ``torch.distributed`` grid, and the rows a hop moves between two
  processes travel as one gloo message each way.

Tensors here are the stacked block's free view ``x`` of shape
``(R, *local_ghosted)``, ``R`` the ranks this process stacks: one pack
covers the same window of every rank (the SPMD property), and the wire
buffers are ``(R, ...)``.  The port updates
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
import collections
import contextlib
import dataclasses
import itertools
import math
import os
import time
import warnings
from typing import Any, Callable, ClassVar, Iterable, Mapping, Sequence

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
    #: autotune provenance of the cell (``None`` for caller-pinned cells)
    selected_by: str | None = None
    epoch: int | None = None

    def tag(self) -> str:
        axes = "x".join(self.mesh_axes) or "-"
        base = f"{self.kind}[{axes}]@{self.packer}/{self.transport}"
        if self.mapping != "row-major":
            base += f"%{self.mapping}"
        if self.selected_by is not None:
            base += f"?{self.selected_by}"
        if self.epoch is not None:
            base += f"!e{self.epoch}"
        return base + ("+coalesced" if self.coalesce else "")


# ---------------------------------------------------------------------------
# hop locality: which scheduled sends cross a node boundary
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HopLocality:
    """Inter- vs intra-node tally of one schedule's directed sends; fields
    as ``repro.core.transport.HopLocality``.

    Counted per rank-level directed send: every mesh coordinate sends each
    (expanded-partition) message once whose full hop chain is defined
    (clipped non-periodic edges drop the send); hop-free self-copies are
    not counted.  ``*_elems`` weight each send by its slab element count.
    """

    intra_sends: int = 0
    inter_sends: int = 0
    intra_elems: int = 0
    inter_elems: int = 0

    @property
    def total_sends(self) -> int:
        return self.intra_sends + self.inter_sends

    def __add__(self, other: "HopLocality") -> "HopLocality":
        return HopLocality(
            self.intra_sends + other.intra_sends,
            self.inter_sends + other.inter_sends,
            self.intra_elems + other.intra_elems,
            self.inter_elems + other.inter_elems,
        )


def message_locality(
    msg: Message,
    *,
    axis_order: Sequence[str],
    axis_sizes: Mapping[str, int],
    node_of: Sequence[int],
) -> HopLocality:
    """Classify one message's per-rank sends as intra- vs inter-node.

    ``axis_order`` is the mesh's axis-name tuple; ``node_of[flat_coord]``
    is the node id at each row-major coordinate
    (:meth:`repro_torch.launch.mapping.Mapping.node_of`, or
    :func:`repro_torch.launch.mapping.mesh_node_ids` for a live mesh).  Each
    partition is walked over every source coordinate: the composed hop
    chain maps it to its destination, and the send is inter-node iff the
    two coordinates live on different nodes.
    """
    shape = tuple(axis_sizes[name] for name in axis_order)
    if len(node_of) != math.prod(shape):
        raise ValueError(f"node_of has {len(node_of)} entries for mesh {shape}")
    index = {name: i for i, name in enumerate(axis_order)}

    def flat(coords: Sequence[int]) -> int:
        idx = 0
        for c, k in zip(coords, shape):
            idx = idx * k + c
        return idx

    out = HopLocality()
    for part in msg.partitions():
        if not part.hops:
            continue  # self-copy: nothing crosses any boundary
        maps = [(index[name], dict(perm)) for name, perm in part.hops]
        elems = math.prod(part.shape)
        intra = inter = 0
        for coords in itertools.product(*[range(k) for k in shape]):
            dst = list(coords)
            for a, m in maps:
                if coords[a] not in m:
                    dst = None  # clipped edge: this rank sends nothing
                    break
                dst[a] = m[coords[a]]
            if dst is None:
                continue
            if node_of[flat(coords)] == node_of[flat(dst)]:
                intra += 1
            else:
                inter += 1
        out = out + HopLocality(intra, inter, intra * elems, inter * elems)
    return out


def schedule_locality(
    groups: Sequence[Sequence[Message]],
    *,
    axis_order: Sequence[str],
    axis_sizes: Mapping[str, int],
    node_of: Sequence[int],
) -> HopLocality:
    """Whole-schedule hop-locality tally (sum over every group's messages):
    what the §VI sweep records per cell (``intra_node_sends`` /
    ``inter_node_sends``), from the static tables alone."""
    out = HopLocality()
    for group in groups:
        for msg in group:
            out = out + message_locality(
                msg, axis_order=axis_order, axis_sizes=axis_sizes, node_of=node_of,
            )
    return out


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
    """One (composed) hop as a gather over this process's rows: receiver
    row ``r`` takes row ``src[r]``; ``missing[r]`` marks receivers with no
    sender (``None`` when every row receives)."""

    src: torch.Tensor
    missing: torch.Tensor | None


def rank_sources(axis_name, perm, mesh: VirtualMesh) -> list[int | None]:
    """Sending coordinate of every receiving coordinate of the whole mesh
    for one hop over ``axis_name`` (a name or, for a composed hop, a tuple
    of names linearized row-major in that order); coordinates along the
    other mesh axes stay.  Indices are row-major coordinates, not rows of a
    process: :meth:`Transport.route_table` maps them to rows."""
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
    """Moves packed ``(R, ...)`` buffers between the ranks of a mesh.

    A move is split like ``MPI_Start``/``MPI_Wait``: :meth:`start` posts
    it, :meth:`wait` completes it, so a caller can post several moves
    before it waits for the first; :meth:`move` is both in one call."""

    name: ClassVar[str] = ""

    @abc.abstractmethod
    def route_table(self, hop: Hop, mesh: VirtualMesh, wire: torch.Tensor | None = None,
                    *, tag: int = 0) -> Route:
        """The tables of one (composed) hop over ``mesh``, built once per
        plan.  ``wire`` is the buffer the route will move (a transport that
        stages through buffers of its own sizes them by it); ``tag`` tells
        this route's messages from a plan's other routes."""

    @abc.abstractmethod
    def start(self, buf: torch.Tensor, route: Route, out: torch.Tensor | None = None) -> Any:
        """Post one collective of ``buf`` into ``out``; what it returns is
        :meth:`wait`'s argument.  Ranks receiving nothing get zeros
        (ppermute rule)."""

    def wait(self, pending: Any) -> torch.Tensor:
        """Complete a started collective; returns the received buffer."""
        return pending

    def move(self, buf: torch.Tensor, route: Route, out: torch.Tensor | None = None) -> torch.Tensor:
        """One collective, started and completed."""
        return self.wait(self.start(buf, route, out))

    def capturable(self, mesh: VirtualMesh) -> bool:
        """Whether a move over ``mesh`` is device work alone, so that a
        step holding it can be captured as a CUDA graph (a move that calls
        the host, such as a socket send, cannot)."""
        return True

    def validate(self) -> None:
        """Runtime sanity check when the backend is resolved for a schedule."""


@dataclasses.dataclass(frozen=True)
class LoopbackTransport(Transport):
    """All ranks in one process: a hop is ONE ``index_select`` over the rank
    dim from a precomputed source index, plus a zero-fill of the receivers
    that have no sender (non-periodic edges)."""

    name: str = "loopback"

    def route_table(self, hop, mesh, wire=None, *, tag=0):
        if mesh.processes > 1:
            raise ValueError(f"transport {self.name!r} cannot cross processes; the mesh spans "
                             f"{mesh.processes} (use transport='multihost')")
        axis_name, perm = hop
        src_of = rank_sources(axis_name, perm, mesh)
        src = torch.tensor([0 if s is None else s for s in src_of],
                           dtype=torch.int64, device=mesh.device)
        missing = None
        if any(s is None for s in src_of):
            missing = torch.tensor([s is None for s in src_of], device=mesh.device)
        return Route(src, missing)

    def start(self, buf, route, out=None):
        if out is None:
            out = torch.empty_like(buf)
        torch.index_select(buf, 0, route.src, out=out)
        if route.missing is not None:
            out.masked_fill_(route.missing.view(-1, *([1] * (buf.dim() - 1))), 0)
        return out


#: host seconds the multihost transport spent staging cross-process
#: messages, by part: ``"d2h"`` waiting for a move's packed rows to reach
#: the host (the pack kernels queued before it included), ``"gloo"`` in
#: ``torch.distributed`` posts and waits, ``"h2d"`` copying arrivals to the
#: card; :func:`reset_staging` zeroes it
STAGING_SECONDS: collections.Counter = collections.Counter()


def reset_staging() -> None:
    STAGING_SECONDS.clear()


@dataclasses.dataclass(frozen=True, eq=False)
class _Peer:
    """The rows one route exchanges with one other process: ``rows`` index
    this process's rows (senders or receivers, in the receivers' coordinate
    order), ``host`` is the wire on the host (pinned on the card), ``dev``
    its staging copy on the card (``None`` on the CPU)."""

    process: int
    tag: int
    rows: torch.Tensor
    host: torch.Tensor
    dev: torch.Tensor | None


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessRoute(Route):
    """A hop over a mesh that spans processes: ``src``/``missing`` serve
    the rows whose sender is in this process; each other process's rows go
    and come as ONE message a direction (``sends``, ``recvs``)."""

    sends: tuple[_Peer, ...] = ()
    recvs: tuple[_Peer, ...] = ()


@dataclasses.dataclass(frozen=True)
class MultiHostTransport(LoopbackTransport):
    """The multi-process backend (the JAX ``multihost`` transport's name
    and role): the mesh spans the processes of a ``torch.distributed``
    grid booted by :mod:`repro_torch.launch.stencil`, each stacking its own
    rows (:attr:`~repro_torch.core.mesh.VirtualMesh.local_coords`).

    A hop gathers the rows whose sender is local with one ``index_select``,
    as ``loopback`` does, and exchanges every other row with the process
    that holds it: the rows bound for one process are gathered into one
    wire buffer and posted as one ``isend``; the rows coming from one
    process arrive by one ``irecv`` and are scattered into place.  Tags
    pair messages by (route, source process, destination process).  The
    backend is gloo: NCCL refuses two processes on one card, and gloo sends
    host memory, so on the card a message goes the way MPI does without
    GPU-direct: device gather, copy to pinned host memory (ordered behind
    the pack by an event), gloo, copy back, device scatter.  Those host
    calls cannot sit in a CUDA graph, so a step over processes is not
    :meth:`capturable` and its plan runs eagerly.

    On a mesh of one process it IS ``loopback``; selecting it in a
    single-process runtime outside tests warns once (:meth:`validate`), as
    the JAX transport does."""

    name: str = "multihost"

    #: one warning per process, not one per exchange
    _warned_single_process: ClassVar[bool] = False

    @staticmethod
    def is_multihost() -> bool:
        import torch.distributed as dist

        return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1

    def validate(self) -> None:
        if self.is_multihost() or MultiHostTransport._warned_single_process:
            return
        if (os.environ.get("PYTEST_CURRENT_TEST")
                or os.environ.get("REPRO_TORCH_ALLOW_SINGLE_PROCESS_MULTIHOST")):
            return
        MultiHostTransport._warned_single_process = True
        warnings.warn(
            "transport='multihost' selected but torch.distributed runs one process: no "
            "message will cross a process boundary (the schedule runs as loopback).  Boot a "
            "grid with `python -m repro_torch.launch.stencil --processes N ...` or the sweep's "
            "--processes flag; set REPRO_TORCH_ALLOW_SINGLE_PROCESS_MULTIHOST=1 if this is "
            "deliberate.",
            RuntimeWarning,
            stacklevel=3,
        )

    def capturable(self, mesh):
        return mesh.processes == 1

    def route_table(self, hop, mesh, wire=None, *, tag=0):
        if mesh.processes == 1:
            return super().route_table(hop, mesh)
        import torch.distributed as dist

        if not (dist.is_initialized() and dist.get_world_size() == mesh.processes
                and dist.get_rank() == mesh.process_index):
            raise RuntimeError(
                f"a mesh of {mesh.processes} processes (this one {mesh.process_index}) needs a "
                f"torch.distributed grid of that size with this rank "
                f"(see repro_torch.launch.stencil)")
        axis_name, perm = hop
        src_of = rank_sources(axis_name, perm, mesh)
        me, procs, dev = mesh.process_index, mesh.processes, mesh.device
        row = {c: i for i, c in enumerate(mesh.local_coords)}
        src = [0] * mesh.local_size
        missing = [False] * mesh.local_size
        recv_rows: dict[int, list[int]] = {}
        send_rows: dict[int, list[int]] = {}
        # both sides walk receivers in coordinate order, so a message's rows
        # line up without any header
        for r, s in enumerate(src_of):
            to, frm = mesh.process_of(r), None if s is None else mesh.process_of(s)
            if to == me:
                if s is None:
                    missing[row[r]] = True
                elif frm == me:
                    src[row[r]] = row[s]
                else:
                    recv_rows.setdefault(frm, []).append(row[r])
            elif frm == me:
                send_rows.setdefault(to, []).append(row[s])
        if (send_rows or recv_rows) and wire is None:
            raise ValueError("a route across processes needs its wire buffer to size its staging")

        def peers(table: dict[int, list[int]], sending: bool) -> tuple[_Peer, ...]:
            out = []
            for q, rows in sorted(table.items()):
                a, b = (me, q) if sending else (q, me)
                shape = (len(rows), *wire.shape[1:])
                cuda = dev.type == "cuda"
                out.append(_Peer(
                    process=q, tag=(tag * procs + a) * procs + b,
                    rows=torch.tensor(rows, dtype=torch.int64, device=dev),
                    host=torch.empty(shape, dtype=wire.dtype, pin_memory=cuda),
                    dev=torch.empty(shape, dtype=wire.dtype, device=dev) if cuda else None,
                ))
            return tuple(out)

        return ProcessRoute(
            src=torch.tensor(src, dtype=torch.int64, device=dev),
            missing=torch.tensor(missing, device=dev) if any(missing) else None,
            sends=peers(send_rows, True), recvs=peers(recv_rows, False),
        )

    def start(self, buf, route, out=None):
        if not isinstance(route, ProcessRoute):
            return super().start(buf, route, out)
        import torch.distributed as dist

        for p in route.sends:  # MPI_Pready: the rows bound for each process
            if p.dev is None:
                torch.index_select(buf, 0, p.rows, out=p.host)
            else:
                torch.index_select(buf, 0, p.rows, out=p.dev)
                p.host.copy_(p.dev, non_blocking=True)
        out = super().start(buf, route, out)  # the rows whose sender is here
        if buf.device.type == "cuda" and (route.sends or route.recvs):
            # the host waits for the staged rows, and for every earlier copy
            # out of the receive buffers it is about to post
            t0 = time.perf_counter()
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            STAGING_SECONDS["d2h"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        recvs = [dist.irecv(p.host, p.process, tag=p.tag) for p in route.recvs]
        sends = [dist.isend(p.host, p.process, tag=p.tag) for p in route.sends]
        STAGING_SECONDS["gloo"] += time.perf_counter() - t0
        return route, out, recvs, sends

    def wait(self, pending):
        if isinstance(pending, torch.Tensor):
            return pending
        route, out, recvs, sends = pending
        for p, work in zip(route.recvs, recvs):  # MPI_Parrived, process by process
            t0 = time.perf_counter()
            work.wait()
            t1 = time.perf_counter()
            STAGING_SECONDS["gloo"] += t1 - t0
            if p.dev is None:
                out.index_copy_(0, p.rows, p.host)
            else:
                p.dev.copy_(p.host)  # from pinned memory; returns once it landed
                out.index_copy_(0, p.rows, p.dev)
                STAGING_SECONDS["h2d"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        for work in sends:
            work.wait()
        STAGING_SECONDS["gloo"] += time.perf_counter() - t0
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
register_transport(MultiHostTransport())


# ---------------------------------------------------------------------------
# delivery choreography
# ---------------------------------------------------------------------------

#: the chaos seam (:func:`chaos_scope`): when set, the exchange calls it at
#: labeled points while it builds a schedule's tables — ``"group"`` on
#: entering a delivery group, ``"round"`` before each coalesced partition
#: round — the counterpart of the JAX package's trace-time points.  A probe
#: that raises aborts the plan's init (no half-built plan is cached).
_CHAOS_PROBE: Callable[[str], None] | None = None


@contextlib.contextmanager
def chaos_scope(probe: Callable[[str], None] | None):
    """Install ``probe`` as the exchange's chaos hook for the dynamic extent
    of the block (``None`` leaves the seam disabled)."""
    global _CHAOS_PROBE
    prev, _CHAOS_PROBE = _CHAOS_PROBE, probe
    try:
        yield
    finally:
        _CHAOS_PROBE = prev


def _chaos(point: str) -> None:
    if _CHAOS_PROBE is not None:
        _CHAOS_PROBE(point)


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
    wire buffers and the transport's staging buffers allocated, sized by
    the rows this process stacks (the ``MPI_Send_init`` work).
    :meth:`run` then only packs, moves and unpacks.

    Groups run in order (group *i+1* packs from what group *i* unpacked —
    the sequential corner trick).  Uncoalesced: every partition of every
    message is packed and moved before any unpack.  Coalesced: one buffer
    and one move per (round, hop chain); every round is packed and its
    move started (``MPI_Pready``) before the first round's arrivals are
    unpacked (``MPI_Parrived``), round by round.  That equals JAX's "every
    round packs from the group's original buffer": a group's sources and
    ghost windows are disjoint.
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
        #: rows of the stacked block this process holds
        self.ranks = ranks = mesh.local_size
        #: whether a step of this schedule may be captured as a CUDA graph
        self.capturable = t.capturable(mesh)
        dev = mesh.device
        wire = p.wire_dtype(dtype)
        tags = itertools.count()
        self.layouts: list[WireLayout] = []
        self._groups: list[list] = []
        for group in self.groups:
            _chaos("group")
            if coalesce:
                rounds = []
                for chains in coalesced_rounds(group):
                    _chaos("round")
                    cells = []
                    for hops, parts in chains:
                        layout = coalesced_layout(parts, hops, p, dtype)
                        hop = composed_hop(hops, mesh.shape)
                        send = torch.empty((ranks, layout.total), dtype=wire, device=dev)
                        route = (None if hop is None
                                 else t.route_table(hop, mesh, send, tag=next(tags)))
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
                            part, [t.route_table(h, mesh, send, tag=next(tags)) for h in part.hops],
                            (send, torch.empty_like(send) if part.hops else None),
                        ))
                self._groups.append(singles)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """Deliver the whole schedule into ``x`` (R, *local) in place."""
        if tuple(x.shape) != (self.ranks, *self.local_shape):
            raise ValueError(f"block {tuple(x.shape)} != plan's {(self.ranks, *self.local_shape)}")
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
            started = []
            for cells in group:
                for c in cells:
                    p.pack_coalesced(x, c.layout, table=c.table, out=c.send)
                for c in cells:
                    started.append((c, None if c.route is None
                                    else t.start(c.send, c.route, out=c.recv)))
            for c, pending in started:
                buf = c.send if pending is None else t.wait(pending)
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
