"""Partitioned (chunked, early-consume) collectives: the MPI-partitioned
analogue (PyTorch port of ``src/repro/core/partitioned.py``).

The paper's partitioned communication (``MPI_Psend_init``/``Pstart``/
``Pready``/``Parrived``) splits one persistent message into equal
partitions, so that the transfer of partition *k* overlaps the packing of
partition *k+1*, and the receiver can do early work on any partition that
has arrived.  Every primitive below decomposes a collective into
``n_parts`` chunk collectives interleaved with their producer and consumer
compute; ``consume_fn`` is the ``MPI_Parrived`` hook, applied per chunk.

The JAX functions run inside ``shard_map`` on one shard each and name a
mesh axis.  Here every rank of a one-process
:class:`~repro_torch.core.mesh.VirtualMesh` is stacked on the leading dim
of one tensor, ``(R, ...)`` with ``R = mesh.size`` in the mesh's row-major
rank order, and a function takes the mesh and the axis name: a collective
over an axis runs within each group of ranks that share their other
coordinates.  Shape arguments (``split_axis``, ``gather_axis``, ...) count
the per-rank dims, as in JAX; the hooks (``pack_fn``, ``consume_fn``) see
the stacked ``(R, ...)`` chunk, every rank's partition at once.

Point-to-point hops go through the transport layer
(:meth:`repro_torch.core.transport.Transport.permute`, one rank gather a
hop); the many-to-many reductions (``psum``, ``psum_scatter``) and the
native ``all_to_all`` are tensor ops over the stacked ranks, as JAX keeps
them native collectives.  :func:`message_all_to_all` routes the same
exchange as :func:`partitioned_all_to_all` through
:func:`~repro_torch.core.transport.exchange_messages` and equals it
bitwise for the exact packers.  A mesh over several processes is refused
(ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import transport as _transport
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.transport import (
    Message,
    Packer,
    Partitioner,
    Transport,
    exchange_messages,
    resolve_packer,
    resolve_transport,
    ring_perm,
)

__all__ = [
    "Partitioner", "ring_perm", "axis_size", "axis_positions", "partitioned_ppermute",
    "ring_all_gather", "ring_all_gather_matmul", "ring_matmul_reduce_scatter",
    "partitioned_all_to_all", "all_to_all_messages", "message_all_to_all",
    "partitioned_psum_scatter", "partitioned_psum",
    "bucket_tree", "bucketed_psum_tree",
]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# the stacked ranks along one mesh axis
# ---------------------------------------------------------------------------


def axis_size(mesh: VirtualMesh, axis_name: str) -> int:
    """Ranks along ``axis_name`` (``lax.axis_size``); a mesh over several
    processes is refused."""
    if mesh.processes > 1:
        raise NotImplementedError(
            f"stacked-rank collectives over a mesh of {mesh.processes} processes: "
            f"ROADMAP Queue 1 item 17 (ring paths on a grid of processes)")
    return mesh.shape[axis_name]


@functools.lru_cache(maxsize=None)
def axis_positions(mesh: VirtualMesh, axis_name: str) -> torch.Tensor:
    """Every stacked rank's index along ``axis_name`` (``lax.axis_index``
    for all ranks at once), an ``(R,)`` int64 tensor on the mesh's device."""
    i = mesh.axis_index(axis_name)
    return torch.tensor([mesh.coords(r)[i] for r in range(mesh.size)], dtype=torch.int64,
                        device=mesh.device)


def _rows(mesh: VirtualMesh) -> torch.Tensor:
    return torch.arange(mesh.size, device=mesh.device)


def _axis_major(x: torch.Tensor, mesh: VirtualMesh, axis_name: str) -> torch.Tensor:
    """``(R, *local)`` -> ``(k, G, *local)``: the ranks along the axis
    first, the ``G`` groups of the other coordinates second."""
    i = mesh.axis_index(axis_name)
    y = x.reshape(*mesh.axis_sizes, *x.shape[1:]).movedim(i, 0)
    return y.reshape(mesh.axis_sizes[i], mesh.size // mesh.axis_sizes[i], *x.shape[1:])


def _from_axis_major(y: torch.Tensor, mesh: VirtualMesh, axis_name: str) -> torch.Tensor:
    i = mesh.axis_index(axis_name)
    sizes = list(mesh.axis_sizes)
    k = sizes.pop(i)
    z = y.reshape(k, *sizes, *y.shape[2:]).movedim(0, i)
    return z.reshape(mesh.size, *y.shape[2:])


# ---------------------------------------------------------------------------
# partitioned point-to-point (the halo-exchange transport)
# ---------------------------------------------------------------------------


def partitioned_ppermute(
    slab: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    perm: Sequence[tuple[int, int]],
    *,
    n_parts: int = 1,
    split_axis: int = 0,
    pack_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    consume_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    transport: str | Transport = "loopback",
) -> torch.Tensor:
    """Neighbor permute of the stacked ``slab`` split into ``n_parts``
    partitions along the per-rank ``split_axis``.

    ``pack_fn`` models the per-partition pack (``MPI_Pready`` after a
    thread packs its partition); ``consume_fn`` is per-partition early work
    on arrival (``MPI_Parrived``).  With ``n_parts=1`` this is the standard
    single-message exchange."""
    axis_size(mesh, axis_name)
    t = resolve_transport(transport)
    pack = pack_fn or _identity
    consume = consume_fn or _identity
    perm = list(perm)
    if n_parts <= 1:
        return consume(t.permute(pack(slab), mesh, axis_name, perm))
    part = Partitioner(n_parts, split_axis + 1)
    out_parts = [consume(t.permute(pack(chunk), mesh, axis_name, perm))
                 for chunk in part.split(slab)]
    return part.merge(out_parts, slab.shape[split_axis + 1])


# ---------------------------------------------------------------------------
# ring all-gather (+ fused early-consume matmul)
# ---------------------------------------------------------------------------


def ring_all_gather(
    x: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    *,
    gather_axis: int = 0,
    n_parts: int = 1,
    transport: str | Transport = "loopback",
) -> torch.Tensor:
    """All-gather by ring hops, equal to ``lax.all_gather(x, axis_name,
    axis=gather_axis, tiled=True)``: every rank ends with the axis's blocks
    in rank order.  With ``n_parts > 1`` each hop moves ``n_parts``
    sub-chunks independently."""
    t = resolve_transport(transport)
    k = axis_size(mesh, axis_name)
    if k == 1:
        return x
    a = gather_axis + 1
    m = x.shape[a]
    idx, rows = axis_positions(mesh, axis_name), _rows(mesh)
    out = torch.zeros((x.shape[0], k, *x.movedim(a, 1).shape[1:]), dtype=x.dtype,
                      device=x.device)
    perm = ring_perm(k)
    part = Partitioner(n_parts, a) if n_parts > 1 else None
    cur = x
    for s in range(k):
        out[rows, (idx - s) % k] = cur.movedim(a, 1)
        if s < k - 1:
            if part is None:
                cur = t.permute(cur, mesh, axis_name, perm)
            else:
                cur = part.merge([t.permute(c, mesh, axis_name, perm) for c in part.split(cur)], m)
    return out.flatten(1, 2).movedim(1, a).contiguous()


def ring_all_gather_matmul(
    x: torch.Tensor,
    w: torch.Tensor | Sequence[torch.Tensor],
    mesh: VirtualMesh,
    axis_name: str,
    *,
    accum_dtype: torch.dtype | None = None,
    transport: str | Transport = "loopback",
) -> torch.Tensor | list[torch.Tensor]:
    """``all_gather(x, axis=0) @ w`` with the matmul consuming each chunk on
    arrival (early work): ring collective-matmul.

    x: ``(R, m, d)`` local rows; w: ``(R, d, n)`` per rank (the
    column-parallel shard) or ``(d, n)`` shared, or a sequence of such
    weights, all consuming the chunk in flight (a gated MLP gathers x once
    for gate and up).  Returns ``(R, k*m, n)`` (or a list)."""
    t = resolve_transport(transport)
    ws = list(w) if isinstance(w, (list, tuple)) else [w]
    k = axis_size(mesh, axis_name)
    dtype = accum_dtype or x.dtype
    if k == 1:
        outs = [torch.matmul(x, wi).to(dtype) for wi in ws]
        return outs if isinstance(w, (list, tuple)) else outs[0]
    idx, rows = axis_positions(mesh, axis_name), _rows(mesh)
    r, m = x.shape[:2]
    outs = [torch.zeros((r, k, m, wi.shape[-1]), dtype=dtype, device=x.device) for wi in ws]
    perm = ring_perm(k)
    cur = x
    for s in range(k):
        owner = (idx - s) % k
        for out, wi in zip(outs, ws):
            out[rows, owner] = torch.matmul(cur, wi).to(dtype)
        if s < k - 1:
            cur = t.permute(cur, mesh, axis_name, perm)
    outs = [out.flatten(1, 2) for out in outs]
    return outs if isinstance(w, (list, tuple)) else outs[0]


def ring_matmul_reduce_scatter(
    x: torch.Tensor,
    w: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    *,
    accum_dtype: torch.dtype | None = None,
    transport: str | Transport = "loopback",
) -> torch.Tensor:
    """``psum_scatter(x @ w, scatter_dim=0)`` as a ring with per-step
    partial matmuls (the producer side: each partition of the output is
    computed just before its hop).

    x: ``(R, M, f)`` with ``M`` divisible by the axis size; w: ``(R, f,
    n)`` per rank (the row-parallel shard) or ``(f, n)`` shared.  Returns
    ``(R, M/k, n)``: rank ``i``'s row block ``i`` of the full sum."""
    t = resolve_transport(transport)
    k = axis_size(mesh, axis_name)
    dtype = accum_dtype or x.dtype
    if k == 1:
        return torch.matmul(x, w).to(dtype)
    big_m = x.shape[1]
    if big_m % k:
        raise ValueError(f"{big_m} rows do not split over {k} ranks of axis {axis_name!r}")
    xb = x.unflatten(1, (k, big_m // k))
    idx, rows = axis_positions(mesh, axis_name), _rows(mesh)
    perm = ring_perm(k)

    def partial_block(b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(xb[rows, b], w).to(dtype)

    # the sum for block (idx - 1) starts here and ends, whole, at its owner
    acc = partial_block((idx - 1) % k)
    for s in range(1, k):
        acc = t.permute(acc, mesh, axis_name, perm)
        acc = acc + partial_block((idx - 1 - s) % k)
    return acc


# ---------------------------------------------------------------------------
# partitioned all-to-all (MoE expert dispatch with early expert compute)
# ---------------------------------------------------------------------------


def _all_to_all(x: torch.Tensor, mesh: VirtualMesh, axis_name: str, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)`` over the stacked ranks: rank
    ``j`` splits its block into ``k`` along ``split_axis`` and sends piece
    ``i`` to rank ``i``, which concatenates what it receives along
    ``concat_axis`` in source-rank order."""
    k = axis_size(mesh, axis_name)
    xa = _axis_major(x, mesh, axis_name)  # (k_src, G, *local)
    if xa.shape[split_axis + 2] % k:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape[1:])} does not split over "
                         f"{k} ranks of axis {axis_name!r}")
    pieces = xa.chunk(k, dim=split_axis + 2)  # pieces[dst]: (k_src, G, ...)
    out = torch.stack([torch.cat(pieces[dst].unbind(0), dim=concat_axis + 1)
                       for dst in range(k)])
    if _transport.OP_LOG is not None:
        _transport.log_collective("all-to-all", x, k)
    return _from_axis_major(out, mesh, axis_name)


def _chunked(x: torch.Tensor, one_chunk: Callable[[torch.Tensor], torch.Tensor], n_parts: int,
             chunk_axis: int) -> torch.Tensor:
    """``one_chunk`` per ``chunk_axis`` partition, merged back; the consumer
    may rescale the chunk axis (uniformly), which the merge un-pads."""
    a = chunk_axis + 1
    orig = x.shape[a]
    part = Partitioner(n_parts, a)
    out_parts = [one_chunk(chunk) for chunk in part.split(x)]
    padded = part.n_parts * part.part_size(orig)
    out_total = sum(p.shape[a] for p in out_parts)
    return part.merge(out_parts, int(round(orig * out_total / padded)))


def partitioned_all_to_all(
    x: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    *,
    split_axis: int,
    concat_axis: int,
    n_parts: int = 1,
    chunk_axis: int | None = None,
    consume_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Tiled all-to-all split into ``n_parts`` chunks along ``chunk_axis``
    with per-chunk early work (``consume_fn``).

    For MoE: ``x`` is the ``(experts, capacity, d)`` dispatch buffer of
    every rank, split and concatenated over the expert axis, chunked over
    capacity, and ``consume_fn`` is the expert FFN: expert compute on chunk
    *k* overlaps the transfer of chunk *k+1*."""
    consume = consume_fn or _identity
    if chunk_axis is None:
        chunk_axis = (split_axis + 1) % (x.dim() - 1)
    if n_parts <= 1:
        return consume(_all_to_all(x, mesh, axis_name, split_axis, concat_axis))
    if chunk_axis == split_axis:
        raise ValueError("chunk_axis must differ from split_axis")
    return _chunked(x, lambda c: consume(_all_to_all(c, mesh, axis_name, split_axis,
                                                     concat_axis)), n_parts, chunk_axis)


def all_to_all_messages(
    shape: tuple[int, ...],
    axis_name: str,
    ring_size: int,
    *,
    split_axis: int = 0,
) -> tuple[Message, ...]:
    """Message table for a tiled all-to-all as ``ring_size`` ring shifts.

    Operates on the pre-rolled per-rank buffer of ``shape`` (see
    :func:`message_all_to_all`): message ``s`` ships block ``s`` of
    ``split_axis`` to the peer ``s`` steps around the ring (``s = 0`` is
    the hop-free self-copy).  The same table as JAX's."""
    size = shape[split_axis]
    if size % ring_size:
        raise ValueError(f"axis {split_axis} of {shape} does not split over {ring_size} ranks")
    m = size // ring_size
    msgs = []
    for s in range(ring_size):
        start = [0] * len(shape)
        start[split_axis] = s * m
        blk = list(shape)
        blk[split_axis] = m
        if s == 0:
            hops: tuple = ()
        else:
            perm = tuple((i, (i + s) % ring_size) for i in range(ring_size))
            hops = ((axis_name, perm),)
        msgs.append(Message(tuple(start), tuple(start), tuple(blk), hops))
    return tuple(msgs)


def message_all_to_all(
    x: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    *,
    split_axis: int,
    concat_axis: int,
    n_parts: int = 1,
    chunk_axis: int | None = None,
    consume_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    packer: str | Packer = "slice",
    transport: str | Transport = "loopback",
    coalesce: bool = True,
) -> torch.Tensor:
    """:func:`partitioned_all_to_all` routed through the transport layer.

    Rank ``j`` pre-rolls its split blocks by ``-j`` so that the block bound
    for the peer ``s`` steps away sits in window ``s``, ships window ``s``
    with ring shift ``s`` (:func:`all_to_all_messages`, delivered in place
    by :func:`~repro_torch.core.transport.exchange_messages`), and
    re-sorts the arrivals into source-rank order.  Bitwise-equal to
    :func:`partitioned_all_to_all` for the exact packers; the lossy ones
    (``bf16``, ``scaled-int8``) apply to the token buffers.  Same chunking
    contract as :func:`partitioned_all_to_all`."""
    if split_axis != concat_axis:
        raise ValueError("message_all_to_all requires split_axis == concat_axis "
                         "(the MoE dispatch form)")
    consume = consume_fn or _identity
    p = resolve_packer(packer)
    t = resolve_transport(transport)
    k = axis_size(mesh, axis_name)
    a = split_axis + 1
    idx, rows = axis_positions(mesh, axis_name), _rows(mesh)
    blocks = torch.arange(k, device=mesh.device)

    def one_chunk(xc: torch.Tensor) -> torch.Tensor:
        if k == 1:
            return consume(xc)
        b = xc.movedim(a, 1)
        b = b.reshape(b.shape[0], k, b.shape[1] // k, *b.shape[2:])  # (R, k, m, ...)
        # window s holds the block bound for the peer s steps ahead
        w = b[rows[:, None], (blocks[None, :] + idx[:, None]) % k]
        w = w.flatten(1, 2).movedim(1, a).contiguous()
        msgs = all_to_all_messages(tuple(w.shape[1:]), axis_name, k, split_axis=split_axis)
        exchange_messages(w, (msgs,), mesh=mesh, packer=p, transport=t, coalesce=coalesce)
        # window s now holds the block from the peer s steps behind: the
        # block from source j sits in window (idx - j) % k
        got = w.movedim(a, 1)
        got = got.reshape(got.shape[0], k, got.shape[1] // k, *got.shape[2:])
        out = got[rows[:, None], (idx[:, None] - blocks[None, :]) % k]
        return consume(out.flatten(1, 2).movedim(1, a).contiguous())

    if chunk_axis is None:
        chunk_axis = (split_axis + 1) % (x.dim() - 1)
    if n_parts <= 1:
        return one_chunk(x)
    if chunk_axis == split_axis:
        raise ValueError("chunk_axis must differ from split_axis")
    return _chunked(x, one_chunk, n_parts, chunk_axis)


# ---------------------------------------------------------------------------
# partitioned reduce-scatter / all-reduce (gradient bucketing)
# ---------------------------------------------------------------------------


def _rank_sum(xa: torch.Tensor) -> torch.Tensor:
    """The sum over the leading (rank) dim, added in rank order: every
    element the same left fold whatever the shape, so a reduction cut into
    partitions gives the bits of the whole one."""
    return functools.reduce(torch.add, xa.unbind(0))


def _psum_scatter(x: torch.Tensor, mesh: VirtualMesh, axis_name: str,
                  scatter_axis: int) -> torch.Tensor:
    k = axis_size(mesh, axis_name)
    total = _rank_sum(_axis_major(x, mesh, axis_name))  # (G, *local)
    if total.shape[scatter_axis + 1] % k:
        raise ValueError(f"axis {scatter_axis} of {tuple(x.shape[1:])} does not split over "
                         f"{k} ranks of axis {axis_name!r}")
    out = _from_axis_major(torch.stack(total.chunk(k, dim=scatter_axis + 1)), mesh, axis_name)
    if _transport.OP_LOG is not None:
        _transport.log_collective("reduce-scatter", out, k)
    return out


def _index_groups(groups: Sequence[Sequence[int]], k: int) -> list[list[int]]:
    """``axis_index_groups`` as JAX takes them: groups of equal size that
    cover every index of the axis once."""
    groups = [[int(i) for i in g] for g in groups]
    if sorted(i for g in groups for i in g) != list(range(k)) or len({len(g) for g in groups}) != 1:
        raise ValueError(f"axis_index_groups {groups} must split the {k} axis indices into "
                         f"groups of equal size")
    return groups


def _psum(x: torch.Tensor, mesh: VirtualMesh, axis_name: str,
          axis_index_groups: Sequence[Sequence[int]] | None = None) -> torch.Tensor:
    """``lax.psum`` over the stacked ranks; with ``axis_index_groups`` each
    rank gets the sum over its group of axis indices alone."""
    k = axis_size(mesh, axis_name)
    groups = None if axis_index_groups is None else _index_groups(axis_index_groups, k)
    if _transport.OP_LOG is not None:
        _transport.log_collective("all-reduce", x, k if groups is None else len(groups[0]))
    xa = _axis_major(x, mesh, axis_name)  # (k, G, *local)
    if groups is None:
        total = _rank_sum(xa)
        return _from_axis_major(total.expand(k, *total.shape), mesh, axis_name)
    out = torch.empty_like(xa)
    for g in groups:
        out[g] = _rank_sum(xa[g])
    return _from_axis_major(out, mesh, axis_name)


def partitioned_psum_scatter(
    x: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    *,
    scatter_axis: int = 0,
    n_parts: int = 1,
    chunk_axis: int | None = None,
) -> torch.Tensor:
    """``psum_scatter`` (tiled) chunked along a non-scattered axis (gradient
    buckets)."""
    if n_parts <= 1:
        return _psum_scatter(x, mesh, axis_name, scatter_axis)
    if chunk_axis is None:
        chunk_axis = (scatter_axis + 1) % (x.dim() - 1)
    if chunk_axis == scatter_axis:
        raise ValueError("chunk_axis must differ from scatter_axis")
    part = Partitioner(n_parts, chunk_axis + 1)
    outs = [_psum_scatter(c, mesh, axis_name, scatter_axis) for c in part.split(x)]
    return part.merge(outs, x.shape[chunk_axis + 1])


def partitioned_psum(
    x: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    *,
    n_parts: int = 1,
    chunk_axis: int = 0,
    axis_index_groups: Sequence[Sequence[int]] | None = None,
) -> torch.Tensor:
    """All-reduce chunked into ``n_parts`` bucket collectives; with
    ``axis_index_groups`` (``lax.psum``'s) within each group of axis
    indices alone (the MoE hidden-split slots' partial sums)."""
    if n_parts <= 1:
        return _psum(x, mesh, axis_name, axis_index_groups)
    part = Partitioner(n_parts, chunk_axis + 1)
    outs = [_psum(c, mesh, axis_name, axis_index_groups) for c in part.split(x)]
    return part.merge(outs, x.shape[chunk_axis + 1])


# ---------------------------------------------------------------------------
# gradient-tree bucketing (ZeRO-1 companion; beyond the paper)
# ---------------------------------------------------------------------------


def _leaves(tree: Any) -> list[torch.Tensor]:
    """Tensor leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(tree: Any, leaves) -> Any:
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def bucket_tree(tree: Any, n_buckets: int) -> list[list[tuple[int, torch.Tensor]]]:
    """Greedy size-balanced bucketing of tree leaves as (index, leaf)
    pairs.  Stacked leaves share their leading ``R``, so the buckets are the
    ones JAX forms from the per-rank leaves."""
    leaves = list(enumerate(_leaves(tree)))
    leaves.sort(key=lambda kv: -kv[1].numel())
    buckets: list[list[tuple[int, torch.Tensor]]] = [[] for _ in range(max(1, n_buckets))]
    fill = [0] * len(buckets)
    for i, leaf in leaves:
        b = fill.index(min(fill))
        buckets[b].append((i, leaf))
        fill[b] += leaf.numel()
    return [b for b in buckets if b]


def bucketed_psum_tree(tree: Any, mesh: VirtualMesh, axis_name: str, n_buckets: int) -> Any:
    """All-reduce a tree of stacked gradients as ``n_buckets`` fused flat
    collectives: fewer, larger messages than a psum a leaf, more, smaller
    ones than one fused blob (the partitioned trade-off applied to
    data-parallel gradient sync)."""
    leaves = _leaves(tree)
    out: list[torch.Tensor | None] = [None] * len(leaves)
    for bucket in bucket_tree(tree, n_buckets):
        r = bucket[0][1].shape[0]
        flat = torch.cat([leaf.reshape(r, -1) for _, leaf in bucket], dim=1)
        summed = _psum(flat, mesh, axis_name)
        off = 0
        for i, leaf in bucket:
            n = leaf[0].numel()
            out[i] = summed[:, off:off + n].reshape(leaf.shape)
            off += n
    return _unflatten(tree, iter(out))
