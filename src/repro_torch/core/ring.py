"""Sequence-parallel ring primitives built on partitioned communication
(PyTorch port of ``src/repro/core/ring.py``).

Two LM-side incarnations of the paper's halo-exchange pipeline:

* :func:`ring_attention`: blockwise attention where the KV shard
  circulates around the mesh-axis ring.  The partitioned variant splits
  each KV block into ``n_parts`` partitions (``Pready``/``Parrived`` with
  attention as the consumer).
* :func:`state_passing`: the recurrent-state "ghost cell" exchange of
  SSM/RWKV sequence parallelism.  Each rank reduces its sequence shard to
  an affine operator ``s -> D*s + C``; the incoming state of each shard is
  the exclusive prefix composition of its predecessors.  ``method='ring'``
  is the 1-D stencil neighbor pass (k-1 hops), ``method='tree'`` the
  log-step doubling scan.

Where the JAX functions run inside ``shard_map`` on one shard, these take
every rank of a one-process :class:`~repro_torch.core.mesh.VirtualMesh`
stacked on the leading dim, ``(R, ...)``, plus the mesh and the axis name
(see :mod:`repro_torch.core.partitioned`).  Each rank's query offset and
KV owner differ, so the causal mask is built per rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.partitioned import axis_positions, axis_size
from repro_torch.core.plan import PLANS, CommPlan
from repro_torch.core.transport import (
    Message,
    Packer,
    Partitioner,
    PreparedExchange,
    Transport,
    resolve_packer,
    resolve_transport,
    ring_perm,
)

_NEG_INF = -1e30


def ring_kv_messages(
    kv_shape: tuple[int, ...],
    axis_name: str,
    ring_size: int,
    *,
    n_parts: int = 1,
    shift: int = 1,
) -> tuple[Message, ...]:
    """Message table for ONE hop of the ring-attention KV rotation (JAX's
    table, field for field).

    ``kv_shape`` is a rank's stacked wire view ``(2, B, Skv, Hkv, D)``: K
    at index 0, V at index 1.  Both messages share the one periodic-ring
    hop chain, so coalesced delivery packs K and V into ONE wire buffer and
    moves it as ONE collective.  ``n_parts > 1`` partitions along the
    sequence axis (the paper's equal-partition rule, clipped remainder
    tail), delivered as pipelined rounds."""
    if kv_shape[0] != 2:
        raise ValueError(f"the KV wire view leads with K and V, got {kv_shape}")
    perm = tuple((i, (i + shift) % ring_size) for i in range(ring_size))
    hops = ((axis_name, perm),)
    part_axis = 2 if n_parts > 1 else None
    shape = (1,) + tuple(kv_shape[1:])
    out = []
    for tensor in range(2):
        start = (tensor,) + (0,) * (len(kv_shape) - 1)
        out.append(Message(start, start, shape, hops, n_parts=n_parts, part_axis=part_axis))
    return tuple(out)


def ring_kv_plan(
    mesh: VirtualMesh,
    axis_name: str,
    kv_shape: tuple[int, ...],
    dtype: torch.dtype,
    *,
    n_parts: int,
    packer: Packer,
    transport: Transport,
    coalesce: bool,
    shift: int = 1,
) -> CommPlan:
    """The persistent plan of one KV hop of :func:`ring_attention`: a
    :class:`PreparedExchange` of :func:`ring_kv_messages` (routes, segment
    tables and wire buffers), built once per (mesh, axis, KV shape, dtype,
    ``n_parts``, packer, transport, coalesce) and kept in the process's plan
    registry (:data:`~repro_torch.core.plan.PLANS`); every later call of
    that structure starts it without building anything.  Eager: ``start(kv)``
    delivers the hop into ``kv`` in place; :attr:`CommPlan.exchange` is
    the prepared exchange."""

    def factory():
        msgs = ring_kv_messages(kv_shape, axis_name, axis_size(mesh, axis_name), n_parts=n_parts,
                                shift=shift)
        prepared = PreparedExchange((msgs,), mesh=mesh, local_shape=kv_shape, dtype=dtype,
                                    packer=packer, transport=transport, coalesce=coalesce)

        def step(kv: torch.Tensor) -> torch.Tensor:
            return prepared.run(kv)

        step.prepared = prepared
        return step

    key = ("ring_kv", mesh, axis_name, kv_shape, dtype, n_parts, packer, transport, coalesce)
    if shift != 1:  # the key of the forward hop is the one it always had
        key = (*key, shift)
    return PLANS.get_or_init(factory, key=key, device=mesh.device, name="ring_kv")


class RingHopFn(torch.autograd.Function):
    """One KV hop of :func:`ring_attention` under grad: the forward
    delivers into a fresh buffer through the hop's plan (the same messages,
    packer kernels and transport), the backward delivers the cotangent
    along the inverse route (``shift=-1``) through the same kernels.  A hop
    replaces every element of the buffer by the same element of its ring
    predecessor, so the inverse route is its exact transpose; a ``bf16``
    wire casts the cotangent as the forward cast the values (the
    derivative of the cast).  The ``scaled-int8`` wire's rounding has no
    useful derivative and raises."""

    @staticmethod
    def forward(ctx, kv: torch.Tensor, hop: CommPlan, back: CommPlan) -> torch.Tensor:
        out = kv.clone(memory_format=torch.contiguous_format)
        hop.start(out)
        ctx.back = back
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.clone(memory_format=torch.contiguous_format)
        ctx.back.start(out)
        return out, None, None


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(R, B, S, Hkv, D) -> (R, B, S, Hkv*n_rep, D) for GQA."""
    if n_rep == 1:
        return k
    r, b, s, h, d = k.shape
    return k[:, :, :, :, None, :].expand(r, b, s, h, n_rep, d).reshape(r, b, s, h * n_rep, d)


def _attend_block(
    q: torch.Tensor,  # (R, B, Sq, H, D)
    k: torch.Tensor,  # (R, B, Sk, Hkv, D)
    v: torch.Tensor,  # (R, B, Sk, Hkv, D)
    m: torch.Tensor,  # (R, B, H, Sq) running max
    l: torch.Tensor,  # (R, B, H, Sq) running denominator
    acc: torch.Tensor,  # (R, B, Sq, H, D) running numerator
    q_off: torch.Tensor,  # (R,) each rank's first query position
    kv_off: torch.Tensor,  # (R,) the first position of each rank's KV block
    *,
    causal: bool,
    scale: float,
):
    """One online-softmax accumulation step over every rank's KV block, in
    JAX's order of operations and dtypes."""
    n_rep = q.shape[3] // k.shape[3]
    kf = _repeat_kv(k, n_rep)
    vf = _repeat_kv(v, n_rep)
    s = torch.einsum("rbqhd,rbkhd->rbhqk", q, kf).float() * scale
    if causal:
        iq = q_off[:, None] + torch.arange(q.shape[2], device=q.device)
        ik = kv_off[:, None] + torch.arange(k.shape[2], device=q.device)
        mask = iq[:, :, None] >= ik[:, None, :]  # (R, Sq, Sk)
        s = torch.where(mask[:, None, None], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # renormalize the previous accumulation
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr.transpose(2, 3)[..., None] + torch.einsum(
        "rbhqk,rbkhd->rbqhd", p.to(vf.dtype), vf).to(acc.dtype)
    return m_new, l, acc


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    *,
    causal: bool = True,
    n_parts: int = 1,
    scale: float | None = None,
    block_fn: Callable | None = None,
    transport: str | Transport = "loopback",
    packer: str | Packer = "slice",
    coalesce: bool = True,
    comm: str = "messages",
) -> torch.Tensor:
    """Sequence-parallel attention with the KV shards circulating a ring.

    q: ``(R, B, Sq, H, D)``; k, v: ``(R, B, Skv, Hkv, D)``: every rank's
    sequence shard, stacked.  Returns ``(R, B, Sq, H, D)``.  ``n_parts >
    1`` splits each circulating KV block into equal partitions, the
    remainder tail attending at its true width.  ``block_fn`` may replace
    the per-block accumulation (:func:`_attend_block`'s signature).

    ``comm="messages"`` routes every hop through the transport layer on a
    stacked ``(R, 2, B, Skv, Hkv, D)`` KV buffer: one :class:`Message` a
    tensor on one ring hop chain (:func:`ring_kv_messages`), delivered in
    place by the persistent plan of :func:`ring_kv_plan`, built at the
    first call of a structure and started every hop.  ``coalesce=True`` ships K and V as ONE
    wire buffer and ONE collective a hop (``n_parts`` rounds); ``packer``
    selects the wire format (the lossy ``bf16``/``scaled-int8`` re-quantize
    at every hop).  ``comm="permute"`` is the bare
    :meth:`~repro_torch.core.transport.Transport.permute` reference path,
    bitwise-equal for the exact packers."""
    if comm not in ("messages", "permute"):
        raise ValueError(f"unknown ring comm mode {comm!r}")
    t = resolve_transport(transport)
    p = resolve_packer(packer)
    ksize = axis_size(mesh, axis_name)
    idx = axis_positions(mesh, axis_name)
    r, b, sq, h, d = q.shape
    skv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    attend = block_fn or _attend_block

    m = torch.full((r, b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((r, b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((r, b, sq, h, d), dtype=torch.float32, device=q.device)
    q_off = idx * sq

    part = Partitioner(n_parts, 2) if n_parts > 1 else None
    # the clipped partition windows of a block (the remainder tail attends
    # at its true width; all-padding tails vanish)
    windows = part.slices(skv) if part is not None else [(0, skv)]

    def consume(m, l, acc, cur_k, cur_v, kv_off):
        # both paths hand the block over contiguous, so their products are
        # the same GEMMs on the same layouts (bitwise-equal paths)
        for off, width in windows:
            if width <= 0:
                continue
            m, l, acc = attend(q, cur_k[:, :, off:off + width].contiguous(),
                               cur_v[:, :, off:off + width].contiguous(), m, l, acc, q_off,
                               kv_off + off, causal=causal, scale=scale)
        return m, l, acc

    if comm == "messages" and ksize > 1:
        # each hop is a Message-table delivery on the stacked KV buffer,
        # in place: the block is consumed, then the next one arrives over it.
        # Under grad a hop delivers into a fresh buffer (RingHopFn), whose
        # backward sends the cotangent back along the ring
        kv = torch.stack([k, v], dim=1)
        plan = dict(n_parts=n_parts, packer=p, transport=t, coalesce=coalesce)
        hop = ring_kv_plan(mesh, axis_name, tuple(kv.shape[1:]), kv.dtype, **plan)
        grad = torch.is_grad_enabled() and kv.requires_grad
        if grad:
            if p.name == "scaled-int8":
                raise NotImplementedError("a gradient through the scaled-int8 ring wire: its "
                                          "rounding has no useful derivative")
            back = ring_kv_plan(mesh, axis_name, tuple(kv.shape[1:]), kv.dtype, shift=-1,
                                **plan)
        for s in range(ksize):
            m, l, acc = consume(m, l, acc, kv[:, 0], kv[:, 1], ((idx - s) % ksize) * skv)
            if s < ksize - 1:
                if grad:
                    kv = RingHopFn.apply(kv, hop, back)
                else:
                    hop.start(kv)
    else:
        # reference path: bare per-tensor permutes.  Partition splits are
        # taken once; the chunks are permuted every hop and consumed as
        # they are (no per-hop re-split or merge)
        perm = ring_perm(ksize) if ksize > 1 else []
        k_parts, v_parts = (part.split(k), part.split(v)) if part is not None else ([k], [v])
        csize = part.part_size(skv) if part is not None else skv
        for s in range(ksize):
            kv_off = ((idx - s) % ksize) * skv
            for ci, (kc, vc) in enumerate(zip(k_parts, v_parts)):
                width = min(csize, skv - ci * csize)
                if width <= 0:
                    continue
                m, l, acc = attend(q, kc[:, :, :width].contiguous(), vc[:, :, :width].contiguous(),
                                   m, l, acc, q_off, kv_off + ci * csize, causal=causal,
                                   scale=scale)
            if s < ksize - 1:
                k_parts = [t.permute(c, mesh, axis_name, perm) for c in k_parts]
                v_parts = [t.permute(c, mesh, axis_name, perm) for c in v_parts]

    l = torch.clamp(l, min=1e-30)
    out = acc / l.transpose(2, 3)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# recurrent-state passing (SSM / RWKV sequence parallelism)
# ---------------------------------------------------------------------------


def state_passing(
    C: torch.Tensor,
    D: torch.Tensor,
    mesh: VirtualMesh,
    axis_name: str,
    *,
    method: str = "ring",
    transport: str | Transport = "loopback",
) -> torch.Tensor:
    """Exclusive prefix of the affine state operators ``s -> D*s + C`` along
    a mesh axis; returns each shard's incoming state ``s_in``.

    ``C`` ``(R, ...)``: each shard's state produced from a zero incoming
    state.  ``D``: each shard's cumulative decay, elementwise, broadcastable
    to ``C``.  Composition (later after earlier): ``(D2, C2) o (D1, C1) =
    (D2*D1, D2*C1 + C2)``.  ``method='ring'``: k-1 neighbor hops;
    ``method='tree'``: ceil(log2(k)) doubling hops and one shift."""
    t = resolve_transport(transport)
    k = axis_size(mesh, axis_name)
    if k == 1:
        return torch.zeros_like(C)
    D = torch.broadcast_to(D, C.shape).to(C.dtype)

    if method == "ring":
        shift = [(i, i + 1) for i in range(k - 1)]  # causal: no wraparound
        s = torch.zeros_like(C)
        for _ in range(k - 1):
            s = t.permute(D * s + C, mesh, axis_name, shift)  # rank 0 gets zeros
        return s
    if method == "tree":
        return _tree_state_passing(C, D, mesh, axis_name, t)
    raise ValueError(method)


def _tree_state_passing(C: torch.Tensor, D: torch.Tensor, mesh: VirtualMesh, axis_name: str,
                        t: Transport) -> torch.Tensor:
    """Inclusive doubling scan over the affine operators, then a shift by
    one."""
    k = axis_size(mesh, axis_name)
    idx = axis_positions(mesh, axis_name).view(-1, *([1] * (C.dim() - 1)))
    Dc, Cc = D, C
    hop = 1
    while hop < k:
        shift = [(i, i + hop) for i in range(k - hop)]
        D_prev = t.permute(Dc, mesh, axis_name, shift)
        C_prev = t.permute(Cc, mesh, axis_name, shift)
        has_prev = idx >= hop
        new_D = Dc * D_prev
        new_C = Dc * C_prev + Cc
        Dc = torch.where(has_prev, new_D, Dc)
        Cc = torch.where(has_prev, new_C, Cc)
        hop *= 2
    return t.permute(Cc, mesh, axis_name, [(i, i + 1) for i in range(k - 1)])
