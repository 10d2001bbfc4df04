"""Parallel execution context threaded through the port's model code
(PyTorch port of ``src/repro/parallel/context.py``, same fields).

``mesh`` is ``None`` (every model runs on one device, unsharded) or a
one-process :class:`~repro_torch.core.mesh.VirtualMesh` such as ``(1, R)``
over ``("data", "model")``: the ranks stack on the leading dim of one
tensor (:func:`shard_ranks`), where JAX shards over devices inside
``shard_map``.  On such a mesh these modes run:

* ``seq_parallel``: prefill attention is ring attention over
  ``model_axis`` (:func:`repro_torch.core.ring.ring_attention`, the KV
  rotation through the transport layer with ``comm_packer``,
  ``comm_coalesce`` and ``n_parts``); the RWKV time mix passes its
  recurrent state across the sequence shards
  (:func:`repro_torch.core.ring.state_passing` by ``state_method``).
* ``tp_mode="ring"``: the MLP is the sequence-sharded Megatron-SP form on
  the partitioned ring collective-matmuls
  (:func:`repro_torch.models.layers.apply_mlp_ring`).

* ``moe_mode="ep"``: the MoE FFN is expert-parallel over ``model_axis``
  (:mod:`repro_torch.models.moe`): tokens sequence-sharded over the axis,
  the dispatch and return through
  :func:`~repro_torch.core.partitioned.partitioned_all_to_all`
  (``moe_comm="native"``) or
  :func:`~repro_torch.core.partitioned.message_all_to_all`
  (``moe_comm="messages"``, with ``comm_packer``/``comm_coalesce``), in
  ``n_parts`` chunks with the expert FFN as each chunk's consumer.  The axis
  must hold one rank a slot (:func:`check_ep_mesh`).

A mesh over several processes is refused (ROADMAP Queue 1 item 17).
``use_flash`` is kept for field parity but selects nothing: the port's
local attention takes the CUDA flash kernel for a CUDA tensor and the
plain version for a CPU tensor, whatever the context says.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

from repro_torch.core.partitioned import axis_positions, axis_size


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: Any = None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str | None = "model"
    # paper technique knobs
    seq_parallel: bool = False  # ring attention / state passing for prefill
    moe_mode: str = "dense"  # dense | ep
    n_parts: int = 1  # partitions per message (1 = fused)
    state_method: str = "ring"  # ring | tree (SSM/RWKV state passing)
    tp_mode: str = "gspmd"  # gspmd | ring
    # transport-layer wire knobs of the message-routed LM comm paths
    comm_packer: str = "slice"
    comm_coalesce: bool = True
    moe_comm: str = "native"  # native | messages
    # numerics: kept for parity with the JAX context; selects nothing here
    use_flash: bool = False

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]


LOCAL = ParallelContext(mesh=None, model_axis=None)


# ---------------------------------------------------------------------------
# the (batch, sequence) layout over the stacked ranks
# ---------------------------------------------------------------------------


def _rank_positions(ctx: ParallelContext) -> tuple[int, int, torch.Tensor, torch.Tensor]:
    return _positions(ctx.mesh, tuple(ctx.data_axes), ctx.model_axis)


@functools.lru_cache(maxsize=None)
def _positions(mesh, data_axes: tuple[str, ...], model_axis: str):
    """(data shards, model shards, each rank's data shard, each rank's
    model shard): JAX's ``P(data_axes, model_axis)`` over the mesh's
    row-major ranks; ranks that differ only along other axes hold the same
    block (replicated).  A mesh over several processes is refused."""
    k = axis_size(mesh, model_axis)
    di = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    for a in data_axes:
        di = di * mesh.shape[a] + axis_positions(mesh, a)
    return (math.prod(mesh.shape[a] for a in data_axes), k, di,
            axis_positions(mesh, model_axis))


def shard_ranks(x: torch.Tensor, ctx: ParallelContext) -> torch.Tensor:
    """``(B, S, ...)`` -> ``(R, B/nd, S/k, ...)``: every rank's block of a
    tensor whose batch is sharded over ``data_axes`` and sequence over
    ``model_axis`` (JAX's ``P(data_axes, model_axis)``), stacked in rank
    order.  Dims that do not divide raise ``ValueError``, as JAX's
    ``shard_map`` does."""
    nd, k, di, mi = _rank_positions(ctx)
    b, s = x.shape[:2]
    if b % nd or s % k:
        raise ValueError(
            f"shape {tuple(x.shape)} is not evenly divisible by the mesh: batch over "
            f"{ctx.data_axes} ({nd} shards), sequence over {ctx.model_axis!r} ({k} shards)")
    return x.reshape(nd, b // nd, k, s // k, *x.shape[2:])[di, :, mi]


def unshard_ranks(y: torch.Tensor, ctx: ParallelContext) -> torch.Tensor:
    """The inverse of :func:`shard_ranks`: ``(R, b, s, ...)`` ->
    ``(b*nd, s*k, ...)``."""
    nd, k, di, mi = _rank_positions(ctx)
    out = torch.empty((nd, y.shape[1], k, y.shape[2], *y.shape[3:]), dtype=y.dtype,
                      device=y.device)
    out[di, :, mi] = y
    return out.reshape(nd * y.shape[1], k * y.shape[2], *y.shape[3:])


def model_shards(w: torch.Tensor, ctx: ParallelContext, dim: int) -> torch.Tensor:
    """Every rank's shard of ``w`` split over ``model_axis`` along ``dim``,
    stacked ``(R, ...)`` (a view when the ranks are the model axis alone)."""
    _, k, _, mi = _rank_positions(ctx)
    n = w.shape[dim]
    if n % k:
        raise ValueError(f"dim {dim} of {tuple(w.shape)} does not split over {k} ranks")
    shards = w.unflatten(dim, (k, n // k)).movedim(dim, 0)
    return shards if ctx.mesh.size == k else shards[mi]


def check_ep_mesh(ctx: ParallelContext, slots: int) -> None:
    """Refuse an expert-parallel context whose model axis does not hold
    exactly one rank per expert slot.  The JAX layer takes slot ``[0]`` of
    each rank's weight shard, so there it runs on any divisor of the slot
    count but is right only at one slot a rank; the port raises instead."""
    if ctx.model_size != slots:
        raise ValueError(
            f"moe_mode='ep' needs one expert slot a rank of the model axis "
            f"{ctx.model_axis!r}: the axis has {ctx.model_size} ranks, the model {slots} slots")
