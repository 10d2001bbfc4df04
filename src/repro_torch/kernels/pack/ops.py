"""Dispatching pack/unpack wrappers: the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor, and an error for anything else.

These are what the port's ``cuda`` and ``bf16`` packers
(:mod:`repro_torch.core.transport`) stage every message through.  Unlike the
JAX ``ops.py``, nothing falls back: a CUDA tensor either launches its kernel
or raises, and the CPU path runs only because the tensor lies on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.pack import pack as _k
from repro_torch.kernels.pack import ref as _ref


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def pack_slab(
    slab: torch.Tensor,
    *,
    out_dtype=None,
    scale: float = 1.0,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pack a batched slab window (a strided view ``(R, *shape)`` of the
    stacked block) into a contiguous wire buffer of the same shape."""
    out_dtype = out_dtype or slab.dtype
    if out is None:
        out = torch.empty(slab.shape, dtype=out_dtype, device=slab.device)
    if _on_cpu(slab):
        out.copy_(_ref.pack_2d_ref(slab, out_dtype=out_dtype, scale=scale))
        return out
    return _k.copy_convert(slab, out, scale=scale)


def unpack_slab(buf: torch.Tensor, ghost: torch.Tensor, *, scale: float = 1.0) -> None:
    """Write a received wire buffer into ``ghost``, a strided view of the
    stacked block's ghost window, in place (convert back, ``1/scale``)."""
    buf = buf.reshape(ghost.shape)
    if _on_cpu(ghost):
        ghost.copy_(_ref.unpack_2d_ref(buf, out_dtype=ghost.dtype, scale=scale))
        return
    _k.copy_convert(buf, ghost, scale=(1.0 / scale if scale != 1.0 else 1.0))


def gather_pack(
    x: torch.Tensor,
    segments: Sequence,
    *,
    total: int,
    out_dtype=None,
    scale: float = 1.0,
    table: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fill one ``(R, total)`` coalesced wire buffer from ``x`` (R, *local)
    in a single launch.  ``table`` is the segment table already on the
    device (a persistent plan's); without it the table is built and
    uploaded in this call (the standard baseline's per-step cost)."""
    out_dtype = out_dtype or x.dtype
    if out is None:
        out = torch.empty((x.shape[0], total), dtype=out_dtype, device=x.device)
    if _on_cpu(x):
        out.copy_(_ref.gather_pack_ref(x, segments, total=total,
                                       out_dtype=out_dtype, scale=scale))
        return out
    if table is None:
        table = _k.segment_table(segments, x.shape[1:], x.device)
    return _k.gather_pack(x, table, out, scale=scale)
