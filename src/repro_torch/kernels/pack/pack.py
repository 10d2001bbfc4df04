"""Wrappers of the hand-written CUDA pack kernels (``csrc/pack.cu``).

* :func:`copy_convert` replaces the Pallas ``_copy_convert_kernel`` behind
  ``pack_2d``/``unpack_2d`` (``src/repro/kernels/pack/pack.py``).  It copies
  one batched window of up to 1 + 3 dims with dtype convert and scale, and
  takes both sides' strides, so a pack reads the ghost slab in place and an
  unpack writes straight into the ghost window.
* :func:`gather_pack` replaces ``_gather_pack_kernel`` behind
  ``gather_pack_1d``.  One launch fills the ``(R, total)`` coalesced wire
  buffer of all R stacked ranks from a device-resident segment table.

Both are bound by bytes (one read and one write per element); the source
notes in ``csrc/pack.cu`` say what the design does about it.  They accept
CUDA tensors only and raise on anything else: the CPU path is the plain
version in :mod:`repro_torch.kernels.pack.ref`, chosen by
:mod:`repro_torch.kernels.pack.ops`.  Each launches on the current stream,
allocates nothing, and adds one to ``_build.LAUNCHES[<name>]`` per launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "copy_convert": [_P, _I, _P, _I] + [_L] * 12 + [_F, _P],
    "gather_pack": [_P, _I, _P, _I, _P, _I, _L, _I, _L, _L, _L, _F, _P],
}

#: shared-memory rows of the segment table one gather launch may carry
MAX_SEGMENTS = 512


def _lib():
    return _build.load("pack", _SIGNATURES)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if t.dtype not in _DTYPE_CODE and t.dtype != torch.int64:
            raise TypeError(f"{name}: unsupported dtype {t.dtype}")


def copy_convert(src: torch.Tensor, dst: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """``dst[...] = (src.float() * f32(scale)).to(dst.dtype)``, elementwise,
    for same-shaped strided views (<= 4 dims, f32/bf16).  Returns ``dst``."""
    _check_cuda("copy_convert", src, dst)
    if src.shape != dst.shape or src.dim() > 4:
        raise ValueError(f"copy_convert: shapes {tuple(src.shape)} -> "
                         f"{tuple(dst.shape)} (same shape, <= 4 dims)")
    if src.dtype not in _DTYPE_CODE or dst.dtype not in _DTYPE_CODE:
        raise TypeError(f"copy_convert: {src.dtype} -> {dst.dtype} (f32/bf16 only)")
    if any(s < 0 for s in (*src.stride(), *dst.stride())):
        raise ValueError("copy_convert: negative strides")
    pad = 4 - src.dim()
    n = (1,) * pad + tuple(src.shape)
    ss = (0,) * pad + tuple(src.stride())
    ds = (0,) * pad + tuple(dst.stride())
    code = _lib().copy_convert(
        src.data_ptr(), _DTYPE_CODE[src.dtype], dst.data_ptr(), _DTYPE_CODE[dst.dtype],
        *n, *ss, *ds, float(scale), _build.stream_ptr(src.device),
    )
    _build.LAUNCHES["copy_convert"] += 1
    _build.check(code, "copy_convert")
    return dst


def segment_rows(segments: Sequence, local_shape: Sequence[int]) -> list[list[int]]:
    """``(offset, start, shape)`` rows (or ``WireSegment`` values) as the
    kernel's 7-column table, local dims padded to 3 with leading unit dims.
    Raises unless the windows lie inside ``local_shape`` and the offsets
    tile the buffer in order (the kernel trusts the table)."""
    ndim = len(local_shape)
    if not 1 <= ndim <= 3:
        raise ValueError(f"gather_pack: local blocks of 1..3 dims, got {ndim}")
    pad = 3 - ndim
    rows, covered = [], 0
    for s in segments:
        off, start, shape = (s if isinstance(s, tuple)
                             else (s.offset, s.src_start, s.shape))
        if int(off) != covered or len(start) != ndim or len(shape) != ndim or any(
            b < 0 or n < 1 or b + n > d for b, n, d in zip(start, shape, local_shape)
        ):
            raise ValueError(f"gather_pack: bad segment {(off, start, shape)} "
                             f"for block {tuple(local_shape)} at offset {covered}")
        covered += math.prod(shape)
        rows.append([int(off), *([0] * pad), *map(int, start),
                     *([1] * pad), *map(int, shape)])
    return rows


def segment_table(segments: Sequence, local_shape: Sequence[int], device) -> torch.Tensor:
    """The device-resident segment table :func:`gather_pack` reads (what a
    persistent plan uploads once)."""
    return torch.tensor(segment_rows(segments, local_shape), dtype=torch.int64,
                        device=device)


def gather_pack(
    x: torch.Tensor,
    table: torch.Tensor,
    out: torch.Tensor,
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    """Fill ``out`` (R, total) from the contiguous ``x`` (R, *local) through
    the (nseg, 7) int64 ``table`` of :func:`segment_table`.  Returns ``out``."""
    _check_cuda("gather_pack", x, table, out)
    if not (x.is_contiguous() and out.is_contiguous() and table.is_contiguous()):
        raise ValueError("gather_pack: x, table and out must be contiguous")
    if table.dtype != torch.int64 or table.dim() != 2 or table.shape[1] != 7:
        raise ValueError(f"gather_pack: table must be (nseg, 7) int64, got "
                         f"{tuple(table.shape)} {table.dtype}")
    nseg = table.shape[0]
    if not 1 <= nseg <= MAX_SEGMENTS:
        raise ValueError(f"gather_pack: {nseg} segments (1..{MAX_SEGMENTS})")
    if not 2 <= x.dim() <= 4:
        raise ValueError("gather_pack: x must be (R, *local) with 1..3 local dims")
    local = (1,) * (4 - x.dim()) + tuple(x.shape[1:])
    ranks = x.shape[0]
    if out.dim() != 2 or out.shape[0] != ranks or not 1 <= ranks <= 65535:
        raise ValueError(f"gather_pack: out {tuple(out.shape)} for {ranks} ranks")
    code = _lib().gather_pack(
        x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(), _DTYPE_CODE[out.dtype],
        table.data_ptr(), nseg, out.shape[1], ranks, math.prod(local),
        local[1] * local[2], local[2], float(scale), _build.stream_ptr(x.device),
    )
    _build.LAUNCHES["gather_pack"] += 1
    _build.check(code, "gather_pack")
    return out
