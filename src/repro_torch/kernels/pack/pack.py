"""Wrappers of the hand-written CUDA pack kernels (``csrc/pack.cu``).

* :func:`copy_convert` replaces the Pallas ``_copy_convert_kernel`` behind
  ``pack_2d``/``unpack_2d`` (``src/repro/kernels/pack/pack.py``).  It copies
  one batched window that collapses to at most 1 + 3 dims with dtype
  convert and scale, and takes both sides' strides, so a pack reads the
  ghost slab in place and an unpack writes straight into the ghost window.
* :func:`gather_pack` replaces ``_gather_pack_kernel`` behind
  ``gather_pack_1d``.  One launch fills the ``(R, total)`` coalesced wire
  buffer of all R stacked ranks from a device-resident work table: each
  segment collapsed (:func:`collapse_window`) and cut into chunks of rows
  (:func:`work_rows`), built once per layout.

Both are bound by bytes (one read and one write per element); the source
notes in ``csrc/pack.cu`` say what the design does about it.  They accept
CUDA tensors only and raise on anything else: the CPU path is the plain
version in :mod:`repro_torch.kernels.pack.ref`, chosen by
:mod:`repro_torch.kernels.pack.ops`.  Each launches on the current stream,
allocates nothing, and adds one to ``_build.LAUNCHES[<name>]`` per launch.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Sequence

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: why the pack kernels refuse a gradient (:func:`_build.refuse_grad`)
NO_GRAD = ("a gradient through a ring-attention KV hop runs through RingHopFn "
           "(core.ring), which sends the cotangent back along the ring through these kernels")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "copy_convert": [_P, _I, _P, _I] + [_L] * 12 + [_I, _F, _P],
    "gather_pack": [_P, _I, _P, _I, _P, _I, _L, _I, _L, _I, _F, _P],
}

#: wire elements one gather chunk (one block of 256 threads) covers at most:
#: the heat3d pz face, one run of 263168, becomes 65 chunks a rank
CHUNK = 4096
#: threads of one gather block; a chunk's rows get a power of two of them each
_GATHER_THREADS = 256
#: columns of a work-table row (see :func:`work_rows`)
WORK_COLS = 7


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


def collapse_window(
    shape: Sequence[int], src_strides: Sequence[int], dst_strides: Sequence[int]
) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]:
    """The fewest dims that address the same elements of a same-shaped
    (src, dst) window pair, in the same order: unit dims dropped, and each
    dim merged into the one outside it where both sides are contiguous
    across the pair (``outer stride == inner stride * inner extent`` on src
    and on dst).  Returns ``(shape, src_strides, dst_strides)``, at least
    one dim; the last is the run the kernel's threads walk."""
    dims: list[tuple[int, int, int]] = []
    for n, s, d in zip(shape, src_strides, dst_strides):
        if n == 1:
            continue
        if dims and dims[-1][1] == s * n and dims[-1][2] == d * n:
            dims[-1] = (dims[-1][0] * n, s, d)
        else:
            dims.append((n, s, d))
    if not dims:
        dims = [(1, 1, 1)]
    n, s, d = zip(*dims)
    return tuple(n), tuple(s), tuple(d)


def vector_width(shape: Sequence[int], src_strides: Sequence[int], dst_strides: Sequence[int],
                 src_ptr: int, dst_ptr: int, src_size: int, dst_size: int) -> int:
    """Elements a thread moves at once in a collapsed window: 16 bytes of
    the wider type (8 bf16 to bf16, else 4: an f32 side moves a float4, a
    bf16 side 8 bytes, so each warp access is one contiguous span) where the
    run is contiguous on both sides, at least that long, and every row
    starts aligned to the vector on both sides (both base addresses and
    every row stride of a dim longer than 1); else 1."""
    width = 16 // max(src_size, dst_size)
    if src_strides[-1] != 1 or dst_strides[-1] != 1 or shape[-1] < width:
        return 1
    if src_ptr % (width * src_size) or dst_ptr % (width * dst_size):
        return 1
    if any(s % width or d % width
           for n, s, d in zip(shape[:-1], src_strides[:-1], dst_strides[:-1]) if n > 1):
        return 1
    return width


@functools.lru_cache(maxsize=1024)
def _launch_layout(shape: tuple[int, ...], src_strides: tuple[int, ...],
                   dst_strides: tuple[int, ...], src_size: int, dst_size: int):
    """The kernel's 4-dim ``(shape, src strides, dst strides)`` of a window
    (collapsed, padded outside with unit dims of stride 0) and the vector
    width its strides allow, once per layout: a plan's windows repeat every
    step, so the per-call work left is the base pointers' alignment."""
    n, ss, ds = collapse_window(shape, src_strides, dst_strides)
    if len(n) > 4:
        raise ValueError(f"copy_convert: window {tuple(shape)} collapses to {len(n)} dims "
                         f"(at most 4)")
    vec = vector_width(n, ss, ds, 0, 0, src_size, dst_size)
    pad = 4 - len(n)
    n, ss, ds = (1,) * pad + n, (0,) * pad + ss, (0,) * pad + ds
    if n[1] * n[2] >= 2**32:
        raise ValueError(f"copy_convert: {n[1] * n[2]} rows in dims 1-2 (< 2**32)")
    return n, ss, ds, vec


def copy_convert(src: torch.Tensor, dst: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """``dst[...] = (src.float() * f32(scale)).to(dst.dtype)``, elementwise,
    for same-shaped strided views (f32/bf16) that collapse
    (:func:`collapse_window`) to at most 4 dims, such as a window of a
    5-D ring-attention KV buffer; the rows and run are moved 16 bytes a
    thread where :func:`vector_width` allows.  Returns ``dst``."""
    _check_cuda("copy_convert", src, dst)
    _build.refuse_grad("copy_convert", src, dst, why=NO_GRAD)
    if src.shape != dst.shape:
        raise ValueError(f"copy_convert: shapes {tuple(src.shape)} -> "
                         f"{tuple(dst.shape)} (same shape)")
    if src.dtype not in _DTYPE_CODE or dst.dtype not in _DTYPE_CODE:
        raise TypeError(f"copy_convert: {src.dtype} -> {dst.dtype} (f32/bf16 only)")
    if any(s < 0 for s in (*src.stride(), *dst.stride())):
        raise ValueError("copy_convert: negative strides")
    src_size, dst_size = src.element_size(), dst.element_size()
    n, ss, ds, vec = _launch_layout(src.shape, src.stride(), dst.stride(), src_size, dst_size)
    if vec > 1 and (src.data_ptr() % (vec * src_size) or dst.data_ptr() % (vec * dst_size)):
        vec = 1
    code = _lib().copy_convert(
        src.data_ptr(), _DTYPE_CODE[src.dtype], dst.data_ptr(), _DTYPE_CODE[dst.dtype],
        *n, *ss, *ds, vec, float(scale), _build.stream_ptr(src.device),
    )
    _build.LAUNCHES["copy_convert"] += 1
    _build.check(code, "copy_convert")
    return dst


def segment_rows(segments: Sequence, local_shape: Sequence[int]) -> list[list[int]]:
    """``(offset, start, shape)`` rows (or ``WireSegment`` values) as the
    rows :func:`work_rows` reads, local dims padded to 3 with leading unit
    dims (blocks of more dims, such as the ring-attention KV buffer's 5, keep
    theirs).  Raises unless the windows lie inside ``local_shape`` and the
    offsets tile the buffer in order (the kernel trusts the table)."""
    ndim = len(local_shape)
    if ndim < 1:
        raise ValueError(f"gather_pack: local blocks of at least 1 dim, got {ndim}")
    pad = max(0, 3 - ndim)
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


def _aligned(*values: int) -> int:
    """The largest of 8, 4, 2 and 1 that divides every value."""
    a = 8
    while a > 1 and any(v % a for v in values):
        a //= 2
    return a


@functools.lru_cache(maxsize=256)
def work_rows(rows: tuple[tuple[int, ...], ...], local_shape: tuple[int, ...],
              chunk_elems: int = CHUNK) -> tuple[tuple[int, ...], ...]:
    """The gather kernel's work table of a layout, once per layout: each
    7-column row of :func:`segment_rows` (``rows``, as tuples) collapsed
    against the block's strides and the contiguous wire
    (:func:`collapse_window`) into rows of a run, then cut into chunks of
    at most ``chunk_elems`` elements that never span two segments.  A chunk
    is ``(wire offset, source offset, rows, run, source row stride, log2
    threads a row, alignment)``: row k reads ``run`` elements from source
    offset + k * stride and writes them to wire offset + k * run, and the
    alignment is the largest of 8, 4, 2, 1 elements dividing both offsets
    (and, for more than one row, the stride and the run), so a chunk moves
    vectors of that many elements where the launch's bases allow.  A run
    longer than a chunk is cut into pieces of ``chunk_elems`` (a multiple of
    8, so the pieces keep the run's alignment).  Chunks are in wire order
    and tile ``[0, total)``."""
    if chunk_elems <= 0 or chunk_elems % 8:
        raise ValueError(f"gather_pack: chunks of {chunk_elems} elements (a multiple of 8)")
    local = (1,) * (3 - len(local_shape)) + tuple(local_shape)
    nd = len(local)
    strides = tuple(math.prod(local[i + 1:]) for i in range(nd))
    work: list[tuple[int, ...]] = []

    def chunk(wire: int, src: int, nrows: int, run: int, srow: int) -> None:
        tpr = 1
        while tpr < _GATHER_THREADS and 4 * tpr < run:
            tpr *= 2
        align = _aligned(wire, src, *((srow, run) if nrows > 1 else ()))
        work.append((wire, src, nrows, run, srow, tpr.bit_length() - 1, align))

    for off, *rest in rows:
        start, shape = rest[:nd], tuple(rest[nd:])
        src = sum(b * s for b, s in zip(start, strides))
        wire_strides = tuple(math.prod(shape[i + 1:]) for i in range(nd))
        n, ss, _ = collapse_window(shape, strides, wire_strides)
        if ss[-1] != 1:  # the innermost dim left is strided: runs of one element
            n, ss = (*n, 1), (*ss, 1)
        *outer, run = n
        # every row start of the segment, as (source offset, rows, row stride):
        # the last outer dim is a chunk's rows, the ones outside it enumerated
        if not outer:
            groups = [(src, 1, 0)]
        else:
            groups = [(src + sum(i * s for i, s in zip(idx, ss)), outer[-1], ss[len(outer) - 1])
                      for idx in itertools.product(*(range(k) for k in outer[:-1]))]
        wire = off
        for base, nrows, srow in groups:
            if run >= chunk_elems:
                for k in range(nrows):
                    for p in range(0, run, chunk_elems):
                        piece = min(chunk_elems, run - p)
                        chunk(wire, base + k * srow + p, 1, piece, 0)
                        wire += piece
            else:
                per = chunk_elems // run
                for k in range(0, nrows, per):
                    g = min(per, nrows - k)
                    chunk(wire, base + k * srow, g, run, srow)
                    wire += g * run
    return tuple(work)


def segment_table(segments: Sequence, local_shape: Sequence[int], device) -> torch.Tensor:
    """The device-resident work table :func:`gather_pack` reads (what a
    persistent plan uploads once; the host side is cached per layout)."""
    rows = tuple(map(tuple, segment_rows(segments, local_shape)))
    return torch.tensor(work_rows(rows, tuple(local_shape)), dtype=torch.int64,
                        device=device)


def gather_pack(
    x: torch.Tensor,
    table: torch.Tensor,
    out: torch.Tensor,
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    """Fill ``out`` (R, total) from the contiguous ``x`` (R, *local) through
    the (nchunk, 7) int64 work ``table`` of :func:`segment_table`, built for
    ``x``'s local shape.  Returns ``out``."""
    _check_cuda("gather_pack", x, table, out)
    _build.refuse_grad("gather_pack", x, out, why=NO_GRAD)
    if not (x.is_contiguous() and out.is_contiguous() and table.is_contiguous()):
        raise ValueError("gather_pack: x, table and out must be contiguous")
    if table.dtype != torch.int64 or table.dim() != 2 or table.shape[1] != WORK_COLS:
        raise ValueError(f"gather_pack: table must be (nchunk, {WORK_COLS}) int64, got "
                         f"{tuple(table.shape)} {table.dtype}")
    nchunk = table.shape[0]
    if not 1 <= nchunk < 2**31:
        raise ValueError(f"gather_pack: {nchunk} chunks (1..2**31 - 1)")
    if x.dim() < 2:
        raise ValueError("gather_pack: x must be (R, *local) with at least 1 local dim")
    if x.dtype not in _DTYPE_CODE or out.dtype not in _DTYPE_CODE:
        raise TypeError(f"gather_pack: {x.dtype} -> {out.dtype} (f32/bf16 only)")
    ranks, rank_stride = x.shape[0], math.prod(x.shape[1:])
    if out.dim() != 2 or out.shape[0] != ranks or not 1 <= ranks <= 65535:
        raise ValueError(f"gather_pack: out {tuple(out.shape)} for {ranks} ranks")
    total = out.shape[1]
    xs, os_ = x.element_size(), out.element_size()
    wide = 16 // max(xs, os_)
    vec_ok = (x.data_ptr() % (wide * xs) == 0 and out.data_ptr() % (wide * os_) == 0
              and rank_stride % wide == 0 and total % wide == 0)
    code = _lib().gather_pack(
        x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(), _DTYPE_CODE[out.dtype],
        table.data_ptr(), nchunk, total, ranks, rank_stride, int(vec_ok), float(scale),
        _build.stream_ptr(x.device),
    )
    _build.LAUNCHES["gather_pack"] += 1
    _build.check(code, "gather_pack")
    return out
