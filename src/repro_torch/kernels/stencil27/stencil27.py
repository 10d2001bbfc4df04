"""Wrapper of the hand-written CUDA 27-point stencil (``csrc/stencil27.cu``).

Replaces the Pallas ``_stencil_kernel`` behind ``stencil27``
(``src/repro/kernels/stencil27/stencil27.py``).  Bound by bytes on this
card (about 7 flop per compulsory byte in f32); the kernel marches each
64 x 32 (y, x) column of outputs up z through a ring of four shared-memory
planes filled by ``cp.async``, holds eight outputs along y a thread for
three planes at once, writes the output through its strides (so the
caller can pass the interior window of the block it updates), and masks
ragged edges instead of asserting a tile divides the interior (the overlap
schedule feeds it 3-cell shells).

CUDA tensors only; the CPU path is :func:`repro_torch.kernels.stencil27.
ref.stencil27_ref`, chosen by :mod:`repro_torch.kernels.stencil27.ops`.
Launches on the current stream, allocates nothing, and adds one to
``_build.LAUNCHES["stencil27"]`` per launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {"stencil27": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _I, _P]}

#: outputs of one block in (y, x), as in the kernel (TY, TX)
TILE = (64, 32)
#: blocks the launch should give the card (132 SMs, two of 256 threads
#: resident on each, about four waves); fewer (thin shells, few ranks)
#: split the z march
MIN_BLOCKS = 1024
#: the shortest z march a split leaves a block
MIN_MARCH = 16


def march(ranks: int, z: int, y: int, x: int) -> tuple[int, int]:
    """``(zc, grid_z)``: the output planes one block marches through and the
    grid's z extent (ranks x ceil(z / zc) marches, at most 65535; the kernel
    walks the rest in a loop).  A whole rank's Z unless the (y, x) tiles of
    all ranks hold fewer than :data:`MIN_BLOCKS` blocks, then chunks of at
    least :data:`MIN_MARCH` (or all of Z if it is shorter)."""
    tiles = -(-y // TILE[0]) * -(-x // TILE[1]) * ranks
    chunks = max(1, min(-(-MIN_BLOCKS // tiles), z // MIN_MARCH))
    zc = -(-z // chunks)
    return zc, min(ranks * -(-z // zc), 65535)


def _span(t: torch.Tensor) -> tuple[int, int]:
    """First and one-past-last byte a strided tensor addresses."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def stencil27(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` (R, Z, Y, X) = 27-point stencil of ``x`` (R, Z+2, Y+2, X+2);
    ``w`` is the (3, 3, 3) f32 weight tensor on the same device.  ``x`` and
    ``w`` contiguous; ``out`` any strided view in the input dtype that does
    not overlap ``x`` (the interior window of a block, say).  Returns
    ``out``."""
    for t in (x, w, out):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("stencil27: x, w and out must be on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("stencil27: x and w must be contiguous")
    if x.dtype not in _DTYPE_CODE or out.dtype != x.dtype:
        raise TypeError(f"stencil27: {x.dtype} -> {out.dtype} (f32/bf16, same)")
    if w.dtype != torch.float32 or tuple(w.shape) != (3, 3, 3):
        raise ValueError(f"stencil27: w must be (3, 3, 3) f32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if x.dim() != 4 or any(s < 3 for s in x.shape[1:]):
        raise ValueError(f"stencil27: x must be (R, Z+2, Y+2, X+2), got {tuple(x.shape)}")
    ranks, zi, yi, xi = x.shape[0], *(s - 2 for s in x.shape[1:])
    if tuple(out.shape) != (ranks, zi, yi, xi):
        raise ValueError(f"stencil27: out {tuple(out.shape)} != {(ranks, zi, yi, xi)}")
    if any(s < 0 for s in out.stride()):
        raise ValueError("stencil27: negative output strides")
    if -(-yi // TILE[0]) > 65535 or (yi + 2) * (xi + 2) >= 2**31 or zi >= 2**31:
        raise ValueError(f"stencil27: block {tuple(x.shape[1:])} too large for the grid")
    xs, ob = _span(x), _span(out)
    if xs[0] < ob[1] and ob[0] < xs[1]:
        raise ValueError("stencil27: out overlaps x (the kernel reads x while it writes out)")
    zc, grid_z = march(ranks, zi, yi, xi)
    pair = x.data_ptr() % (2 * x.element_size()) == 0 and (xi + 2) % 2 == 0
    lib = _build.load("stencil27", _SIGNATURES)
    code = lib.stencil27(
        x.data_ptr(), out.data_ptr(), w.data_ptr(), _DTYPE_CODE[x.dtype],
        ranks, zi, yi, xi, zc, grid_z, *out.stride(), int(pair), _build.stream_ptr(x.device),
    )
    _build.LAUNCHES["stencil27"] += 1
    _build.check(code, "stencil27")
    return out
