"""Wrapper of the hand-written CUDA 27-point stencil (``csrc/stencil27.cu``).

Replaces the Pallas ``_stencil_kernel`` behind ``stencil27``
(``src/repro/kernels/stencil27/stencil27.py``).  Bound by bytes on this
card (about 7 flop per compulsory byte in f32); the kernel marches up z
with a ring of three shared-memory planes so each input is read from device
memory about once, and masks ragged edges instead of asserting a tile
divides the interior (the overlap schedule feeds it 3-cell shells).

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
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"stencil27": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]}

#: outputs one block marches through in z (doubled while the grid's z
#: extent, ranks * ceil(Z / tz), would exceed CUDA's 65535)
Z_MARCH = 8


def stencil27(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out`` (R, Z, Y, X) = 27-point stencil of ``x`` (R, Z+2, Y+2, X+2);
    ``w`` is the (3, 3, 3) f32 weight tensor on the same device.  All three
    contiguous; ``out`` in the input dtype.  Returns ``out``."""
    for t in (x, w, out):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("stencil27: x, w and out must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("stencil27: x, w and out must be contiguous")
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
    tz = Z_MARCH
    while ranks * -(-zi // tz) > 65535:
        tz *= 2
    lib = _build.load("stencil27", _SIGNATURES)
    code = lib.stencil27(
        x.data_ptr(), out.data_ptr(), w.data_ptr(), _DTYPE_CODE[x.dtype],
        ranks, zi, yi, xi, tz, _build.stream_ptr(x.device),
    )
    _build.LAUNCHES["stencil27"] += 1
    _build.check(code, "stencil27")
    return out
