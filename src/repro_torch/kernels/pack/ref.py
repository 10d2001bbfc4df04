"""Plain PyTorch versions of the pack kernels, batched over stacked ranks.

Same semantics as the JAX oracles in ``src/repro/kernels/pack/ref.py``: a
value is taken to f32 and multiplied by ``scale`` only when ``scale != 1``,
then cast to the output type (round-to-nearest-even for bf16, as jnp's
cast).  The CPU path of every packer runs these, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.
"""

from __future__ import annotations

from typing import Sequence

import torch


def pack_2d_ref(slab: torch.Tensor, *, out_dtype=None, scale: float = 1.0) -> torch.Tensor:
    """Elementwise convert (+ scale) of a slab of any shape."""
    out_dtype = out_dtype or slab.dtype
    x = slab
    if scale != 1.0:
        x = x.to(torch.float32) * scale
    return x.to(out_dtype)


def unpack_2d_ref(buf: torch.Tensor, *, out_dtype=None, scale: float = 1.0) -> torch.Tensor:
    """Inverse of :func:`pack_2d_ref` (``1/scale`` computed in Python)."""
    return pack_2d_ref(buf, out_dtype=out_dtype,
                       scale=(1.0 / scale if scale != 1.0 else 1.0))


def gather_pack_ref(
    x: torch.Tensor,
    segments: Sequence,
    *,
    total: int,
    out_dtype=None,
    scale: float = 1.0,
) -> torch.Tensor:
    """``x`` (R, *local) -> (R, total): every ``(offset, start, shape)``
    window (or ``WireSegment``) of each rank's block laid end to end."""
    out_dtype = out_dtype or x.dtype
    bufs, covered = [], 0
    for s in segments:
        offset, start, shape = (s if isinstance(s, tuple)
                                else (s.offset, s.src_start, s.shape))
        assert offset == covered, "segments must tile the buffer in order"
        window = x[(slice(None), *(slice(b, b + n) for b, n in zip(start, shape)))]
        bufs.append(pack_2d_ref(window.reshape(x.shape[0], -1),
                                out_dtype=out_dtype, scale=scale))
        covered += bufs[-1].shape[1]
    assert covered == total, (covered, total)
    return bufs[0] if len(bufs) == 1 else torch.cat(bufs, dim=1)
