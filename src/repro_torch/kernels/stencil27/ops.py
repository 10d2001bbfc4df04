"""Dispatching 27-point stencil update: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor, nothing in between."""

from __future__ import annotations

import torch

from repro_torch.kernels.stencil27.ref import stencil27_ref
from repro_torch.kernels.stencil27.stencil27 import stencil27


def stencil_update(x: torch.Tensor, w: torch.Tensor, *,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """27-point stencil of a batch of ghosted blocks ``(R, Z+2, Y+2, X+2)``
    (or one block ``(Z+2, Y+2, X+2)``); returns the interiors, written into
    ``out`` when given (any strided view of the interior shape that does not
    overlap ``x``, such as the interior window of the block being updated)."""
    if x.device.type == "cpu":
        return stencil27_ref(x, w, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    single = x.dim() == 3
    xb = (x.unsqueeze(0) if single else x).contiguous()
    if out is None:
        out = torch.empty((xb.shape[0], *(s - 2 for s in xb.shape[1:])),
                          dtype=x.dtype, device=x.device)
    stencil27(xb, w.to(device=x.device, dtype=torch.float32).contiguous(),
              out.unsqueeze(0) if single else out)
    return out
