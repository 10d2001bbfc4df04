"""Dispatching 27-point stencil update: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor, nothing in between."""

from __future__ import annotations

import torch

from repro_torch.kernels.stencil27.ref import stencil27_ref
from repro_torch.kernels.stencil27.stencil27 import stencil27


def stencil_update(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """27-point stencil of a batch of ghosted blocks ``(R, Z+2, Y+2, X+2)``
    (or one block ``(Z+2, Y+2, X+2)``); returns the interiors."""
    if x.device.type == "cpu":
        return stencil27_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    xb = x.unsqueeze(0) if x.dim() == 3 else x
    xb = xb.contiguous()
    out = torch.empty((xb.shape[0], *(s - 2 for s in xb.shape[1:])),
                      dtype=x.dtype, device=x.device)
    stencil27(xb, w.to(device=x.device, dtype=torch.float32).contiguous(), out)
    return out[0] if x.dim() == 3 else out
