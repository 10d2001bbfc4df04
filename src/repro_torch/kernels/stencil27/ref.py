"""Plain PyTorch version of the 27-point stencil, batched over stacked ranks.

Same semantics as ``src/repro/kernels/stencil27/ref.py``: f32 accumulation
of ``w[dz, dy, dx] * x`` in dz -> dy -> dx order, output in the input dtype.
"""

from __future__ import annotations

import torch


def stencil27_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: ghosted (..., Z+2, Y+2, X+2); w: (3, 3, 3).  Returns (..., Z, Y, X)."""
    zi, yi, xi = (s - 2 for s in x.shape[-3:])
    wf = w.to(device=x.device, dtype=torch.float32)
    acc = torch.zeros((*x.shape[:-3], zi, yi, xi), dtype=torch.float32, device=x.device)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                sub = x[..., dz:dz + zi, dy:dy + yi, dx:dx + xi].to(torch.float32)
                acc = acc + wf[dz, dy, dx] * sub
    return acc.to(x.dtype)


def jacobi_weights(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """27-point Jacobi smoothing weights (normalized box kernel)."""
    w = torch.ones((3, 3, 3), dtype=dtype, device=device)
    return w / torch.sum(w)
