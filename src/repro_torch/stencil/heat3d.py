"""The paper's workload's local update: 3-D Jacobi (heat) on the heat3d
layout of ``examples/stencil_heat3d.py`` — z and y decomposed, x whole.

The update takes the batched ``(R, Z+2, Y+2, X)`` block (ghosts on z and
y), wraps the undecomposed x axis periodically by concatenation, and
writes the 27-point stencil of the result into the interior in place.

The port differs from the JAX example on purpose here: JAX computes the
stencil into a fresh array and ``dynamic_update_slice``s it into the block;
the port hands the block's interior window to the stencil as its output,
so the interior is written once.  That is safe because the stencil reads
the concatenated copy, never the block itself.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.stencil27.ops import stencil_update

#: mesh and domain layout of the heat3d workload: (pz, py) over z and y
MESH_AXES = ("pz", "py")
DOMAIN_AXES = ("pz", "py", None)


def heat3d_update(
    weights,
    device: torch.device,
    *,
    stencil: Callable[..., torch.Tensor] = stencil_update,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The update function for :func:`~repro_torch.stencil.strategies.
    make_driver`; ``weights`` is the (3, 3, 3) array (numpy or tensor).
    ``stencil(x, w, out=...)`` defaults to the dispatching kernel wrapper; a
    check passes the plain ``stencil27_ref`` to build the same cycles
    without it.  The update writes into its argument's interior and returns
    it."""
    w = torch.tensor(np.asarray(weights, dtype=np.float32), device=device)

    def update(xl: torch.Tensor) -> torch.Tensor:
        xp = torch.cat([xl[..., -1:], xl, xl[..., :1]], dim=-1)
        stencil(xp, w, out=xl[:, 1:-1, 1:-1, :])
        return xl

    return update
