"""Dispatching WKV on the model layout ``(B, T, H, hd)``: the CUDA kernel
for a CUDA tensor, the plain version for a CPU tensor, nothing in between
(port of ``src/repro/kernels/wkv/ops.py``).

The JAX wrapper folds heads into rows, ``(B*H, T, hd)``, and returns y
only; the port's kernel reads the model layout through strides and also
takes a starting state and returns the final one, because the port's RWKV
model runs its scan here (the JAX model runs its own jnp ``wkv_scan``).
On the card a call that needs a gradient (grad enabled, an input requiring
grad) goes through :class:`~repro_torch.kernels.wkv.wkv.WkvChunkedFn`,
whose backward is the hand-written ``wkv_chunked_bwd`` kernel; any other
call launches the forward alone, as serving does.  A meta tensor takes the
same calls, whose meta routes launch nothing and record each kernel's cost
(the dry-run).  On the CPU autograd
differentiates the plain version, as JAX's training differentiates its
jnp scan.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv.ref import CHUNK, wkv_scan_ref
from repro_torch.kernels.wkv.wkv import WkvChunkedFn, wkv_chunked


#: the plain version on the model layout, on any device (the CPU path, and
#: the function a comparison run injects on the card)
wkv_plain = wkv_scan_ref


def wkv(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lw: torch.Tensor,
    u: torch.Tensor,
    *,
    chunk: int = CHUNK,
    S0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Model-layout WKV from the state ``S0`` (zeros when None); returns
    ``(y (B, T, H, hd), S_fin (B, H, hd, hd))``."""
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, lw, u, chunk=chunk, S0=S0)
    if r.device.type not in ("cuda", "meta"):  # meta: the kernels' dry-run route
        raise ValueError(f"unsupported device {r.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (r, k, v, lw, u, S0)):
        return WkvChunkedFn.apply(r, k, v, lw, u, S0, chunk)
    return wkv_chunked(r, k, v, lw, u, chunk=chunk, S0=S0)
