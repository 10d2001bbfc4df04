"""Dispatching attention on the model layout ``(B, S, H, D)``: the CUDA
flash kernel for a CUDA tensor, the plain version for a CPU tensor, nothing
in between (port of ``src/repro/kernels/flash_attention/ops.py``).

The JAX wrapper swaps to ``(B, H, S, D)`` before its kernel; the CUDA kernel
reads the model layout through strides, so no transposing copy is made.
On the card a call that needs a gradient (grad enabled, an input requiring
grad) goes through :class:`~repro_torch.kernels.flash_attention.flash.
FlashAttentionFn`, whose backward is the hand-written ``flash_attention_bwd``
kernel; any other call launches the forward alone, as serving does.  A
meta tensor takes the same calls, whose meta routes launch nothing and
record each kernel's cost (the dry-run).  On
the CPU autograd differentiates the plain version, as JAX's training
differentiates its plain attention.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash import FlashAttentionFn, flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention_plain(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """:func:`attention_ref` on the model layout, on any device."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, scale=scale)
    return out.transpose(1, 2)


def attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-head (GQA) attention with model-layout tensors."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type not in ("cuda", "meta"):  # meta: the kernels' dry-run route
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
