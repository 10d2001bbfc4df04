"""Plain PyTorch version of the flash-attention kernel (port of
``src/repro/kernels/flash_attention/ref.py``): f32 scores, kv heads repeated
by ``group``, the causal mask as ``-1e30`` before the softmax, the output in
the input dtype."""

from __future__ import annotations

import math

import torch

#: the mask value of the JAX oracle and kernel
NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"attention_ref: {hq} query heads on {hkv} kv heads")
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = k.repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf.float()) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf.float())
    return out.to(q.dtype)
