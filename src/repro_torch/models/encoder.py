"""HuBERT X-Large: encoder-only audio transformer with masked cluster
prediction (PyTorch port of ``src/repro/models/encoder.py``).

The conv waveform frontend is a stub: the batch supplies precomputed frame
embeddings ``(B, T, d_vision)``, projected to d_model.  Attention is
bidirectional (``causal=False``; at hubert-xlarge's head dim of 80 the
flash kernel's padded tensor-core route on the card), rotary positions
stand in for HuBERT's conv positional embedding, and ``head`` maps d_model
to the 504 cluster logits (stored ``(V, d)`` here, ``(d, V)`` in JAX).
Encoder-only: no cache and no decode step.  The loss is the masked
cross-entropy of the cluster logits over the masked frames (every frame
without a mask); in training each block is recomputed per ``cfg.remat`` as
the dense decoder's (``transformer._remat``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttentionFn
from repro_torch.parallel.context import LOCAL, ParallelContext

Params = dict


def init(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on the generator's device, in ``cfg.param_dtype``."""
    pd = torch_dtype(cfg.param_dtype)
    return {
        "frame_proj": L.dense_init(gen, cfg.d_vision, cfg.d_model, pd),
        "mask_emb": (L.randn(gen, (cfg.d_model,))
                     * 0.02).to(pd),
        "layers": [T.layer_params(cfg, gen) for _ in range(cfg.n_layers)],
        "norm_f": L.norm_params(cfg, gen.device),
        "head": L.dense_init(gen, cfg.d_model, cfg.vocab_size, pd),
    }


def hidden_states(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                  mask: torch.Tensor | None = None, *, ctx: ParallelContext = LOCAL,
                  attention: AttentionFn | None = None) -> torch.Tensor:
    """frames: (B, T, d_vision); mask: (B, T), > 0 where a frame is
    masked (replaced by ``mask_emb``)."""
    dt = torch_dtype(cfg.dtype)
    x = F.linear(frames.to(dt), params["frame_proj"].to(dt))
    if mask is not None:
        x = torch.where(mask[..., None] > 0, params["mask_emb"].to(x.dtype), x)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    block = T._remat(cfg, T.decoder_block, x)
    for lp in params["layers"]:
        x = block(cfg, lp, x, positions, ctx, attention)
    return L.apply_norm(cfg, params["norm_f"], x)


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, ctx: ParallelContext = LOCAL,
            attention: AttentionFn | None = None) -> torch.Tensor:
    """Masked cluster prediction: ``frames`` with the ``mask``ed ones
    replaced by ``mask_emb``, the cross-entropy of ``head``'s logits
    against ``labels`` over the masked frames (over every frame when the
    batch has no mask)."""
    mask = batch.get("mask")
    x = hidden_states(cfg, params, batch["frames"], mask, ctx=ctx, attention=attention)
    return L.cross_entropy(F.linear(x, params["head"].to(x.dtype)), batch["labels"], mask)


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           ctx: ParallelContext = LOCAL, attention: AttentionFn | None = None) -> torch.Tensor:
    """Inference: the cluster logits of every frame, (B, T, V)."""
    x = hidden_states(cfg, params, frames, None, ctx=ctx, attention=attention)
    return F.linear(x, params["head"].to(x.dtype))
