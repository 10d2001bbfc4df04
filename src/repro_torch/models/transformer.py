"""Dense decoder-only transformer (llama3 / qwen2.5 / granite / stablelm),
PyTorch port of ``src/repro/models/transformer.py``.

The JAX module stacks its layers on a leading axis and runs them with
``lax.scan``; here ``params["layers"]`` is a list of per-layer dicts looped
in Python.  The KV cache keeps the JAX layout, ``(n_layers, B, max_len,
n_kv_heads, head_dim)`` per tensor, and prefill/decode write it in place.

Remat per ``cfg.remat`` where the activations carry a graph (training),
as JAX's ``jax.checkpoint``
around each block: ``"full"`` recomputes the whole block in the backward
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the matrix
products' outputs and recomputes the rest (selective checkpointing, the
counterpart of ``checkpoint_dots``).  Remat changes no value.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.layers import AttentionFn
from repro_torch.parallel.context import LOCAL, ParallelContext

Params = dict

#: the products whose outputs ``remat="dots"`` keeps
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.linear.default})


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn, x: torch.Tensor):
    """``fn`` under ``cfg.remat`` (see the module docstring); as it is when
    ``x`` carries no graph (serving), where nothing would be saved."""
    if cfg.remat == "none" or not x.requires_grad:
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat policy {cfg.remat!r} (none, dots, full)")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def layer_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "norm_attn": L.norm_params(cfg, gen.device),
        "attn": L.attention_params(cfg, gen),
        "norm_mlp": L.norm_params(cfg, gen.device),
        "mlp": L.mlp_params(cfg, gen),
    }


def init(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on the generator's device, in ``cfg.param_dtype``."""
    pd = torch_dtype(cfg.param_dtype)
    p: Params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
        "layers": [layer_params(cfg, gen) for _ in range(cfg.n_layers)],
        "norm_f": L.norm_params(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.embed_init(gen, cfg.vocab_size, cfg.d_model, pd)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def decoder_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
                  ctx: ParallelContext, attention: AttentionFn | None = None) -> torch.Tensor:
    h = L.apply_norm(cfg, lp["norm_attn"], x)
    x = x + L.self_attention(cfg, lp["attn"], h, positions, ctx=ctx, attention=attention)
    h = L.apply_norm(cfg, lp["norm_mlp"], x)
    if ctx.tp_mode == "ring" and ctx.mesh is not None and ctx.model_axis:
        return x + L.apply_mlp_ring(cfg, lp["mlp"], h, ctx)
    return x + L.apply_mlp(cfg, lp["mlp"], h)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def hidden_states(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                  ctx: ParallelContext = LOCAL,
                  attention: AttentionFn | None = None) -> torch.Tensor:
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    block = _remat(cfg, decoder_block, x)
    for lp in params["layers"]:
        x = block(cfg, lp, x, positions, ctx, attention)
    return L.apply_norm(cfg, params["norm_f"], x)


def output_embedding(cfg: ModelConfig, params: Params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _lm_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, output_embedding(cfg, params).to(x.dtype))


def logits_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
              ctx: ParallelContext = LOCAL,
              attention: AttentionFn | None = None) -> torch.Tensor:
    return _lm_head(cfg, params, hidden_states(cfg, params, tokens, ctx=ctx, attention=attention))


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, ctx: ParallelContext = LOCAL,
            attention: AttentionFn | None = None) -> torch.Tensor:
    """The LM loss of ``batch`` (``tokens``, ``labels``, optional ``mask``)
    through :func:`~repro_torch.models.layers.chunked_lm_loss` with
    ``cfg.logits_chunk``."""
    x = hidden_states(cfg, params, batch["tokens"], ctx=ctx, attention=attention)
    return L.chunked_lm_loss(x, output_embedding(cfg, params), batch["labels"],
                             cfg.logits_chunk, mask=batch.get("mask"))


# ---------------------------------------------------------------------------
# decode (KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device: torch.device) -> dict:
    dtype = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),  # per slot
    }


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, cache: dict, *,
                ctx: ParallelContext = LOCAL) -> tuple[torch.Tensor, dict]:
    """One decode step on ``token`` (B, 1); returns (logits (B, 1, V), cache).
    The cache's K/V tensors are updated in place and shared by the returned
    cache; its ``pos`` is a new tensor."""
    x = _embed(cfg, params, token)
    pos = cache["pos"]
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(cfg, lp["norm_attn"], x)
        att, _, _ = L.decode_attention(cfg, lp["attn"], h, cache["k"][i], cache["v"][i], pos)
        x = x + att
        h = L.apply_norm(cfg, lp["norm_mlp"], x)
        x = x + L.apply_mlp(cfg, lp["mlp"], h)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return _lm_head(cfg, params, x), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache: dict, *,
            ctx: ParallelContext = LOCAL, true_len: torch.Tensor | None = None,
            attention: AttentionFn | None = None) -> tuple[torch.Tensor, dict]:
    """Fill the cache from a full prompt ``tokens`` (B, S); returns
    (last-position logits (B, 1, V), cache).

    ``true_len`` ((B,) int32) supports bucket-padded prompts: logits come
    from position ``true_len - 1`` and the cache ``pos`` starts there, so
    right-padding to a shared bucket length reuses one plan per bucket.
    KV rows past ``true_len`` hold the padding's junk, which is safe:
    decode writes each new token's KV at ``pos`` before the causal mask
    exposes it.  The cache's K/V rows ``[0, S)`` are written in place.
    """
    b, s = tokens.shape
    if s > cache["k"].shape[2]:
        raise ValueError(f"prefill of {s} tokens into a cache of {cache['k'].shape[2]}")
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(cfg, lp["norm_attn"], x)
        q, k, v = L._project_qkv(cfg, lp["attn"], h)
        q = L.apply_rope(cfg, q, positions)
        k = L.apply_rope(cfg, k, positions)
        att = L.prefill_attention(cfg, q, k, v, ctx=ctx, attention=attention)
        x = x + F.linear(att.reshape(b, s, -1), lp["attn"]["wo"].to(x.dtype))
        h2 = L.apply_norm(cfg, lp["norm_mlp"], x)
        x = x + L.apply_mlp(cfg, lp["mlp"], h2)
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    x = L.apply_norm(cfg, params["norm_f"], x)
    if true_len is None:
        last = x[:, -1:]
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        pos = true_len.to(device=x.device, dtype=torch.int32).reshape(b)
        last = x[torch.arange(b, device=x.device), pos.long() - 1][:, None]
    return _lm_head(cfg, params, last), {"k": cache["k"], "v": cache["v"], "pos": pos}
