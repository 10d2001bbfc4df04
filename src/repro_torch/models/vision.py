"""Llama-3.2-Vision text decoder with gated cross-attention image layers
(PyTorch port of ``src/repro/models/vision.py``).

Layout: ``n_cross_layers`` groups of (self layers + 1 cross layer); 8 x (4
+ 1) = 40 layers at full size.  The vision tower is a stub: the batch
supplies precomputed patch embeddings ``(B, vision_tokens, d_vision)``,
projected once to d_model.  The cross layers' tanh gates start at zero (hf
semantics), so an untrained model is the pure text decoder.

``params["self_groups"]`` is a list of groups, each a list of the dense
decoder's per-layer dicts; ``params["cross"]`` a list of cross-layer
dicts.  The cache keeps the JAX layout (``k``/``v`` ``(G, n_self, B,
max_len, Hkv, hd)``, the vision KV ``xk``/``xv`` ``(G, B, vision_tokens,
Hkv, hd)`` computed once at prefill, ``pos``); prefill and decode write it
in place.  Prefill's self and cross attention are the local attention (the
flash kernel on the card, injectable as ``attention=``); decode's cross
attention is the plain version over the cached vision KV, as JAX's
``attention_ref``.  In training the self layers are recomputed per
``cfg.remat`` as the dense decoder's (``transformer._remat``), the cross
layers are not, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.kernels.flash_attention.ops import attention_plain
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttentionFn
from repro_torch.parallel.context import LOCAL, ParallelContext

Params = dict


def group_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, self_per_group)."""
    n_cross = cfg.n_cross_layers
    if not n_cross or cfg.n_layers % n_cross:
        raise ValueError(f"{cfg.n_layers} layers do not split into {n_cross} cross groups")
    return n_cross, cfg.n_layers // n_cross - 1


def cross_layer_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "norm_attn": L.norm_params(cfg, gen.device),
        "xattn": L.cross_attention_params(cfg, gen),
        "norm_mlp": L.norm_params(cfg, gen.device),
        "mlp": L.mlp_params(cfg, gen),
    }


def init(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on the generator's device, in ``cfg.param_dtype``."""
    n_groups, n_self = group_layout(cfg)
    pd = torch_dtype(cfg.param_dtype)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
        "vision_proj": L.dense_init(gen, cfg.d_vision, cfg.d_model, pd),
        "self_groups": [[T.layer_params(cfg, gen) for _ in range(n_self)]
                        for _ in range(n_groups)],
        "cross": [cross_layer_params(cfg, gen) for _ in range(n_groups)],
        "norm_f": L.norm_params(cfg, gen.device),
        "lm_head": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
    }


def _gated_mlp(cfg: ModelConfig, cp: Params, x: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg, cp["norm_mlp"], x)
    return x + torch.tanh(cp["xattn"]["gate_ffn"].to(x.dtype)) * L.apply_mlp(cfg, cp["mlp"], h)


def _cross_block(cfg: ModelConfig, cp: Params, x: torch.Tensor, vis: torch.Tensor,
                 attention: AttentionFn | None = None) -> torch.Tensor:
    h = L.apply_norm(cfg, cp["norm_attn"], x)
    x = x + L.cross_attention(cfg, cp["xattn"], h, vis, attention=attention)
    return _gated_mlp(cfg, cp, x)


def _project_vision(params: Params, vision_emb: torch.Tensor, dtype) -> torch.Tensor:
    return F.linear(vision_emb.to(dtype), params["vision_proj"].to(dtype))  # (B, Tv, d)


def hidden_states(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  vision_emb: torch.Tensor, *, ctx: ParallelContext = LOCAL,
                  attention: AttentionFn | None = None) -> torch.Tensor:
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    vis = _project_vision(params, vision_emb, x.dtype)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    self_block = T._remat(cfg, T.decoder_block, x)
    for sp, cp in zip(params["self_groups"], params["cross"]):
        for lp in sp:
            x = self_block(cfg, lp, x, positions, ctx, attention)
        x = _cross_block(cfg, cp, x, vis, attention)
    return L.apply_norm(cfg, params["norm_f"], x)


def _lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, params["lm_head"].to(x.dtype))


def logits_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
              vision_emb: torch.Tensor, *, ctx: ParallelContext = LOCAL,
              attention: AttentionFn | None = None) -> torch.Tensor:
    return _lm_head(params, hidden_states(cfg, params, tokens, vision_emb, ctx=ctx,
                                          attention=attention))


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, ctx: ParallelContext = LOCAL,
            attention: AttentionFn | None = None) -> torch.Tensor:
    """The LM loss of ``batch`` (``tokens``, ``vision_emb``, ``labels``,
    optional ``mask``) through :func:`~repro_torch.models.layers.chunked_lm_loss`."""
    x = hidden_states(cfg, params, batch["tokens"], batch["vision_emb"], ctx=ctx,
                      attention=attention)
    return L.chunked_lm_loss(x, params["lm_head"], batch["labels"], cfg.logits_chunk,
                             mask=batch.get("mask"))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device: torch.device) -> dict:
    n_groups, n_self = group_layout(cfg)
    hd = cfg.resolved_head_dim
    dt = torch_dtype(dtype or cfg.dtype)
    kv = (n_groups, n_self, batch, max_len, cfg.n_kv_heads, hd)
    xkv = (n_groups, batch, cfg.vision_tokens, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        # cross-attention KV over the vision tokens, computed once at prefill
        "xk": torch.zeros(xkv, dtype=dt, device=device),
        "xv": torch.zeros(xkv, dtype=dt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _cross_decode(cfg: ModelConfig, cp: Params, x: torch.Tensor, xk: torch.Tensor,
                  xv: torch.Tensor) -> torch.Tensor:
    """Cross attention against the cached vision KV (decode path): the
    plain version, as JAX's ``attention_ref``."""
    b, hd = x.shape[0], cfg.resolved_head_dim
    h = L.apply_norm(cfg, cp["norm_attn"], x)
    q = F.linear(h, cp["xattn"]["wq"].to(x.dtype)).reshape(b, 1, cfg.n_heads, hd)
    q = L.head_rmsnorm(q, cp["xattn"]["q_norm"])
    out = attention_plain(q, xk, xv, causal=False)
    out = F.linear(out.reshape(b, 1, -1), cp["xattn"]["wo"].to(x.dtype))
    x = x + torch.tanh(cp["xattn"]["gate_attn"].to(x.dtype)) * out
    return _gated_mlp(cfg, cp, x)


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, cache: dict, *,
                ctx: ParallelContext = LOCAL) -> tuple[torch.Tensor, dict]:
    """One decode step on ``token`` (B, 1); returns (logits (B, 1, V),
    cache).  The self-attention KV is written in place; ``pos`` is a new
    tensor."""
    x = params["embed"][token].to(torch_dtype(cfg.dtype))
    pos = cache["pos"]
    for gi, (sp, cp) in enumerate(zip(params["self_groups"], params["cross"])):
        for li, lp in enumerate(sp):
            h = L.apply_norm(cfg, lp["norm_attn"], x)
            att, _, _ = L.decode_attention(cfg, lp["attn"], h, cache["k"][gi, li],
                                           cache["v"][gi, li], pos)
            x = x + att
            x = x + L.apply_mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["norm_mlp"], x))
        x = _cross_decode(cfg, cp, x, cache["xk"][gi], cache["xv"][gi])
    x = L.apply_norm(cfg, params["norm_f"], x)
    return _lm_head(params, x), {**cache, "pos": pos + 1}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, vision_emb: torch.Tensor,
            cache: dict, *, ctx: ParallelContext = LOCAL,
            attention: AttentionFn | None = None) -> tuple[torch.Tensor, dict]:
    """Fill the cache from a prompt ``tokens`` (B, S) and its image's
    ``vision_emb`` (B, vision_tokens, d_vision); returns (last-position
    logits (B, 1, V), cache)."""
    b, s = tokens.shape
    if s > cache["k"].shape[3]:
        raise ValueError(f"prefill of {s} tokens into a cache of {cache['k'].shape[3]}")
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    vis = _project_vision(params, vision_emb, x.dtype)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    hd, tv = cfg.resolved_head_dim, vis.shape[1]
    for gi, (sp, cp) in enumerate(zip(params["self_groups"], params["cross"])):
        for li, lp in enumerate(sp):
            h = L.apply_norm(cfg, lp["norm_attn"], x)
            q, k, v = L._project_qkv(cfg, lp["attn"], h)
            q = L.apply_rope(cfg, q, positions)
            k = L.apply_rope(cfg, k, positions)
            att = L.prefill_attention(cfg, q, k, v, ctx=ctx, causal=True, attention=attention)
            x = x + F.linear(att.reshape(b, s, -1), lp["attn"]["wo"].to(x.dtype))
            x = x + L.apply_mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["norm_mlp"], x))
            cache["k"][gi, li, :, :s] = k.to(cache["k"].dtype)
            cache["v"][gi, li, :, :s] = v.to(cache["v"].dtype)
        # the cross block, capturing the vision KV
        xa = cp["xattn"]
        xk = F.linear(vis, xa["wk"].to(x.dtype)).reshape(b, tv, cfg.n_kv_heads, hd)
        cache["xk"][gi] = L.head_rmsnorm(xk, xa["k_norm"]).to(cache["xk"].dtype)
        cache["xv"][gi] = F.linear(vis, xa["wv"].to(x.dtype)).reshape(
            b, tv, cfg.n_kv_heads, hd).to(cache["xv"].dtype)
        x = _cross_block(cfg, cp, x, vis, attention)
    x = L.apply_norm(cfg, params["norm_f"], x)
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return _lm_head(params, x[:, -1:]), {**cache, "pos": pos}
