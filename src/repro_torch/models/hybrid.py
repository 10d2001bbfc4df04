"""Zamba2 hybrid: a Mamba2 backbone plus one shared attention block every
``attn_every`` layers (PyTorch port of ``src/repro/models/hybrid.py``).

Layer layout for n_layers=38, attn_every=6::

    [6 x (6 mamba layers + shared attn block)] + [2 tail mamba layers]

The shared block has ONE set of weights applied after every group
(zamba2's parameter sharing); its input is ``concat(hidden, embeddings)``
through a down-projection.  ``params["groups"]`` is a list of groups, each
a list of per-layer dicts, ``params["tail"]`` a list of per-layer dicts,
``params["shared"]`` one dict; all looped in Python where JAX scans.

The cache keeps the JAX layout (``g_conv`` ``(G, g, B, k-1, ch)``,
``g_ssd`` ``(G, g, B, nh, hd, ns)`` f32, ``shared_k``/``shared_v`` ``(G,
B, max_len, Hkv, hd)``, ``t_conv``/``t_ssd`` for the tail, ``pos``);
prefill and decode write it in place.  As in JAX, prefill runs its mamba
layers without the context (local scans that keep their states): only the
shared attention takes the ring, and only ``logits`` runs the conv halo and
the state passing.  The local attention (the flash kernel on the card) is
injectable (``attention=``).  In training, as in JAX, each mamba block is
recomputed in the backward (the whole block) whenever ``cfg.remat`` is not
``"none"``; the shared block is not.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.layers import AttentionFn
from repro_torch.parallel.context import LOCAL, ParallelContext

Params = dict


def group_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group_size, n_tail)."""
    g = cfg.attn_every
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def shared_block_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "pre_proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                 torch_dtype(cfg.param_dtype)),
        "norm_attn": L.norm_params(cfg, gen.device),
        "attn": L.attention_params(cfg, gen),
        "norm_mlp": L.norm_params(cfg, gen.device),
        "mlp": L.mlp_params(cfg, gen),
    }


def init(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on the generator's device, in ``cfg.param_dtype``."""
    n_groups, gsize, n_tail = group_layout(cfg)
    pd = torch_dtype(cfg.param_dtype)
    p: Params = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
        "groups": [[ssm.mamba_params(cfg, gen) for _ in range(gsize)] for _ in range(n_groups)],
        "shared": shared_block_params(cfg, gen),
        "norm_f": L.norm_params(cfg, gen.device),
        "lm_head": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
    }
    if n_tail:
        p["tail"] = [ssm.mamba_params(cfg, gen) for _ in range(n_tail)]
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _pre(sp: Params, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    return F.linear(torch.cat([x, emb], dim=-1), sp["pre_proj"].to(x.dtype))


def _mlp_tail(cfg: ModelConfig, sp: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The shared block after its attention: the MLP and the outer residual."""
    h = h + L.apply_mlp(cfg, sp["mlp"], L.apply_norm(cfg, sp["norm_mlp"], h))
    return x + h


def shared_attn_block(cfg: ModelConfig, sp: Params, x: torch.Tensor, emb: torch.Tensor,
                      positions: torch.Tensor, ctx: ParallelContext,
                      attention: AttentionFn | None = None) -> torch.Tensor:
    h = _pre(sp, x, emb)
    h2 = L.apply_norm(cfg, sp["norm_attn"], h)
    h = h + L.self_attention(cfg, sp["attn"], h2, positions, ctx=ctx, attention=attention)
    return _mlp_tail(cfg, sp, x, h)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(torch_dtype(cfg.dtype))


def hidden_states(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                  ctx: ParallelContext = LOCAL,
                  attention: AttentionFn | None = None) -> torch.Tensor:
    emb = _embed(cfg, params, tokens)
    x = emb
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    mb = functools.partial(ssm.mamba_block, ctx=ctx)
    if cfg.remat != "none" and emb.requires_grad:  # JAX: jax.checkpoint of each mamba block
        mb = functools.partial(checkpoint, mb, use_reentrant=False)
    for gp in params["groups"]:
        for lp in gp:
            x = mb(cfg, lp, x)
        x = shared_attn_block(cfg, params["shared"], x, emb, positions, ctx, attention)
    for lp in params.get("tail", []):
        x = mb(cfg, lp, x)
    return L.apply_norm(cfg, params["norm_f"], x)


def _lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, params["lm_head"].to(x.dtype))


def logits_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
              ctx: ParallelContext = LOCAL,
              attention: AttentionFn | None = None) -> torch.Tensor:
    return _lm_head(params, hidden_states(cfg, params, tokens, ctx=ctx, attention=attention))


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, ctx: ParallelContext = LOCAL,
            attention: AttentionFn | None = None) -> torch.Tensor:
    """The LM loss of ``batch`` (``tokens``, ``labels``, optional ``mask``)
    through :func:`~repro_torch.models.layers.chunked_lm_loss`."""
    x = hidden_states(cfg, params, batch["tokens"], ctx=ctx, attention=attention)
    return L.chunked_lm_loss(x, params["lm_head"], batch["labels"], cfg.logits_chunk,
                             mask=batch.get("mask"))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device: torch.device) -> dict:
    n_groups, gsize, n_tail = group_layout(cfg)
    _, nh, hd_s, ns = ssm.dims(cfg)
    ch = ssm.conv_channels(cfg)
    hd = cfg.resolved_head_dim
    dt = torch_dtype(dtype or cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = {
        "g_conv": zeros((n_groups, gsize, batch, cfg.conv_kernel - 1, ch)),
        "g_ssd": zeros((n_groups, gsize, batch, nh, hd_s, ns), torch.float32),
        "shared_k": zeros((n_groups, batch, max_len, cfg.n_kv_heads, hd)),
        "shared_v": zeros((n_groups, batch, max_len, cfg.n_kv_heads, hd)),
        "pos": zeros((batch,), torch.int32),
    }
    if n_tail:
        cache["t_conv"] = zeros((n_tail, batch, cfg.conv_kernel - 1, ch))
        cache["t_ssd"] = zeros((n_tail, batch, nh, hd_s, ns), torch.float32)
    return cache


def _mamba_carry(cfg: ModelConfig, lp: Params, x: torch.Tensor, conv: torch.Tensor,
                 ssd_s: torch.Tensor, *, fresh: bool) -> torch.Tensor:
    """One mamba layer that writes its conv and SSD states into the cache
    views ``conv``/``ssd_s`` in place; ``fresh``: a prompt from no state."""
    out, cs, hs = ssm.mamba_block(cfg, lp, x, conv_state=None if fresh else conv,
                                  ssd_state=None if fresh else ssd_s, return_state=True)
    conv.copy_(cs)
    ssd_s.copy_(hs)
    return out


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, cache: dict, *,
                ctx: ParallelContext = LOCAL) -> tuple[torch.Tensor, dict]:
    """One decode step on ``token`` (B, 1); returns (logits (B, 1, V),
    cache).  Every state is updated in place and shared by the returned
    cache; its ``pos`` is a new tensor."""
    emb = _embed(cfg, params, token)
    x = emb
    pos = cache["pos"]
    sp = params["shared"]
    for gi, gp in enumerate(params["groups"]):
        for li, lp in enumerate(gp):
            x = _mamba_carry(cfg, lp, x, cache["g_conv"][gi, li], cache["g_ssd"][gi, li],
                             fresh=False)
        h = _pre(sp, x, emb)
        att, _, _ = L.decode_attention(cfg, sp["attn"], L.apply_norm(cfg, sp["norm_attn"], h),
                                       cache["shared_k"][gi], cache["shared_v"][gi], pos)
        x = _mlp_tail(cfg, sp, x, h + att)
    for ti, lp in enumerate(params.get("tail", [])):
        x = _mamba_carry(cfg, lp, x, cache["t_conv"][ti], cache["t_ssd"][ti], fresh=False)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return _lm_head(params, x), {**cache, "pos": pos + 1}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache: dict, *,
            ctx: ParallelContext = LOCAL,
            attention: AttentionFn | None = None) -> tuple[torch.Tensor, dict]:
    """Fill the cache from a full prompt ``tokens`` (B, S); returns
    (last-position logits (B, 1, V), cache).  The mamba layers scan
    locally whatever ``ctx`` says (as JAX's), so S above the SSD chunk must
    be a multiple of it."""
    b, s = tokens.shape
    if s > cache["shared_k"].shape[2]:
        raise ValueError(f"prefill of {s} tokens into a cache of {cache['shared_k'].shape[2]}")
    emb = _embed(cfg, params, tokens)
    x = emb
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    sp = params["shared"]
    for gi, gp in enumerate(params["groups"]):
        for li, lp in enumerate(gp):
            x = _mamba_carry(cfg, lp, x, cache["g_conv"][gi, li], cache["g_ssd"][gi, li],
                             fresh=True)
        # the shared attention, capturing its KV
        h = _pre(sp, x, emb)
        q, k, v = L._project_qkv(cfg, sp["attn"], L.apply_norm(cfg, sp["norm_attn"], h))
        q = L.apply_rope(cfg, q, positions)
        k = L.apply_rope(cfg, k, positions)
        att = L.prefill_attention(cfg, q, k, v, ctx=ctx, causal=True, attention=attention)
        h = h + F.linear(att.reshape(b, s, -1), sp["attn"]["wo"].to(x.dtype))
        x = _mlp_tail(cfg, sp, x, h)
        cache["shared_k"][gi, :, :s] = k.to(cache["shared_k"].dtype)
        cache["shared_v"][gi, :, :s] = v.to(cache["shared_v"].dtype)
    for ti, lp in enumerate(params.get("tail", [])):
        x = _mamba_carry(cfg, lp, x, cache["t_conv"][ti], cache["t_ssd"][ti], fresh=True)
    x = L.apply_norm(cfg, params["norm_f"], x)
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return _lm_head(params, x[:, -1:]), {**cache, "pos": pos}
