"""Shared neural layers of the dense decoder: norms, rotary embeddings, GQA
attention (+cache), gated MLPs, embeddings (PyTorch port of the slice of
``src/repro/models/layers.py`` that the dense transformer runs).

Pure functions over nested-dict params of tensors.  Weights are stored in
``nn.Linear`` layout ``(out, in)`` and applied with ``F.linear``; the JAX
package stores ``(in, out)`` and :mod:`repro_torch.models.convert` transposes
between the two.

Local attention goes through :func:`repro_torch.kernels.flash_attention.
ops.attention`: the CUDA flash kernel for a CUDA tensor, the plain version
for a CPU tensor, whatever ``ctx.use_flash`` says.  A caller may inject
another function of the same signature (``attention=``), as a test or a
comparison run does with the plain version on the card.

Under a sequence-parallel context on a mesh, prefill attention is ring
attention over the model axis (:func:`repro_torch.core.ring.
ring_attention`) on the stacked ranks (:func:`repro_torch.parallel.context.
shard_ranks`); ``tp_mode="ring"`` runs :func:`apply_mlp_ring`.  On the CPU,
local attention above 8192 tokens is :func:`blockwise_attention`, as in
JAX (on the card flash runs at every length).  :func:`cross_attention` is
llama-3.2-vision's gated cross attention.  The losses wait for the
training slice (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.core.partitioned import ring_all_gather_matmul, ring_matmul_reduce_scatter
from repro_torch.core.ring import _attend_block, ring_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.parallel.context import (
    LOCAL,
    ParallelContext,
    model_shards,
    shard_ranks,
    unshard_ranks,
)

Params = dict
#: ``attention(q, k, v, *, causal)`` on ``(B, S, H, D)`` tensors
AttentionFn = Callable[..., torch.Tensor]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype: torch.dtype,
               scale: float | None = None) -> torch.Tensor:
    """An ``(out_dim, in_dim)`` weight, normal times ``1/sqrt(in_dim)``, made
    on the generator's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((out_dim, in_dim), generator=gen, device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=gen, device=gen.device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_params(cfg: ModelConfig, device: torch.device, dim: int | None = None) -> Params:
    d = dim or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=_pdtype(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=_pdtype(cfg), device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (partial rotary: stablelm rope_pct)
# ---------------------------------------------------------------------------


def rope_frequencies(cfg: ModelConfig, head_dim: int, device: torch.device) -> torch.Tensor:
    rot = int(head_dim * cfg.rope_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)  # (rot/2,)


def apply_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute token positions."""
    d = x.shape[-1]
    rot = int(d * cfg.rope_pct) // 2 * 2
    if rot == 0:
        return x
    inv = rope_frequencies(cfg, d, x.device)
    ang = positions[..., None].float() * inv  # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    pd = _pdtype(cfg)
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, pd),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, pd),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, pd),
        "wo": dense_init(gen, cfg.n_heads * hd, d, pd),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((heads * hd,), dtype=pd, device=gen.device)
    return p


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = F.linear(x, p["wq"].to(x.dtype))
    k = F.linear(x, p["wk"].to(x.dtype))
    v = F.linear(x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:  # added after the product, rounded apart, as in JAX
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, cfg.n_heads, hd), k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


_BLOCKWISE_THRESHOLD = 8192  # above this the CPU path never materializes S^2 scores


def _pick_block(n: int, target: int) -> int:
    """Largest block <= target dividing n (n itself for small primes, e.g.
    the 1601 vision tokens of llama-3.2)."""
    if n <= target:
        return n
    for d in range(target, 0, -1):
        if n % d == 0:
            if d >= 128:
                return d
            break
    return n if n <= 8192 else math.gcd(n, target) or n


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                        q_block: int = 1024, kv_block: int = 1024,
                        scale: float | None = None) -> torch.Tensor:
    """Flash-style attention in plain PyTorch on ``(B, S, H, D)`` tensors:
    a loop over (q, kv) blocks with online-softmax accumulation
    (:func:`repro_torch.core.ring._attend_block`, JAX's order of operations
    and dtypes), so the scores held at once are ``q_block x kv_block``."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    qb, kb = _pick_block(sq, q_block), _pick_block(skv, kv_block)
    scale = scale if scale is not None else d ** -0.5
    outs = []
    for q0 in range(0, sq, qb):
        qblk = q[None, :, q0:q0 + qb]
        m = torch.full((1, b, h, qb), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((1, b, h, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((1, b, qb, h, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, kb):
            m, l, acc = _attend_block(
                qblk, k[None, :, k0:k0 + kb], v[None, :, k0:k0 + kb], m, l, acc,
                torch.tensor([q0], device=q.device), torch.tensor([k0], device=q.device),
                causal=causal, scale=scale)
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l.transpose(2, 3)[..., None]).to(q.dtype)[0])
    return torch.cat(outs, dim=1)


def _local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                     ctx: ParallelContext, attention: AttentionFn | None = None) -> torch.Tensor:
    """(B, S, H, D)-layout attention on local (unsharded-seq) blocks.  The
    JAX package picks its Pallas kernel or its oracle by ``ctx.use_flash``;
    here the device picks (see :func:`~repro_torch.kernels.flash_attention.
    ops.attention`).  On the CPU, above 8192 tokens, the default is
    :func:`blockwise_attention`, as JAX's oracle path; an injected
    ``attention`` runs at every length."""
    if (attention is None and q.device.type == "cpu"
            and max(q.shape[1], k.shape[1]) > _BLOCKWISE_THRESHOLD):
        return blockwise_attention(q, k, v, causal=causal)
    return (attention or flash_ops.attention)(q, k, v, causal=causal)


def prefill_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      ctx: ParallelContext = LOCAL, causal: bool | None = None,
                      attention: AttentionFn | None = None) -> torch.Tensor:
    """Attention for prefill bodies (q, k, v post-rope, (B, S, H, D))."""
    causal = cfg.causal if causal is None else causal
    if ctx.seq_parallel and ctx.mesh is not None and ctx.model_axis:
        # sequence-parallel ring attention: the KV shards circulate the
        # model axis with partitioned (n_parts) exchange, the paper's
        # pipeline; heads stay whole on every rank
        out = ring_attention(
            shard_ranks(q, ctx), shard_ranks(k, ctx), shard_ranks(v, ctx), ctx.mesh,
            ctx.model_axis, causal=causal, n_parts=ctx.n_parts, packer=ctx.comm_packer,
            coalesce=ctx.comm_coalesce)
        return unshard_ranks(out, ctx)
    return _local_attention(q, k, v, causal=causal, ctx=ctx, attention=attention)


def self_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                   ctx: ParallelContext = LOCAL, causal: bool | None = None,
                   attention: AttentionFn | None = None) -> torch.Tensor:
    """Full-sequence self attention (training / prefill); x (B, S, d)."""
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    out = prefill_attention(cfg, q, k, v, ctx=ctx, causal=causal, attention=attention)
    b, s = out.shape[:2]
    return F.linear(out.reshape(b, s, -1), p["wo"].to(x.dtype))


def decode_attention(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (B, Smax, Hkv, hd)
    cache_v: torch.Tensor,
    pos: torch.Tensor,  # (B,) per-sequence positions (continuous batching)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a KV cache; returns (out, cache_k, cache_v).

    The new token's K/V are written into the cache in place (the JAX code
    returns updated copies); a position past the cache writes nothing, as
    JAX's ``mode="drop"`` scatter.  Plain PyTorch on every device: the JAX
    package computes it with einsums outside any Pallas kernel.  Query head
    ``h`` reads kv head ``h // group`` through a grouped view, without the
    repeated copy of the cache that the JAX code makes.
    """
    b = x.shape[0]
    pos = pos.expand(b) if pos.dim() == 0 else pos
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(cfg, q, pos[:, None])
    k = apply_rope(cfg, k, pos[:, None])
    smax = cache_k.shape[1]
    rows = torch.arange(b, device=x.device)
    at = pos.clamp(max=smax - 1)
    keep = (pos < smax)[:, None, None]
    cache_k[rows, at] = torch.where(keep, k[:, 0].to(cache_k.dtype), cache_k[rows, at])
    cache_v[rows, at] = torch.where(keep, v[:, 0].to(cache_v.dtype), cache_v[rows, at])
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    group = cfg.n_heads // hkv
    qg = q.float().reshape(b, 1, hkv, group, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, cache_k.float()) / math.sqrt(hd)
    mask = torch.arange(smax, device=x.device)[None, :] <= pos[:, None]  # (B, Smax)
    s = s.masked_fill(~mask[:, None, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, cache_v.float()).to(x.dtype)
    out = F.linear(out.reshape(b, 1, -1), p["wo"].to(x.dtype))
    return out, cache_k, cache_v


def cross_attention_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Attention weights plus llama-3.2-vision's zero-init tanh gates and
    per-head q/k norm scales."""
    p = attention_params(cfg, gen)
    pd, hd = _pdtype(cfg), cfg.resolved_head_dim
    p["gate_attn"] = torch.zeros((1,), dtype=pd, device=gen.device)
    p["gate_ffn"] = torch.zeros((1,), dtype=pd, device=gen.device)
    p["q_norm"] = torch.ones((hd,), dtype=pd, device=gen.device)
    p["k_norm"] = torch.ones((hd,), dtype=pd, device=gen.device)
    return p


def head_rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMSNorm over the last dim (hf layout, eps 1e-6), rounded to
    ``x``'s dtype before the scale, as JAX's."""
    x = x * torch.rsqrt(torch.mean(x.float() ** 2, dim=-1, keepdim=True) + 1e-6).to(x.dtype)
    return x * scale.to(x.dtype)


def cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, kv_feats: torch.Tensor, *,
                    attention: AttentionFn | None = None) -> torch.Tensor:
    """Gated cross attention (llama-3.2-vision image layers): queries from
    the text stream ``x`` (B, S, d), keys and values from the projected
    vision tokens ``kv_feats`` (B, T_img, d), non-causal local attention
    (the flash kernel on the card), output times ``tanh(gate_attn)``."""
    b, s, _ = x.shape
    t = kv_feats.shape[1]
    hd = cfg.resolved_head_dim
    q = F.linear(x, p["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
    k = F.linear(kv_feats, p["wk"].to(x.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    v = F.linear(kv_feats, p["wv"].to(x.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    q = head_rmsnorm(q, p["q_norm"])
    k = head_rmsnorm(k, p["k_norm"])
    out = _local_attention(q, k, v, causal=False, ctx=LOCAL, attention=attention)
    out = F.linear(out.reshape(b, s, -1), p["wo"].to(x.dtype))
    return torch.tanh(p["gate_attn"].to(x.dtype)) * out


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_params(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = _pdtype(cfg)
    if cfg.act in ("silu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, f, pd),
            "w_up": dense_init(gen, d, f, pd),
            "w_down": dense_init(gen, f, d, pd),
        }
    return {"w_up": dense_init(gen, d, f, pd), "w_down": dense_init(gen, f, d, pd)}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def apply_mlp_ring(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   ctx: ParallelContext) -> torch.Tensor:
    """Sequence-sharded Megatron-SP MLP on the partitioned ring primitives:
    the ring all-gather of x consumed by the gate and up matmuls in flight,
    then the ring matmul-reduce-scatter back to the sequence shards.  The
    wire carries the gather and the scatter, half the column/row-parallel
    all-reduce, and every hop overlaps a chunk matmul (``MPI_Parrived``
    early work).  Rank ``i`` holds output columns ``i`` of the gate and up
    weights and input columns ``i`` of the down weight."""
    d = x.shape[-1]
    xl = shard_ranks(x, ctx)  # rows seq-major: the gathered blocks are seq shards
    r, bl, sl, _ = xl.shape
    x2 = xl.reshape(r, bl * sl, d)

    def col(name):  # (R, d, f/k) of an (f, d) weight
        return model_shards(p[name].to(x.dtype), ctx, 0).mT

    if cfg.act in ("silu", "geglu"):
        act = F.silu if cfg.act == "silu" else _gelu
        hg, hu = ring_all_gather_matmul(x2, [col("w_gate"), col("w_up")], ctx.mesh,
                                        ctx.model_axis)
        h = act(hg) * hu
    else:
        h = _gelu(ring_all_gather_matmul(x2, col("w_up"), ctx.mesh, ctx.model_axis))
    w_down = model_shards(p["w_down"].to(x.dtype), ctx, 1).mT  # (R, f/k, d)
    y = ring_matmul_reduce_scatter(h, w_down, ctx.mesh, ctx.model_axis)
    return unshard_ranks(y.reshape(r, bl, sl, d), ctx)


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act in ("silu", "geglu"):
        act = F.silu if cfg.act == "silu" else _gelu
        h = act(F.linear(x, p["w_gate"].to(x.dtype))) * F.linear(x, p["w_up"].to(x.dtype))
    else:
        h = _gelu(F.linear(x, p["w_up"].to(x.dtype)))
    return F.linear(h, p["w_down"].to(x.dtype))
