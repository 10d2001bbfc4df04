"""Mixture-of-Experts decoder (phi-3.5-moe, grok-1), PyTorch port of
``src/repro/models/moe.py``.

Expert weights live in **slot layout**: ``ep_slots`` slots, each holding one
expert's hidden shard of width ``d_ff * n_experts / ep_slots``.  With
``ep_slots == n_experts`` (phi) a slot is a whole expert; grok stores 8
experts as 16 slots (2-way hidden split) so the expert dimension exactly
tiles a 16-way model axis.  The MoE leaves keep the JAX package's layout,
``(in, out)`` matrices for batched products: ``router`` ``(d, E)``,
``w_gate``/``w_up`` ``(S, d, fs)``, ``w_down`` ``(S, fs, d)``; the attention
weights are ``(out, in)`` as in :mod:`repro_torch.models.transformer`.

Two dispatch modes (``ParallelContext.moe_mode``):

* ``dense``: capacity-based scatter/gather on the local device (prefill and
  logits without a mesh); decode is always the dropless all-slots form.
* ``ep``: expert parallelism on the stacked ranks of a one-process
  :class:`~repro_torch.core.mesh.VirtualMesh`: tokens sequence-sharded over
  the model axis (:func:`~repro_torch.parallel.context.shard_ranks`),
  routing and scatter per rank into the ``(R, M, C, d)`` dispatch buffer,
  exchanged by :func:`~repro_torch.core.partitioned.partitioned_all_to_all`
  (``moe_comm="native"``) or :func:`~repro_torch.core.partitioned.
  message_all_to_all` (``"messages"``, through the wire packer), chunked
  over capacity with the expert FFN as each chunk's consumer (the paper's
  partitioned pipeline: expert compute on chunk *k* overlaps the transfer of
  chunk *k+1*).  Hidden-split slots add their partial outputs with a grouped
  psum.  The model axis must hold one rank a slot
  (:func:`~repro_torch.parallel.context.check_ep_mesh`).

Three places differ in form from the JAX code and not in result: top-k
takes the lower expert first among equal probabilities through a stable
sort (``jax.lax.top_k``'s order; ``torch.topk`` promises none), the
capacity scatter accumulates (every dropped entry lands on rank 0 with a
zero row), and the gather reads the clamped rank before masking (JAX
clamps an out-of-range index, torch raises).

Layers are a list of per-layer dicts looped in Python; the KV cache is the
dense decoder's, written in place.  :func:`loss_fn` adds the router's
load-balance loss, averaged over the layers, to the LM loss; in training
each block (attention and MoE FFN) is recomputed per ``cfg.remat`` as the
dense decoder's (``transformer._remat``).  ``fsdp_experts`` selects nothing
here.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.core.partitioned import (
    message_all_to_all,
    partitioned_all_to_all,
    partitioned_psum,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttentionFn
from repro_torch.parallel.context import (
    LOCAL,
    ParallelContext,
    check_ep_mesh,
    model_shards,
    shard_ranks,
    unshard_ranks,
)

Params = dict


def _slots(cfg: ModelConfig) -> int:
    return cfg.ep_slots or cfg.n_experts


def _spe(cfg: ModelConfig) -> int:
    """Slots per expert (the hidden split)."""
    s = _slots(cfg)
    if s % cfg.n_experts:
        raise ValueError(f"{s} slots do not split over {cfg.n_experts} experts")
    return s // cfg.n_experts


def _f_shard(cfg: ModelConfig) -> int:
    spe = _spe(cfg)
    if cfg.d_ff % spe:
        raise ValueError(f"d_ff {cfg.d_ff} does not split into {spe} slots an expert")
    return cfg.d_ff // spe


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    return max(1, int(n_tokens * cfg.capacity_factor * cfg.top_k / cfg.n_experts))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _stack_init(gen: torch.Generator, n: int, in_dim: int, out_dim: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``n`` stacked ``(in_dim, out_dim)`` weights, normal times
    ``1/sqrt(in_dim)``, made on the generator's device."""
    w = L.randn(gen, (n, in_dim, out_dim))
    return (w / math.sqrt(in_dim)).to(dtype)


def moe_ffn_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, fs, s = cfg.d_model, _f_shard(cfg), _slots(cfg)
    pd = torch_dtype(cfg.param_dtype)
    p = {
        "router": _stack_init(gen, 1, d, cfg.n_experts, pd)[0],
        "w_up": _stack_init(gen, s, d, fs, pd),
        "w_down": _stack_init(gen, s, fs, d, pd),
    }
    if cfg.act in ("silu", "geglu"):
        p["w_gate"] = _stack_init(gen, s, d, fs, pd)
    return p


def layer_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return {
        "norm_attn": L.norm_params(cfg, gen.device),
        "attn": L.attention_params(cfg, gen),
        "norm_mlp": L.norm_params(cfg, gen.device),
        "moe": moe_ffn_params(cfg, gen),
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
# routing
# ---------------------------------------------------------------------------


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x: (..., T, d) -> (weights (..., T, k), experts (..., T, k), aux loss
    (...)); leading dims are independent routings (the stacked ranks)."""
    logits = torch.matmul(x, router_w.to(x.dtype)).float()  # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: largest first, the lower expert first among equals
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :cfg.top_k], idx[..., :cfg.top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux: E * sum_e fraction_e * prob_e
    frac = _one_hot(idx, cfg.n_experts, torch.float32).sum(-2).mean(-2)  # (..., E)
    aux = cfg.n_experts * (frac * probs.mean(-2)).sum(-1)
    return w.to(x.dtype), idx, aux


def _dispatch_indices(cfg: ModelConfig, idx: torch.Tensor, T: int, capacity: int):
    """Capacity-based rank of every (token, choice) within its expert:
    ``idx`` (..., T, k) -> expert, rank and keep mask, each (..., T*k)."""
    tk = idx.flatten(-2)
    oh = _one_hot(tk, cfg.n_experts, torch.int64)  # (..., T*k, E)
    ranks = torch.cumsum(oh, dim=-2) - oh
    rank_e = torch.take_along_dim(ranks, tk[..., None], dim=-1)[..., 0]
    keep = rank_e < capacity
    return tk, rank_e, keep


def _ffn(cfg: ModelConfig, x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Batched expert FFN: x (B, N, d) with weights (B, d, f) and (B, f, d)."""
    def mm(a, w):
        return torch.bmm(a, w.to(a.dtype))

    if cfg.act in ("silu", "geglu"):
        act = F.silu if cfg.act == "silu" else L._gelu
        h = act(mm(x, w_gate)) * mm(x, w_up)
    else:
        h = L._gelu(mm(x, w_up))
    return mm(h, w_down)


def _expert_ffn(cfg: ModelConfig, p: Params, slot_x: torch.Tensor) -> torch.Tensor:
    """slot_x: (S_slots, C, d) -> per-slot FFN outputs (hidden shard)."""
    return _ffn(cfg, slot_x, p.get("w_gate"), p["w_up"], p["w_down"])


def _combine(gathered: torch.Tensor, keep: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., T*k, d) expert outputs of each kept choice, weighted and summed
    over the k choices -> (..., T, d)."""
    gathered = torch.where(keep[..., None], gathered, 0)
    return (gathered.unflatten(-2, w.shape[-2:]) * w[..., None]).sum(-2)


def _moe_dense(cfg: ModelConfig, p: Params, x2d: torch.Tensor):
    """Local capacity dispatch (T, d) -> (T, d), all slots resident."""
    Tn, d = x2d.shape
    E, spe = cfg.n_experts, _spe(cfg)
    capacity = _capacity(cfg, Tn)
    w, idx, aux = _route(cfg, p["router"], x2d)
    tk, rank_e, keep = _dispatch_indices(cfg, idx, Tn, capacity)
    safe_rank = torch.where(keep, rank_e, 0)
    x_rep = torch.where(keep[:, None], x2d.repeat_interleave(cfg.top_k, dim=0), 0)
    buf = torch.zeros((E, capacity, d), dtype=x2d.dtype, device=x2d.device)
    buf.index_put_((tk, safe_rank), x_rep, accumulate=True)
    # replicate expert buffer across its hidden-shard slots
    y_slots = _expert_ffn(cfg, p, buf.repeat_interleave(spe, dim=0))  # (S, C, d)
    y_exp = y_slots.reshape(E, spe, capacity, d).sum(1)  # (E, C, d)
    y = _combine(y_exp[tk, safe_rank], keep, w)
    return y.to(x2d.dtype), aux


def _moe_dropless(cfg: ModelConfig, p: Params, x2d: torch.Tensor):
    """Dropless all-slots MoE (decode path): every slot's FFN runs on every
    token; outputs are combined with top-k router weights.  E/k x the active
    FLOPs, but decode is memory-bound on the expert weights themselves, so
    the roofline is unchanged, and no token is ever dropped."""
    E, spe = cfg.n_experts, _spe(cfg)
    w, idx, aux = _route(cfg, p["router"], x2d)
    slot_x = x2d.expand(_slots(cfg), *x2d.shape)  # (S, T, d)
    y_slots = _expert_ffn(cfg, p, slot_x)  # (S, T, d)
    y_exp = y_slots.reshape(E, spe, *x2d.shape).sum(1)  # (E, T, d)
    w_e = torch.einsum("tk,tke->te", w, _one_hot(idx, E, x2d.dtype))  # (T, E)
    y = torch.einsum("te,etd->td", w_e, y_exp)
    return y.to(x2d.dtype), aux


def _moe_ep_local(cfg: ModelConfig, ctx: ParallelContext, p: Params,
                  x_local: torch.Tensor):
    """Every rank's tokens ``x_local`` (R, T_loc, d), stacked; expert slots
    sharded over the model axis, one a rank.  Paper-technique core."""
    mesh, axis = ctx.mesh, ctx.model_axis
    M, spe = _slots(cfg), _spe(cfg)
    R, Tn, d = x_local.shape
    capacity = _capacity(cfg, Tn)
    w, idx, aux = _route(cfg, p["router"], x_local)
    tk, rank_e, keep = _dispatch_indices(cfg, idx, Tn, capacity)  # (R, T*k)
    x_rep = torch.where(keep[..., None], x_local.repeat_interleave(cfg.top_k, dim=1), 0)
    safe_rank = torch.where(keep, rank_e, 0)
    rows = torch.arange(R, device=x_local.device)[:, None].expand_as(tk)
    # scatter into the slot buffer; hidden-split experts receive duplicates
    buf = torch.zeros((R, M, capacity, d), dtype=x_local.dtype, device=x_local.device)
    for j in range(spe):
        buf.index_put_((rows, tk * spe + j, safe_rank), x_rep, accumulate=True)
    # each rank's own slot: (R, d, fs) and (R, fs, d)
    mine = {n: model_shards(p[n], ctx, dim=0)[:, 0] for n in ("w_gate", "w_up", "w_down")
            if n in p}

    def expert_consume(chunk):  # (R, M, c, d) arrived tokens -> early work
        r, m, c, _ = chunk.shape
        y = _ffn(cfg, chunk.reshape(r, m * c, d), mine.get("w_gate"), mine["w_up"],
                 mine["w_down"])
        return y.reshape(r, m, c, d)

    # dispatch: partitioned all-to-all with the expert FFN as per-chunk
    # consumer (MPI_Parrived early work), chunked over capacity;
    # moe_comm='messages' routes it through the transport layer's Message
    # tables, so the wire packer (ctx.comm_packer) applies to the tokens
    if ctx.moe_comm == "messages":
        a2a = functools.partial(message_all_to_all, packer=ctx.comm_packer,
                                coalesce=ctx.comm_coalesce)
    else:
        a2a = partitioned_all_to_all
    kw = dict(split_axis=0, concat_axis=0, n_parts=max(1, ctx.n_parts), chunk_axis=1)
    # (R, M, C, d): each rank's slot outputs for every source rank
    y_slot = a2a(buf, mesh, axis, consume_fn=expert_consume, **kw)
    if spe > 1:
        groups = [[e * spe + j for j in range(spe)] for e in range(cfg.n_experts)]
        y_slot = partitioned_psum(y_slot, mesh, axis, axis_index_groups=groups)
    # return: all-to-all back (chunked identically); [r, s] = rank r's
    # tokens' outputs from slot s, the j = 0 copy carrying the psum
    y_back = a2a(y_slot, mesh, axis, **kw)
    y = _combine(y_back[rows, tk * spe, safe_rank], keep, w)
    return y.to(x_local.dtype), aux


def apply_moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  ctx: ParallelContext) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux). Dispatch mode per context."""
    s, d = x.shape[1:]

    def run(x_bsd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if ctx.moe_mode == "ep" and ctx.mesh is not None and ctx.model_axis:
            check_ep_mesh(ctx, _slots(cfg))
            # tokens are always sequence-sharded over the EP axis: routing is
            # per token, and replicated tokens would make every rank dispatch
            # identical buffers (each expert's work done |EP| times over)
            xl = shard_ranks(x_bsd, ctx)  # (R, b/nd, s/k, d)
            y, aux = _moe_ep_local(cfg, ctx, p, xl.reshape(xl.shape[0], -1, d))
            # JAX's mean over its (data, model) array of per-shard aux
            return unshard_ranks(y.reshape(xl.shape), ctx), aux.mean()
        y, aux = _moe_dense(cfg, p, x_bsd.reshape(-1, d))
        return y.reshape(x_bsd.shape), aux

    chunk = cfg.moe_seq_chunk
    if chunk and s > chunk and s % chunk == 0:
        n = s // chunk
        ys, aux_sum = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            y, aux = run(x[:, i * chunk:(i + 1) * chunk])
            ys.append(y)
            aux_sum = aux_sum + aux
        return torch.cat(ys, dim=1), aux_sum / n
    return run(x)


# ---------------------------------------------------------------------------
# model assembly (mirrors transformer.py, MoE FFN + aux-loss sum)
# ---------------------------------------------------------------------------


def hidden_states(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                  ctx: ParallelContext = LOCAL,
                  attention: AttentionFn | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(final-normed hidden states, the router aux loss averaged over layers)."""
    x = T._embed(cfg, params, tokens)
    positions = T._positions(tokens)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    blk = T._remat(cfg, _block, x)
    for lp in params["layers"]:
        x, aux = blk(cfg, lp, x, positions, ctx, attention)
        aux_sum = aux_sum + aux
    return L.apply_norm(cfg, params["norm_f"], x), aux_sum / cfg.n_layers


def _block(cfg: ModelConfig, lp: Params, x: torch.Tensor, positions: torch.Tensor,
           ctx: ParallelContext, attention: AttentionFn | None):
    """One decoder layer with the MoE FFN: (x, the layer's router aux loss)."""
    h = L.apply_norm(cfg, lp["norm_attn"], x)
    x = x + L.self_attention(cfg, lp["attn"], h, positions, ctx=ctx, attention=attention)
    h = L.apply_norm(cfg, lp["norm_mlp"], x)
    y, aux = apply_moe_ffn(cfg, lp["moe"], h, ctx)
    return x + y, aux


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, ctx: ParallelContext = LOCAL,
            attention: AttentionFn | None = None) -> torch.Tensor:
    """The LM loss of ``batch`` (``tokens``, ``labels``, optional ``mask``)
    plus ``router_aux_coef`` times the router's load-balance loss averaged
    over the layers, as JAX's."""
    x, aux = hidden_states(cfg, params, batch["tokens"], ctx=ctx, attention=attention)
    ce = L.chunked_lm_loss(x, T.output_embedding(cfg, params), batch["labels"],
                           cfg.logits_chunk, mask=batch.get("mask"))
    return ce + cfg.router_aux_coef * aux


def logits_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
              ctx: ParallelContext = LOCAL,
              attention: AttentionFn | None = None) -> torch.Tensor:
    x, _ = hidden_states(cfg, params, tokens, ctx=ctx, attention=attention)
    return T._lm_head(cfg, params, x)


init_cache = T.init_cache


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, cache: dict, *,
                ctx: ParallelContext = LOCAL) -> tuple[torch.Tensor, dict]:
    """One decode step on ``token`` (B, 1), the dropless FFN under any
    context; returns (logits (B, 1, V), cache), K/V written in place."""
    x = T._embed(cfg, params, token)
    pos = cache["pos"]
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(cfg, lp["norm_attn"], x)
        att, _, _ = L.decode_attention(cfg, lp["attn"], h, cache["k"][i], cache["v"][i], pos)
        x = x + att
        h = L.apply_norm(cfg, lp["norm_mlp"], x)
        y, _ = _moe_dropless(cfg, lp["moe"], h.reshape(-1, h.shape[-1]))
        x = x + y.reshape(h.shape)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return T._lm_head(cfg, params, x), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache: dict, *,
            ctx: ParallelContext = LOCAL,
            attention: AttentionFn | None = None) -> tuple[torch.Tensor, dict]:
    """Fill the cache from a full prompt ``tokens`` (B, S) at its exact
    length (capacity routing is length-sensitive, so MoE prompts are never
    padded); returns (last-position logits (B, 1, V), cache).  The cache's
    K/V rows ``[0, S)`` are written in place."""
    b, s = tokens.shape
    if s > cache["k"].shape[2]:
        raise ValueError(f"prefill of {s} tokens into a cache of {cache['k'].shape[2]}")
    x = T._embed(cfg, params, tokens)
    positions = T._positions(tokens)
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(cfg, lp["norm_attn"], x)
        q, k, v = L._project_qkv(cfg, lp["attn"], h)
        q = L.apply_rope(cfg, q, positions)
        k = L.apply_rope(cfg, k, positions)
        att = L.prefill_attention(cfg, q, k, v, ctx=ctx, attention=attention)
        x = x + F.linear(att.reshape(b, s, -1), lp["attn"]["wo"].to(x.dtype))
        h = L.apply_norm(cfg, lp["norm_mlp"], x)
        y, _ = apply_moe_ffn(cfg, lp["moe"], h, ctx)
        x = x + y
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
    x = L.apply_norm(cfg, params["norm_f"], x)
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return T._lm_head(cfg, params, x[:, -1:]), {"k": cache["k"], "v": cache["v"], "pos": pos}
