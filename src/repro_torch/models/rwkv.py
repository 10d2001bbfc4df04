"""RWKV-6 (Finch): attention-free time-mix with data-dependent decay,
PyTorch port of ``src/repro/models/rwkv.py``.

WKV recurrence per head (state S in R^{hd x hd})::

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

with per-channel decays ``w_t = exp(-exp(w_base + lora(x_t)))`` in (0, 1).
The JAX model runs the chunked scan in jnp (``_wkv_chunk``/``wkv_scan``);
here it goes through :func:`repro_torch.kernels.wkv.ops.wkv`: the CUDA
kernel for a CUDA tensor, the plain version for a CPU tensor.  A caller may
inject another function of the same signature (``wkv=``), as a comparison
run does with ``wkv_plain`` on the card.

Layers are a list of per-layer dicts looped in Python; weights are stored
``(out, in)`` and applied with ``F.linear``.  Prefill and decode return a
new cache (the JAX layout: ``tm_shift``/``cm_shift`` ``(L, B, 1, d)``,
``wkv`` ``(L, B, H, hd, hd)`` f32, ``pos`` ``(B,)``) and leave the given one
as it is.

Under a sequence-parallel context on a mesh the time mix scans each rank's
sequence shard twice through the same ``wkv`` function, every rank folded
into the batch of one call: once from a zero state for the shard's affine
operator (:func:`wkv_segment_operator`), then from the incoming state that
:func:`repro_torch.core.ring.state_passing` composes along the model axis.
As in JAX, that branch returns no final state, and prefill and decode call
the time mix without the context, so they scan locally.  The loss waits
for the training slice.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.core.ring import state_passing
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv.ref import CHUNK  # the JAX model's chunk when the config names none
from repro_torch.models import layers as L
from repro_torch.parallel.context import LOCAL, ParallelContext, shard_ranks, unshard_ranks

Params = dict
#: ``wkv(r, k, v, lw, u, *, chunk, S0)`` on ``(B, T, H, hd)`` -> ``(y, S_fin)``
WkvFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]
LORA_R = 32


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv_head_size
    if cfg.d_model % hd:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of the head size {hd}")
    return cfg.d_model // hd, hd


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def layer_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    h, hd = _heads(cfg)
    pd = torch_dtype(cfg.param_dtype)
    dev = gen.device
    lora_r = min(LORA_R, d)

    def uniform(*shape):
        return L.rand(gen, shape) * 0.5 + 0.25

    return {
        "ln1": L.norm_params(cfg, dev),
        "ln2": L.norm_params(cfg, dev),
        # time-mix
        "mu": uniform(5, d).to(pd),
        "wr": L.dense_init(gen, d, d, pd),
        "wk": L.dense_init(gen, d, d, pd),
        "wv": L.dense_init(gen, d, d, pd),
        "wg": L.dense_init(gen, d, d, pd),
        "wo": L.dense_init(gen, d, d, pd),
        "w_base": (L.randn(gen, (d,)) * 0.5 - 1.0).to(pd),
        "w_lora_a": L.dense_init(gen, d, lora_r, pd),
        "w_lora_b": torch.zeros((d, lora_r), dtype=pd, device=dev),
        "u": (L.randn(gen, (h, hd)) * 0.1).to(pd),
        # channel-mix
        "mu_c": uniform(2, d).to(pd),
        "ck": L.dense_init(gen, d, cfg.d_ff, pd),
        "cv": L.dense_init(gen, cfg.d_ff, d, pd),
        "cr": L.dense_init(gen, d, d, pd),
    }


def init(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on the generator's device, in ``cfg.param_dtype``."""
    pd = torch_dtype(cfg.param_dtype)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
        "ln_in": L.norm_params(cfg, gen.device),
        "layers": [layer_params(cfg, gen) for _ in range(cfg.n_layers)],
        "norm_f": L.norm_params(cfg, gen.device),
        "lm_head": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
    }


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------


def wkv_segment_operator(k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
                         chunk: int = CHUNK, *, wkv: WkvFn | None = None):
    """(C, D) of a sequence segment, ``S_out = D * S_in + C`` (for
    ``state_passing``): C is the scan's final state from a zero state with
    ``r = 0`` and ``u = 0`` (on the card the ``wkv_chunked`` kernel), D
    ``exp(sum lw)`` as ``(B, H, hd, 1)``, broadcast over the value dim."""
    B, T, H, hd = k.shape
    r0 = torch.zeros_like(k)
    u0 = torch.zeros((H, hd), dtype=k.dtype, device=k.device)
    _, C = (wkv or wkv_ops.wkv)(r0, k, v, lw, u0, chunk=chunk)
    D = torch.exp(torch.sum(lw, dim=1))[..., None]
    return C, D


def _seq_parallel_wkv(r, k, v, lw, u, *, chunk: int, ctx: ParallelContext,
                      wkv: WkvFn | None) -> torch.Tensor:
    """y of the whole ``(B, T, H, hd)`` sequence, sharded over the model
    axis: each rank's segment operator, the incoming states composed along
    the axis, then each rank's scan from its incoming state."""
    fn = wkv or wkv_ops.wkv
    ranks = [shard_ranks(t, ctx) for t in (r, k, v, lw)]  # (R, b, T/k, H, hd)
    n, b = ranks[0].shape[:2]
    rs, ks, vs, ls = (t.flatten(0, 1) for t in ranks)  # every rank in the batch
    C, D = wkv_segment_operator(ks, vs, ls, chunk=chunk, wkv=fn)
    S_in = state_passing(C.unflatten(0, (n, b)), (D * torch.ones_like(C)).unflatten(0, (n, b)),
                         ctx.mesh, ctx.model_axis, method=ctx.state_method)
    y, _ = fn(rs, ks, vs, ls, u, chunk=chunk, S0=S_in.flatten(0, 1))
    return unshard_ranks(y.unflatten(0, (n, b)), ctx)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Previous-token features; ``prev`` is the carry for decode."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def time_mix(cfg: ModelConfig, lp: Params, x: torch.Tensor, *, ctx: ParallelContext = LOCAL,
             shift_prev=None, S0=None, return_state: bool = False, wkv: WkvFn | None = None):
    B, T, d = x.shape
    H, hd = _heads(cfg)
    xs = _token_shift(x, shift_prev)
    mu = lp["mu"].to(x.dtype)  # (5, d)
    xr, xk, xv, xg, xw = (x + mu[i] * (xs - x) for i in range(5))
    r = F.linear(xr, lp["wr"].to(x.dtype)).reshape(B, T, H, hd)
    k = F.linear(xk, lp["wk"].to(x.dtype)).reshape(B, T, H, hd)
    v = F.linear(xv, lp["wv"].to(x.dtype)).reshape(B, T, H, hd)
    g = F.silu(F.linear(xg, lp["wg"].to(x.dtype)))
    # data-dependent decay (lora), in the activation dtype, then f32
    wl = F.linear(torch.tanh(F.linear(xw, lp["w_lora_a"].to(x.dtype))), lp["w_lora_b"].to(x.dtype))
    lw = -torch.exp(
        torch.clamp(lp["w_base"].float() + wl.float(), -8.0, 4.0)
    ).reshape(B, T, H, hd)  # log w < 0

    rf, kf, vf = r.float(), k.float(), v.float()
    u = lp["u"].float()
    chunk = cfg.scan_chunk or CHUNK

    if ctx.seq_parallel and ctx.mesh is not None and ctx.model_axis:
        # sequence parallel: local scans and the state composed across the
        # ranks; no final state, as in JAX
        y = _seq_parallel_wkv(rf, kf, vf, lw, u, chunk=chunk, ctx=ctx, wkv=wkv)
        S_fin = None
    else:
        y, S_fin = (wkv or wkv_ops.wkv)(rf, kf, vf, lw, u, chunk=chunk, S0=S0)

    y = y.reshape(B, T, d).to(x.dtype) * g
    out = F.linear(y, lp["wo"].to(x.dtype))
    if return_state:
        return out, x[:, -1:], S_fin
    return out


def channel_mix(cfg: ModelConfig, lp: Params, x: torch.Tensor, shift_prev=None,
                return_state: bool = False):
    xs = _token_shift(x, shift_prev)
    mu = lp["mu_c"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(F.relu(F.linear(xk, lp["ck"].to(x.dtype))))
    out = torch.sigmoid(F.linear(xr, lp["cr"].to(x.dtype))) * F.linear(k, lp["cv"].to(x.dtype))
    if return_state:
        return out, x[:, -1:]
    return out


def block(cfg: ModelConfig, lp: Params, x: torch.Tensor, *, ctx: ParallelContext = LOCAL,
          wkv: WkvFn | None = None) -> torch.Tensor:
    x = x + time_mix(cfg, lp, L.apply_norm(cfg, lp["ln1"], x), ctx=ctx, wkv=wkv)
    return x + channel_mix(cfg, lp, L.apply_norm(cfg, lp["ln2"], x))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    return L.apply_norm(cfg, params["ln_in"], x)


def _lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, params["lm_head"].to(x.dtype))


def hidden_states(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                  ctx: ParallelContext = LOCAL, wkv: WkvFn | None = None) -> torch.Tensor:
    x = _embed(cfg, params, tokens)
    for lp in params["layers"]:
        x = block(cfg, lp, x, ctx=ctx, wkv=wkv)
    return L.apply_norm(cfg, params["norm_f"], x)


def logits_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
              ctx: ParallelContext = LOCAL, wkv: WkvFn | None = None) -> torch.Tensor:
    return _lm_head(params, hidden_states(cfg, params, tokens, ctx=ctx, wkv=wkv))


# ---------------------------------------------------------------------------
# decode (exact recurrence; O(1) state per layer)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device: torch.device) -> dict:
    """The recurrent state; ``max_len`` does not size it (kept for the
    engine's common signature)."""
    H, hd = _heads(cfg)
    d, n = cfg.d_model, cfg.n_layers
    dt = torch_dtype(dtype or cfg.dtype)
    return {
        "tm_shift": torch.zeros((n, batch, 1, d), dtype=dt, device=device),
        "cm_shift": torch.zeros((n, batch, 1, d), dtype=dt, device=device),
        "wkv": torch.zeros((n, batch, H, hd, hd), dtype=torch.float32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _layers(cfg: ModelConfig, params: Params, x: torch.Tensor, cache: dict | None,
            wkv: WkvFn | None):
    """Every layer with its carries from ``cache`` (None: a fresh prompt);
    returns x and the new (tm_shift, cm_shift, wkv) per layer."""
    tms, cms, states = [], [], []
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(cfg, lp["ln1"], x)
        out, tm_new, S_new = time_mix(
            cfg, lp, h, return_state=True, wkv=wkv,
            shift_prev=None if cache is None else cache["tm_shift"][i],
            S0=None if cache is None else cache["wkv"][i])
        x = x + out
        h = L.apply_norm(cfg, lp["ln2"], x)
        out, cm_new = channel_mix(cfg, lp, h, return_state=True,
                                  shift_prev=None if cache is None else cache["cm_shift"][i])
        x = x + out
        tms.append(tm_new)
        cms.append(cm_new)
        states.append(S_new)
    return x, tms, cms, states


def _new_cache(like: dict, tms, cms, states, pos: torch.Tensor) -> dict:
    return {
        "tm_shift": torch.stack(tms).to(like["tm_shift"].dtype),
        "cm_shift": torch.stack(cms).to(like["cm_shift"].dtype),
        "wkv": torch.stack(states).float(),
        "pos": pos,
    }


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, cache: dict, *,
                ctx: ParallelContext = LOCAL, wkv: WkvFn | None = None):
    """One token ``token`` (B, 1) through the exact recurrence (the scan at
    T = 1); returns (logits (B, 1, V), new cache)."""
    x = _embed(cfg, params, token)
    x, tms, cms, states = _layers(cfg, params, x, cache, wkv)
    x = L.apply_norm(cfg, params["norm_f"], x)
    return _lm_head(params, x), _new_cache(cache, tms, cms, states, cache["pos"] + 1)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor, cache: dict, *,
            ctx: ParallelContext = LOCAL, wkv: WkvFn | None = None):
    """Fill the recurrent states from a prompt ``tokens`` (B, T), chunked
    scan per layer; returns (last-position logits (B, 1, V), new cache)
    with ``pos`` = T.  As in the JAX scan, T above the chunk length must be
    a multiple of it."""
    x = _embed(cfg, params, tokens)
    x, tms, cms, states = _layers(cfg, params, x, None, wkv)
    x = L.apply_norm(cfg, params["norm_f"], x)
    b, s = tokens.shape
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return _lm_head(params, x[:, -1:]), _new_cache(cache, tms, cms, states, pos)
