"""Mamba2 (SSD) block, the state-space backbone of zamba2 (PyTorch port of
``src/repro/models/ssm.py``).

Selective state space with scalar-per-head decay::

    h_t = exp(dt_t * A_h) h_{t-1} + dt_t * x_t (x) B_t
    y_t = C_t . h_t + D_h x_t

Chunked "SSD": within a chunk an attention-like ``(c, c)`` matrix per head,
across chunks the state.  JAX scans the chunks one after the other
(``lax.scan`` over ``_ssd_chunk``); here every chunk's intra-chunk terms
are one batched pass, and the state entering each chunk is the exclusive
prefix of the chunks' affine operators ``h -> exp(total_n) h + S_n``,
written out as a lower-triangular decay matrix over the chunks: no Python
loop over chunks, the same products as JAX's in another summation order.
As in JAX, the scan is plain tensor code outside any kernel.

Under a sequence-parallel context on a mesh (the ranks stacked, as
:mod:`repro_torch.core.partitioned`), the causal depthwise conv1d takes
its left context from the previous sequence shard through
:func:`repro_torch.core.halo.seq_left_halo` (ghost cells, at JAX's default
packer), and the SSD scans each shard twice: from a zero state for the
shard's operator, then from the incoming state that
:func:`repro_torch.core.ring.state_passing` composes along the model axis.
That branch keeps no final state, as in JAX.

Weights ``in_proj``/``out_proj`` are stored ``(out, in)`` and applied with
``F.linear``; ``conv_w`` keeps JAX's ``(k, channels)`` depthwise layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.core.halo import seq_left_halo
from repro_torch.core.ring import state_passing
from repro_torch.models import layers as L
from repro_torch.parallel.context import LOCAL, ParallelContext, shard_ranks, unshard_ranks

Params = dict
CHUNK = 32


def dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim, n_state)."""
    di, nh = cfg.d_inner, cfg.ssm_heads
    if di % nh:
        raise ValueError(f"d_inner {di} is not a multiple of {nh} ssm heads")
    return di, nh, di // nh, cfg.ssm_state


def conv_channels(cfg: ModelConfig) -> int:
    di, _, _, ns = dims(cfg)
    return di + 2 * ns


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def mamba_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    di, nh, _, _ = dims(cfg)
    ch = conv_channels(cfg)
    pd, dev = torch_dtype(cfg.param_dtype), gen.device
    return {
        "norm": L.norm_params(cfg, dev),
        "in_proj": L.dense_init(gen, d, di + ch + nh, pd),
        "conv_w": (torch.randn((cfg.conv_kernel, ch), generator=gen, device=dev) * 0.2).to(pd),
        "conv_b": torch.zeros((ch,), dtype=pd, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 8.0, nh, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm_y": L.norm_params(cfg, dev, di),
        "out_proj": L.dense_init(gen, di, d, pd),
    }


# ---------------------------------------------------------------------------
# conv1d (causal, depthwise) with optional cross-shard halo
# ---------------------------------------------------------------------------


def causal_conv(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                left: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, T, ch). ``left``: (B, k-1, ch) context (ghost cells) or None."""
    kk, t = cfg.conv_kernel, x.shape[1]
    if left is None:
        left = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([left.to(x.dtype), x], dim=1)
    w = lp["conv_w"].to(x.dtype)
    out = sum(xp[:, j: j + t] * w[j] for j in range(kk)) + lp["conv_b"].to(x.dtype)
    return F.silu(out)


def _conv_seq_parallel(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                       ctx: ParallelContext) -> torch.Tensor:
    """The conv of the whole ``(B, T, ch)`` sequence sharded over the model
    axis: each rank's ghost cells from its left neighbour, every rank
    folded into the batch of one conv."""
    xs = shard_ranks(x, ctx)  # (R, b, T/k, ch)
    w = cfg.conv_kernel - 1
    left = seq_left_halo(xs, ctx.mesh, ctx.model_axis, w, seq_axis=1, n_parts=ctx.n_parts)
    y = causal_conv(cfg, lp, xs.flatten(0, 1), left=left[:, :, :w].flatten(0, 1))
    return unshard_ranks(y.unflatten(0, xs.shape[:2]), ctx)


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------


def _ssd_chunks(xh, Bm, Cm, dt, la, h0):
    """Every chunk at once.  xh: (B,n,c,nh,hd); Bm,Cm: (B,n,c,ns); dt,la:
    (B,n,c,nh); h0: (B,nh,hd,ns).  Returns y (B,n,c,nh,hd) and the state
    after the last chunk."""
    c = xh.shape[2]
    cum = torch.cumsum(la, dim=2)  # (B,n,c,nh), <= 0
    # intra-chunk: y_t = sum_{s<=t} exp(cum_t - cum_s) dt_s (C_t.B_s) x_s
    pair = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,n,t,s,nh)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))[:, :, None]
    M = torch.where(mask, torch.exp(torch.clamp(pair, max=0.0)), 0.0)
    G = torch.einsum("bntk,bnsk->bnts", Cm, Bm)
    W = M * G[..., None] * dt[:, :, None, :, :]
    y = torch.einsum("bntsh,bnshp->bnthp", W, xh)
    # each chunk's operator h -> exp(total) h + S, S its state from zero
    total = cum[:, :, -1]  # (B,n,nh)
    wdec = dt * torch.exp(total[:, :, None] - cum)  # (B,n,c,nh)
    S = torch.einsum("bnshp,bnsk,bnsh->bnhpk", xh, Bm, wdec)
    # the state entering chunk j (j = n: the final state), the exclusive
    # prefix of the operators: exp(Lx_j) h0 + sum_{m<j} exp(Lx_j - Lx_{m+1}) S_m
    n = xh.shape[1]
    Lx = torch.cat([torch.zeros_like(total[:, :1]), torch.cumsum(total, dim=1)], dim=1)
    dec = Lx[:, :, None, :] - Lx[:, None, 1:, :]  # (B,n+1,n,nh): rows j, sources m
    below = torch.tril(torch.ones((n + 1, n), dtype=torch.bool, device=xh.device), -1)
    Wc = torch.where(below[:, :, None], torch.exp(torch.clamp(dec, max=0.0)), 0.0)
    h = (torch.exp(Lx)[..., None, None] * h0[:, None]
         + torch.einsum("bjmh,bmhpk->bjhpk", Wc, S))  # (B,n+1,nh,hd,ns)
    # state term: y_t += exp(cum_t) C_t . h_in
    y = y + torch.exp(cum)[..., None] * torch.einsum("bntk,bnhpk->bnthp", Cm, h[:, :n])
    return y, h[:, n]


def ssd_scan(xh, Bm, Cm, dt, la, h0=None, chunk: int = CHUNK):
    """Full sequence SSD: returns (y (B,T,nh,hd), h_final (B,nh,hd,ns)).
    As JAX's scan, T above the chunk length must be a multiple of it
    (``ValueError`` otherwise)."""
    Bsz, T, nh, hd = xh.shape
    ns = Bm.shape[-1]
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"ssd_scan: {T} tokens are not a multiple of the chunk {c} "
                         f"(lengths above {chunk} must be multiples of it, as in JAX)")
    n = T // c
    if h0 is None:
        h0 = torch.zeros((Bsz, nh, hd, ns), dtype=torch.float32, device=xh.device)
    y, h_fin = _ssd_chunks(xh.reshape(Bsz, n, c, nh, hd), Bm.reshape(Bsz, n, c, ns),
                           Cm.reshape(Bsz, n, c, ns), dt.reshape(Bsz, n, c, nh),
                           la.reshape(Bsz, n, c, nh), h0.float())
    return y.reshape(Bsz, T, nh, hd), h_fin


def _ssd_seq_parallel(xh, Bm, Cm, dt, la, *, chunk: int, ctx: ParallelContext) -> torch.Tensor:
    """y of the whole sequence sharded over the model axis: each rank's
    segment operator (C from a zero state, D its total decay), the incoming
    states composed along the axis, then each rank's scan from its
    incoming state."""
    ranks = [shard_ranks(t, ctx) for t in (xh, Bm, Cm, dt, la)]
    n, b = ranks[0].shape[:2]
    xs, bs, cs, ds, ls = (t.flatten(0, 1) for t in ranks)  # every rank in the batch
    _, C_seg = ssd_scan(xs, bs, cs, ds, ls, None, chunk=chunk)
    D_seg = torch.exp(torch.sum(ls, dim=1))[..., None, None]  # (Rb, nh, 1, 1)
    h_in = state_passing(C_seg.unflatten(0, (n, b)),
                         (D_seg * torch.ones_like(C_seg)).unflatten(0, (n, b)),
                         ctx.mesh, ctx.model_axis, method=ctx.state_method)
    y, _ = ssd_scan(xs, bs, cs, ds, ls, h_in.flatten(0, 1), chunk=chunk)
    return unshard_ranks(y.unflatten(0, (n, b)), ctx)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), whatever the magnitude."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------


def mamba_block(
    cfg: ModelConfig,
    lp: Params,
    x: torch.Tensor,  # (B, T, d)
    *,
    ctx: ParallelContext = LOCAL,
    conv_state: torch.Tensor | None = None,  # (B, k-1, ch) decode carry
    ssd_state: torch.Tensor | None = None,  # (B, nh, hd, ns)
    return_state: bool = False,
):
    Bsz, T, _ = x.shape
    di, nh, hd, ns = dims(cfg)
    ch = conv_channels(cfg)
    h = L.apply_norm(cfg, lp["norm"], x)
    proj = F.linear(h, lp["in_proj"].to(x.dtype))  # (B,T,di+ch+nh)
    z, xBC, dt_raw = torch.split(proj, [di, ch, nh], dim=-1)

    seq_par = ctx.seq_parallel and ctx.mesh is not None and ctx.model_axis
    if seq_par:
        xBC = _conv_seq_parallel(cfg, lp, xBC, ctx)
    else:
        xBC = causal_conv(cfg, lp, xBC, left=conv_state)
    new_conv_state = None
    if return_state:
        # keep the last k-1 *pre-conv* inputs for the next step
        if conv_state is None:
            conv_state = torch.zeros((Bsz, cfg.conv_kernel - 1, ch), dtype=x.dtype,
                                     device=x.device)
        hist = torch.cat([conv_state, proj[..., di: di + ch]], dim=1)
        new_conv_state = hist[:, -(cfg.conv_kernel - 1):]

    xh = xBC[..., :di].reshape(Bsz, T, nh, hd).float()
    Bm = xBC[..., di: di + ns].float()
    Cm = xBC[..., di + ns:].float()
    dt = _softplus(dt_raw.float() + lp["dt_bias"])  # (B,T,nh)
    la = -dt * torch.exp(lp["A_log"])  # log decay, < 0
    chunk = cfg.scan_chunk or CHUNK

    if seq_par:
        y, h_fin = _ssd_seq_parallel(xh, Bm, Cm, dt, la, chunk=chunk, ctx=ctx), None
    else:
        y, h_fin = ssd_scan(xh, Bm, Cm, dt, la, ssd_state, chunk=chunk)

    y = y + lp["D"][None, None, :, None] * xh  # skip connection
    y = y.reshape(Bsz, T, di).to(x.dtype)
    y = y * F.silu(z)
    y = L.apply_norm(cfg, lp["norm_y"], y)
    out = x + F.linear(y, lp["out_proj"].to(x.dtype))
    if return_state:
        return out, new_conv_state, h_fin
    return out
