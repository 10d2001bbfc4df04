"""Plain PyTorch version of the WKV chunk-scan kernel: a port of
``_wkv_chunk`` and ``wkv_scan`` (``src/repro/models/rwkv.py``) and of
``wkv_chunked_ref`` (``src/repro/kernels/wkv/ref.py``).

Per head, with state S in R^{hd x hd}::

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

swept over T in chunks of ``c = min(chunk, T)``.  Within a chunk the
pairwise decay exponent ``cum[t-1] - cum[s]`` (<= 0) is materialised per
(t, s, channel), masked strictly lower, so no positive number is ever
exponentiated; across chunks the state is carried by a Python loop.

This module imports nothing of the port's models: the model imports the
kernel package, never the reverse.
"""

from __future__ import annotations

import torch

#: the JAX model's default chunk length (``repro.models.rwkv.CHUNK``)
CHUNK = 16


def _wkv_chunk(r, k, v, lw, u, S_in):
    """One chunk.  r, k, v: (B, c, H, hd); lw: (B, c, H, hd) log decays
    (< 0); u: (H, hd), or (B, H, hd) per row; S_in: (B, H, hd, hd).
    Returns (y (B, c, H, hd), S_out)."""
    B, c, H, hd = r.shape
    cum = torch.cumsum(lw, dim=1)
    cum_prev = cum - lw  # decay through t-1

    # state term: y_t += (r_t * exp(cum_{t-1})) . S_in
    r_dec = r * torch.exp(cum_prev)
    y = torch.einsum("bthi,bhij->bthj", r_dec, S_in)

    # intra-chunk: pairwise exponent (<= 0) materialised per channel
    pair = cum_prev[:, :, None] - cum[:, None, :, :]  # (B, t, s, H, hd)
    ar = torch.arange(c, device=r.device)
    mask = (ar[:, None] > ar[None, :])[None, :, :, None, None]
    D = torch.where(mask, torch.exp(torch.clamp(pair, max=0.0)), 0.0)
    A = torch.einsum("bthi,bshi,btshi->bhts", r, k, D)
    y = y + torch.einsum("bhts,bshj->bthj", A, v)

    # bonus (diagonal) term
    ub = u if u.dim() == 2 else u[:, None]  # (H, hd) or (B, 1, H, hd)
    y = y + torch.sum(r * ub * k, dim=-1, keepdim=True) * v

    # chunk state update: S_out = diag(exp(cum_T)) S_in + sum_s exp(cum_T - cum_s) k_s (x) v_s
    total = cum[:, -1]  # (B, H, hd)
    k_dec = k * torch.exp(total[:, None] - cum)
    S_out = torch.exp(total)[..., None] * S_in + torch.einsum("bshi,bshj->bhij", k_dec, v)
    return y, S_out


def wkv_scan_ref(r, k, v, lw, u, S0=None, chunk: int = CHUNK):
    """Full-sequence WKV on the model layout: r, k, v, lw (B, T, H, hd),
    u (H, hd) or (B, H, hd), optional S0 (B, H, hd, hd) in the inputs'
    dtype (zeros when None).  Returns (y (B, T, H, hd), S_final (B, H, hd,
    hd)).
    ``T`` must be a multiple of ``min(chunk, T)``, as in the JAX scan."""
    B, T, H, hd = r.shape
    c = min(chunk, T)
    if c <= 0 or T % c:
        raise ValueError(f"wkv: sequence length {T} is not a multiple of the chunk {c}")
    S = torch.zeros((B, H, hd, hd), dtype=r.dtype, device=r.device) if S0 is None else S0
    ys = []
    for t0 in range(0, T, c):
        y, S = _wkv_chunk(r[:, t0:t0 + c], k[:, t0:t0 + c], v[:, t0:t0 + c],
                          lw[:, t0:t0 + c], u, S)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def wkv_chunked_ref(r, k, v, lw, u, *, chunk: int = CHUNK) -> torch.Tensor:
    """The JAX kernel's signature: r, k, v, lw (BH, T, hd); u (BH, 1, hd)
    per row.  Returns y (BH, T, hd) in the input dtype; the arithmetic is
    f32, as in the kernel."""
    out_dtype = r.dtype
    r, k, v, lw, u = (x.float() for x in (r, k, v, lw, u))
    # rows as batch entries with one head each: u (BH, 1, hd) is per row
    y, _ = wkv_scan_ref(r[:, :, None], k[:, :, None], v[:, :, None], lw[:, :, None], u,
                        chunk=chunk)
    return y[:, :, 0].to(out_dtype)
