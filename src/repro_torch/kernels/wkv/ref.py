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

:func:`wkv_bwd_plain` is the written form of the backward that the
hand-written ``wkv_chunked_bwd`` kernel computes (the JAX package has no
WKV backward: XLA differentiates its jnp scan), in the kernel's three
passes.  Per chunk n, with entry state S (the forward's), ``cp = cum - lw``,
``tot`` the chunk's last ``cum`` and dS the gradient of the state leaving
the chunk, only dS crosses chunks::

    dS_in = diag(e^tot) dS + G,   G = sum_t (r_t e^cp_t)^T dy_t

so pass 1 computes every chunk's G (and e^tot) at once, pass 2 scans dS
over the chunks in reverse (elementwise), and pass 3 computes every
chunk's gradients at once from its own rows, S and dS::

    dr_t  = (dy_t S^T) e^cp_t + sum_{s<t} (dy_t.v_s) k_s e^(cp_t - cum_s) + (dy_t.v_t) u k_t
    dk_s  = sum_{t>s} (dy_t.v_s) r_t e^(cp_t - cum_s) + (v_s dS^T) e^(tot - cum_s)
            + (dy_s.v_s) u r_s
    dv_s  = sum_{t>s} A_ts dy_t + (sum_i r_si u_i k_si) dy_s + (k_s e^(tot - cum_s)) dS
    du    = sum_t (dy_t.v_t) r_t k_t

The log decay's gradient has a closed form: with ``dr'`` and ``dk'`` the
parts of ``dr`` and ``dk`` without the bonus, over the whole sequence
``dlw_j = sum_{t>j} (r dr')_t - sum_{s>=j} (k dk')_s + rowsum(S_fin dS_fin)``
(each pair s < j < t of a term counted once).  A chunk's total of
``r dr' - k dk'`` is ``rowsum(S_in dS_in) - rowsum(S_out dS_out)`` (its
pairwise parts cancel), so the sum over every later chunk telescopes:
within chunk n, ``dlw_t = rowsum(S_out dS_out) + sum_{t'>t} (r dr' - k
dk')_t' - (k dk')_t``, with ``S_out`` the next chunk's entry state (S_fin
for the last) and dS_out the scan's.  No running sum crosses chunks.

This module imports nothing of the port's models: the model imports the
kernel package, never the reverse.
"""

from __future__ import annotations

import torch

#: the JAX model's default chunk length (``repro.models.rwkv.CHUNK``)
CHUNK = 16
#: ||kernel - plain|| / ||plain|| per output of the ``wkv_chunked_bwd``
#: kernel against :func:`wkv_bwd_plain` in float64 on the same inputs, by
#: dtype: f32, the kernel's per-pair ``ex2.approx`` (2^-22) and f32 sums over
#: up to 4096 rows; bf16, the gradients rounded to bf16 (2^-8)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def wkv_bwd_plain(r, k, v, lw, u, dy, *, chunk: int = CHUNK, S0=None, dS_fin=None):
    """Gradients of :func:`wkv_scan_ref`'s ``(y, S_final)`` against ``dy``
    (B, T, H, hd) and ``dS_fin`` (B, H, hd, hd; zeros when None), by the
    formulas of the module docstring, in the inputs' dtype, in the
    kernel's passes.  Returns ``(dr, dk, dv, dlw, du, dS0)``: du in u's
    shape ((H, hd): summed over the batch), dS0 the gradient of the
    starting state (of the zeros when ``S0`` is None)."""
    B, T, H, hd = r.shape
    c = min(chunk, T)
    if c <= 0 or T % c:
        raise ValueError(f"wkv: sequence length {T} is not a multiple of the chunk {c}")
    N = T // c
    S = torch.zeros((B, H, hd, hd), dtype=r.dtype, device=r.device) if S0 is None else S0
    states = []  # each chunk's entry state (the forward's), then the final one
    for t0 in range(0, T, c):
        states.append(S)
        _, S = _wkv_chunk(r[:, t0:t0 + c], k[:, t0:t0 + c], v[:, t0:t0 + c],
                          lw[:, t0:t0 + c], u, S)
    states.append(S)

    def chunks(x):  # (B, T, H, hd) -> (B, N, c, H, hd)
        return x.reshape(B, N, c, H, hd)

    # pass 1, every chunk at once: G_n = sum_t (r_t e^cp_t)^T dy_t and e^tot
    cum = torch.cumsum(chunks(lw), dim=2)
    cp = cum - chunks(lw)
    G = torch.einsum("bnthi,bnthj->bnhij", chunks(r) * torch.exp(cp), chunks(dy))
    e_tot = torch.exp(cum[:, :, -1])  # (B, N, H, hd)
    # pass 2: dS leaving each chunk, in reverse; dS0 is the last dS_in
    dS = torch.zeros_like(S) if dS_fin is None else dS_fin.to(S.dtype)
    dS_out = [None] * N
    for n in reversed(range(N)):
        dS_out[n] = dS
        dS = e_tot[:, n, ..., None] * dS + G[:, n]
    # pass 3, each chunk on its own: its gradients given dS_out
    ub = u if u.dim() == 2 else u[:, None]
    ar = torch.arange(c, device=r.device)
    below = (ar[:, None] > ar[None, :])[None, :, :, None, None]  # t > s
    grads = {n: torch.empty_like(r) for n in ("dr", "dk", "dv", "dlw")}
    du = torch.zeros((B, H, hd), dtype=r.dtype, device=r.device)
    for n in range(N):
        sl = slice(n * c, (n + 1) * c)
        rr, kk, vv, dd = r[:, sl], k[:, sl], v[:, sl], dy[:, sl]
        cu, cx, tot, dSn = cum[:, n], cp[:, n], cum[:, n, -1], dS_out[n]
        D = torch.where(below, torch.exp(torch.clamp(cx[:, :, None] - cu[:, None], max=0.0)),
                        0.0)  # (B, t, s, H, hd)
        Bm = torch.einsum("bthj,bshj->bhts", dd, vv)  # dy_t . v_s
        on_diag = torch.diagonal(Bm, dim1=-2, dim2=-1).transpose(1, 2)  # (B, c, H)
        bonus = torch.sum(rr * ub * kk, dim=-1)  # (B, c, H)
        A = torch.einsum("bthi,bshi,btshi->bhts", rr, kk, D)
        kdec = torch.exp(tot[:, None] - cu)
        drp = (torch.exp(cx) * torch.einsum("bthj,bhij->bthi", dd, states[n])
               + torch.einsum("bhts,bshi,btshi->bthi", Bm, kk, D))
        dkp = (torch.einsum("bhts,bthi,btshi->bshi", Bm, rr, D)
               + kdec * torch.einsum("bshj,bhij->bshi", vv, dSn))
        grads["dr"][:, sl] = drp + on_diag[..., None] * ub * kk
        grads["dk"][:, sl] = dkp + on_diag[..., None] * ub * rr
        grads["dv"][:, sl] = (torch.einsum("bhts,bthj->bshj", A, dd) + bonus[..., None] * dd
                              + torch.einsum("bshi,bhij->bshj", kk * kdec, dSn))
        du = du + torch.einsum("bth,bthi->bhi", on_diag, rr * kk)
        # dlw_t = rowsum(S_out dS_out) + sum_{t'>t in the chunk} (r dr' - k dk')_t' - (k dk')_t
        x, y = rr * drp, kk * dkp
        z = x - y
        after = torch.sum(z, dim=1, keepdim=True) - torch.cumsum(z, dim=1)
        grads["dlw"][:, sl] = torch.sum(states[n + 1] * dSn, dim=-1)[:, None] + after - y
    if u.dim() == 2:
        du = torch.sum(du, dim=0)
    return grads["dr"], grads["dk"], grads["dv"], grads["dlw"], du, dS


def bwd_check_inputs(B, T, H, hd, *, dtype=torch.float32, device="cpu", per_row_u=False,
                     seed=0):
    """The seeded inputs of the backward's checks, drawn in f32 on
    ``device``: r, k, v, dy ~ N(0, 1), the model's decays lw =
    -exp(N(-1, 0.5)), u ~ 0.3 N(0, 1) of shape (H, hd) (or (B, H, hd) per
    row), S0 and dS_fin ~ N(0, 1) of shape (B, H, hd, hd).  Returns ``(r, k,
    v, lw, u, S0, dy, dS_fin)``: the two states in f32 (f64 when ``dtype``
    is), the rest in ``dtype``."""
    g = torch.Generator(device).manual_seed(seed)
    r, k, v, dy = (torch.randn((B, T, H, hd), generator=g, device=device) for _ in range(4))
    lw = -torch.exp(torch.randn((B, T, H, hd), generator=g, device=device) * 0.5 - 1.0)
    u = torch.randn((B, H, hd) if per_row_u else (H, hd), generator=g, device=device) * 0.3
    S0, dS_fin = (torch.randn((B, H, hd, hd), generator=g, device=device) for _ in range(2))
    sdt = torch.promote_types(dtype, torch.float32)
    return (*(t.to(dtype) for t in (r, k, v, lw, u)), S0.to(sdt), dy.to(dtype), dS_fin.to(sdt))
