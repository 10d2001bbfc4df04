"""The WKV backward's plain version (``kernels/wkv/ref.wkv_bwd_plain``, the
written form of the ``wkv_chunked_bwd`` kernel's math and its oracle on the
card) against autograd through the port's plain scan and against
``jax.vjp`` of the JAX model's ``wkv_scan``, on the CPU.  The kernel itself
is held against this plain version on the card in
``tests/test_torch_train_cuda.py`` and ``chip_smoke.py`` phase M1.

Every output is checked: dr, dk, dv, dlw, du and the starting state's
gradient dS0, with a starting state and a gradient on the final state
(the sequence-parallel segment operator's) or without, at chunks 16 and
64, with ``T = c`` (one chunk, 20 rows: a chunk that is not a multiple of
16) and with a per-row bonus ``u``.

Tolerances, stated: against autograd in float64, relative L2 1e-10 per
output (the same formulas, summed in other orders); against JAX in
float32, relative L2 1e-4 per output (XLA's scan and the plain version
sum the products and the cumulative decays in other orders); the dlw
identity against a token-by-token recurrence in float64, 1e-10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv import wkv_scan as j_wkv_scan
from repro_torch.kernels.wkv import wkv_bwd_plain, wkv_chunked_bwd, wkv_plain
from repro_torch.kernels.wkv.ref import BWD_TOL, _wkv_chunk, bwd_check_inputs

torch.set_num_threads(1)

F64_TOL, JAX_TOL = 1e-10, 1e-4
NAMES = ("dr", "dk", "dv", "dlw", "du", "dS0")


#: the checks' seeded inputs, in float64 unless a test asks for f32
_inputs = functools.partial(bwd_check_inputs, dtype=torch.float64)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def _autograd(r, k, v, lw, u, S0, dy, dS_fin, chunk):
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u, S0)]
    y, S = wkv_plain(*leaves[:5], S0=leaves[5], chunk=chunk)
    obj = torch.sum(y * dy) + (torch.sum(S * dS_fin) if dS_fin is not None else 0.0)
    return torch.autograd.grad(obj, leaves)


@pytest.mark.parametrize("B,T,H,hd,chunk,per_row_u,with_dS", [
    (2, 48, 3, 8, 16, False, True),    # three chunks, state in and out
    (1, 64, 2, 16, 64, True, True),    # T = c = 64, a per-row bonus
    (2, 20, 2, 8, 64, False, False),   # T = c = 20: one chunk, not a multiple of 16
    (1, 64, 2, 32, 16, False, False),  # four chunks, no gradient on the final state
], ids=["c16-state", "c64-T=c-rowu", "T=c=20", "c16-hd32"])
def test_bwd_plain_matches_autograd(B, T, H, hd, chunk, per_row_u, with_dS):
    r, k, v, lw, u, S0, dy, dS_fin = _inputs(B, T, H, hd, per_row_u=per_row_u)
    dS_fin = dS_fin if with_dS else None
    got = wkv_bwd_plain(r, k, v, lw, u, dy, chunk=chunk, S0=S0, dS_fin=dS_fin)
    want = _autograd(r, k, v, lw, u, S0, dy, dS_fin, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= F64_TOL, (name, _rel(g, w))


@functools.cache
def _jax_vjp(chunk: int):
    def f(r, k, v, lw, u, S0, dy, dS):
        _, vjp = jax.vjp(lambda *a: j_wkv_scan(*a, chunk=chunk), r, k, v, lw, u, S0)
        return vjp((dy, dS))

    return jax.jit(f, compiler_options={"xla_backend_optimization_level": 0})


@pytest.mark.parametrize("B,T,H,hd,chunk", [(2, 48, 2, 16, 16), (1, 128, 2, 8, 64),
                                            (2, 16, 2, 16, 16)],
                         ids=["c16", "c64", "T=c"])
def test_bwd_plain_matches_jax_vjp(B, T, H, hd, chunk):
    ins = _inputs(B, T, H, hd, dtype=torch.float32, seed=1)
    got = wkv_bwd_plain(*ins[:5], ins[6], chunk=chunk, S0=ins[5], dS_fin=ins[7])
    want = _jax_vjp(chunk)(*(jnp.asarray(t.numpy()) for t in ins))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == tuple(w.shape), name
        assert _rel(g, w) <= JAX_TOL, (name, _rel(g, w))


def test_dlw_closed_form_against_a_token_recurrence():
    """dlw alone: the closed form (a running sum of ``r dr' - k dk'`` from
    ``rowsum(S_fin dS_fin)``) against autograd through the plain recurrence
    S_t = diag(e^lw_t) S_{t-1} + k_t v_t^T, y_t = r_t (S_{t-1} + diag(u)
    k_t v_t^T), one token at a time, which shares no code with the chunked
    scan."""
    r, k, v, lw, u, S0, dy, dS_fin = _inputs(2, 40, 2, 8, seed=3)
    lw_g = lw.clone().requires_grad_()
    S, ys = S0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u[..., None] * kv))
        S = torch.exp(lw_g[:, t])[..., None] * S + kv
    obj = torch.sum(torch.stack(ys, 1) * dy) + torch.sum(S * dS_fin)
    (want,) = torch.autograd.grad(obj, lw_g)
    for chunk in (8, 40):
        got = wkv_bwd_plain(r, k, v, lw, u, dy, chunk=chunk, S0=S0, dS_fin=dS_fin)[3]
        assert _rel(got, want) <= F64_TOL, (chunk, _rel(got, want))


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    """``wkv_chunked_bwd`` is the card's: CPU tensors raise (on the CPU,
    ``ops.wkv`` is the plain version, which autograd differentiates)."""
    r, k, v, lw, u, _, dy, _ = _inputs(1, 16, 2, 8, dtype=torch.float32)
    states = torch.zeros((1, 2, 1, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_chunked_bwd(r, k, v, lw, u, dy, states, chunk=16)


def _factored_bwd(r, k, v, lw, u, dy, *, chunk, S0=None, dS_fin=None, sb=16):
    """Plain float32 emulation of the ``wkv_chunked_bwd`` kernel's arithmetic
    (``csrc/wkv.cu``) on rows: r, k, v, lw, dy (R, T, hd), u (R, hd), S0
    and dS_fin (R, hd, hd) or None.  Each chunk is padded with zero rows to
    sub-blocks of ``sb`` rows, with sums of lw inside each (Cl inclusive, Cp
    exclusive, tot the sub-block's).  Pass 1 gives each chunk's G from
    ``r e^(b_{p-1} + Cp)``, ``e^tot`` and its du; pass 2 scans dS in
    reverse; pass 3 gives each chunk's gradients: A off the diagonal
    sub-blocks as ``Rq diag(e^(b_{p-1} - b_q)) Kq^T``, dr' and dk' by Horner
    over the sub-blocks (times ``e^Cp`` and ``e^(tot_q - Cl)``), one
    exponential per pair on the diagonal sub-blocks, dlw from
    ``rowsum(S_out dS)``.  Returns ``(dr, dk, dv, dlw, du, dS0)``."""
    R, T, hd = r.shape
    c = min(chunk, T)
    N, cp = T // c, -(-c // sb) * sb
    nsb = cp // sb
    S = torch.zeros((R, hd, hd)) if S0 is None else S0
    states = []
    for n in range(N):  # the forward's entry states, then the final one
        states.append(S)
        _, S = _wkv_chunk(*(x[:, n * c:(n + 1) * c, None] for x in (r, k, v, lw)), u, S[:, None])
        S = S[:, 0]
    states.append(S)

    def pad(x, n):  # chunk n as (R, nsb, sb, hd), zero rows past c
        out = torch.zeros((R, cp, hd))
        out[:, :c] = x[:, n * c:(n + 1) * c]
        return out.view(R, nsb, sb, hd)

    def sums(lc):
        Cl = torch.cumsum(lc, dim=2)
        return Cl, torch.cat([torch.zeros_like(Cl[:, :, :1]), Cl[:, :, :-1]], dim=2), Cl[:, :, -1]

    G, e_tot, du = [], [], torch.zeros((R, hd))
    for n in range(N):  # pass 1
        rc, kc, vc, lc, yc = (pad(x, n) for x in (r, k, v, lw, dy))
        Cl, Cp, tot = sums(lc)
        before = torch.stack([tot[:, :p].sum(1) for p in range(nsb)], 1)[:, :, None]
        G.append(torch.einsum("rpti,rptj->rij", rc * torch.exp(before + Cp), yc))
        e_tot.append(torch.exp(tot.sum(1)))
        du = du + torch.einsum("rpt,rpti->ri", torch.sum(yc * vc, -1), rc * kc)
    dS = torch.zeros((R, hd, hd)) if dS_fin is None else dS_fin
    dS_out = [None] * N
    for n in reversed(range(N)):  # pass 2
        dS_out[n] = dS
        dS = e_tot[n][:, :, None] * dS + G[n]
    grads = [torch.zeros((R, T, hd)) for _ in range(4)]
    lower = torch.tril(torch.ones(sb, sb, dtype=torch.bool), -1)[None, :, :, None]
    for n in range(N):  # pass 3
        rc, kc, vc, lc, yc = (pad(x, n) for x in (r, k, v, lw, dy))
        Cl, Cp, tot = sums(lc)
        ET = torch.exp(tot)
        Rq, Kq = rc * torch.exp(Cp), kc * torch.exp(tot[:, :, None] - Cl)
        F = torch.stack([torch.exp(tot[:, p + 1:].sum(1)) for p in range(nsb)], 1)
        Bm = torch.einsum("rpti,rqsi->rpqts", yc, vc)  # dy_t . v_s by sub-blocks
        A = torch.zeros((R, nsb, nsb, sb, sb))
        dec = [torch.where(lower, torch.exp(torch.clamp(Cp[:, p, :, None] - Cl[:, p, None], max=0.0)),
                           0.0) for p in range(nsb)]  # (R, t, s, hd), the diagonal sub-blocks
        for p in range(nsb):
            A[:, p, p] = (torch.einsum("rti,rsi,rtsi->rts", rc[:, p], kc[:, p], dec[p])
                          + torch.diag_embed(torch.sum(rc[:, p] * u[:, None] * kc[:, p], -1)))
            for q in range(p):
                g = torch.exp(tot[:, q + 1:p].sum(1))
                A[:, p, q] = torch.einsum("rti,ri,rsi->rts", Rq[:, p], g, Kq[:, q])
        dv = torch.stack([sum(torch.einsum("rts,rtj->rsj", A[:, p, q], yc[:, p]) for p in range(q, nsb))
                          + (Kq[:, q] * F[:, q, None]) @ dS_out[n] for q in range(nsb)], 1)
        drp, dkp = [], []
        for p in range(nsb):
            acc = yc[:, p] @ states[n].transpose(1, 2)
            for q in range(p):
                acc = acc * ET[:, q, None] + Bm[:, p, q] @ Kq[:, q]
            drp.append(acc * torch.exp(Cp[:, p])
                       + torch.einsum("rts,rsi,rtsi->rti", Bm[:, p, p], kc[:, p], dec[p]))
        for q in range(nsb):
            acc = vc[:, q] @ dS_out[n].transpose(1, 2)
            for p in reversed(range(q + 1, nsb)):
                acc = acc * ET[:, p, None] + Bm[:, p, q].transpose(1, 2) @ Rq[:, p]
            dkp.append(acc * torch.exp(tot[:, q, None] - Cl[:, q])
                       + torch.einsum("rts,rti,rtsi->rsi", Bm[:, q, q], rc[:, q], dec[q]))
        drp, dkp = torch.stack(drp, 1), torch.stack(dkp, 1)
        on_diag = torch.stack([torch.diagonal(Bm[:, p, p], dim1=-2, dim2=-1) for p in range(nsb)], 1)
        x, y = rc * drp, kc * dkp
        z = x - y
        zt = z.sum(2)  # (R, nsb, hd)
        later = torch.stack([zt[:, p + 1:].sum(1) for p in range(nsb)], 1)[:, :, None]
        after = torch.sum(z, dim=2, keepdim=True) - torch.cumsum(z, dim=2)
        base = torch.sum(states[n + 1] * dS_out[n], -1)[:, None, None]
        sl = slice(n * c, (n + 1) * c)
        for out, val in zip(grads, (drp + on_diag[..., None] * u[:, None, None] * kc,
                                    dkp + on_diag[..., None] * u[:, None, None] * rc, dv,
                                    base + later + after - y)):
            out[:, sl] = val.reshape(R, cp, hd)[:, :c]
    return (*grads, du, dS)


#: the model's decay clamp (models/rwkv.py), lw = -exp(clamp(., -8, 4))
CLAMP_ENDS = {"strong": -float(np.exp(4.0)), "weak": -float(np.exp(-8.0))}


@pytest.mark.parametrize("T,hd,chunk,decay", [
    (128, 64, 64, "model"),   # rwkv6-1.6b's head size and chunk, two chunks
    (74, 8, 37, "model"),     # ragged chunks: 37 rows padded to 48
    (48, 16, 16, "weak"),     # one sub-block a chunk
    (128, 32, 64, "strong"),  # every pair below f32's range but the nearest
], ids=["c64-hd64", "c37-hd8", "c16-weak", "c64-strong"])
def test_factored_backward_arithmetic_matches_plain(T, hd, chunk, decay):
    """The kernel's passes and factored sub-blocks, emulated in float32,
    against :func:`wkv_bwd_plain` in float64 on the same inputs (a given S0
    and dS_fin, a per-row bonus), each output within ``BWD_TOL["float32"]``
    relative L2.  At the strong end of the decay clamp the true dlw is
    below 1e-20 while the closed form's terms are O(1), so there dlw is held
    in absolute terms, within the same 1e-4 of its base term's norm
    (rowsum(S_fin dS_fin))."""
    B, H = 1, 2
    r, k, v, lw, u, S0, dy, dS_fin = bwd_check_inputs(B, T, H, hd, per_row_u=True, seed=4)
    if decay in CLAMP_ENDS:
        lw = torch.full_like(lw, CLAMP_ENDS[decay])

    def rows(x):
        return x.transpose(1, 2).reshape(B * H, T, hd)

    got = _factored_bwd(*(rows(x) for x in (r, k, v, lw)), u.reshape(B * H, hd), rows(dy),
                        chunk=chunk, S0=S0.reshape(B * H, hd, hd),
                        dS_fin=dS_fin.reshape(B * H, hd, hd))
    want = wkv_bwd_plain(*(t.double() for t in (r, k, v, lw, u, dy)), chunk=chunk,
                         S0=S0.double(), dS_fin=dS_fin.double())
    want = [rows(w) if w.dim() == 4 and w.shape[1] == T else w.reshape(got[i].shape)
            for i, w in enumerate(want)]
    tol = BWD_TOL["float32"]
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        if name == "dlw" and decay == "strong":
            S_fin = wkv_plain(r.double(), k.double(), v.double(), lw.double(), u.double(),
                              S0=S0.double(), chunk=chunk)[1]
            scale = torch.sum(S_fin * dS_fin.double(), -1).norm().item()
            assert (g.double() - w).norm().item() <= tol * scale, name
        else:
            assert _rel(g, w) <= tol, (name, _rel(g, w))
