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
from repro_torch.kernels.wkv.ref import bwd_check_inputs

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
