"""WKV chunk scan of the port: the plain version against the JAX oracle and
the JAX Pallas kernel (interpret mode), the model-layout wrapper against the
JAX model's ``wkv_scan`` (state in and out included), a float32 emulation
of the CUDA kernel's factored sub-block arithmetic against both JAX
functions, and the CUDA kernel against the plain version on the card
(``cuda``-marked, skipped without one; at the decay clamp's ends against
the plain version in float64, whose float32 run rounds cum - lw by more
than the tolerance there).

Tolerances, stated, as ``tests/kernels/test_wkv.py``: f32
``rtol=atol=3e-4`` (cumulative sums and the three products are summed in
other orders; the decays multiply the differences by up to exp(0) = 1), bf16
``rtol=atol=5e-2`` (f32 arithmetic on bf16 inputs, the output rounded to
bf16).

The JAX functions run jitted, once per shape and static arguments
(:func:`_jitted`): run eagerly, their scans and interpret-mode kernels
compile again on every call.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import wkv as j_wkv
from repro.kernels.wkv import wkv_chunked as j_wkv_chunked
from repro.kernels.wkv import wkv_chunked_ref as j_wkv_chunked_ref
from repro.models.rwkv import wkv_scan as j_wkv_scan
from repro_torch.kernels.wkv import wkv, wkv_chunked, wkv_chunked_ref, wkv_plain

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=3e-4, atol=3e-4), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
SHAPES = [
    (2, 32, 8, 8),
    (4, 16, 16, 16),  # single chunk
    (1, 64, 8, 4),  # many chunks
    (3, 48, 32, 16),
]


@functools.cache
def _jitted(fn, **static):
    """``fn`` with its keyword arguments fixed, jitted once for the module
    (the cases of one shape share one compile) with XLA's backend
    optimisation off, which about halves a compile here."""
    return jax.jit(functools.partial(fn, **static),
                   compiler_options={"xla_backend_optimization_level": 0})


def _mk(bh, T, hd, seed=0):
    """The JAX kernel test's inputs, f32 numpy: r, k, v, lw (< 0), u (BH, 1, hd)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(bh, T, hd)).astype(np.float32) for _ in range(3))
    lw = (-np.abs(rng.normal(size=(bh, T, hd))) - 0.05).astype(np.float32)
    u = (rng.normal(size=(bh, 1, hd)) * 0.3).astype(np.float32)
    return r, k, v, lw, u


def _mk_model(B, T, H, hd, seed=2):
    """Model-layout f32 numpy: r, k, v, lw (B, T, H, hd), u (H, hd)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, hd)).astype(np.float32) for _ in range(3))
    lw = (-np.abs(rng.normal(size=(B, T, H, hd))) - 0.05).astype(np.float32)
    u = (rng.normal(size=(H, hd)) * 0.3).astype(np.float32)
    return r, k, v, lw, u


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("bh,T,hd,chunk", SHAPES)
def test_ref_matches_jax_ref_and_pallas_kernel(bh, T, hd, chunk):
    inputs = _mk(bh, T, hd)
    got = wkv_chunked_ref(*_t(*inputs), chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bh, T, hd)
    for want in (_jitted(j_wkv_chunked_ref, chunk=chunk)(*map(jnp.asarray, inputs)),
                 _jitted(j_wkv_chunked, chunk=chunk, interpret=True)(*map(jnp.asarray, inputs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("bh,T,hd,chunk", SHAPES)
def test_model_layout_wkv_matches_pallas_kernel(bh, T, hd, chunk):
    """``ops.wkv`` on the rows as batch entries of one head each, with the
    per-row bonus (B, H, hd), against the Pallas kernel."""
    r, k, v, lw, u = _mk(bh, T, hd, seed=5)
    want = _jitted(j_wkv_chunked, chunk=chunk, interpret=True)(*map(jnp.asarray, (r, k, v, lw, u)))
    y, S = wkv(*(t[:, :, None] for t in _t(r, k, v, lw)), torch.from_numpy(u), chunk=chunk)
    assert tuple(S.shape) == (bh, 1, hd, hd)
    np.testing.assert_allclose(y[:, :, 0].numpy(), np.asarray(want), **TOL["float32"])


def test_ref_bf16_matches_pallas_kernel():
    inputs = [jnp.asarray(a, jnp.bfloat16) for a in _mk(2, 32, 16, seed=1)]
    want = _jitted(j_wkv_chunked, chunk=8, interpret=True)(*inputs)
    got = wkv_chunked_ref(*_t(*_mk(2, 32, 16, seed=1), dtype=torch.bfloat16), chunk=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL["bfloat16"])


def test_model_layout_wrapper_matches_jax():
    """``ops.wkv`` on (B, T, H, hd) with a per-head u against the JAX
    wrapper (Pallas kernel, interpret) and the JAX model's ``wkv_scan``."""
    inputs = _mk_model(2, 16, 3, 8)
    got, S = wkv(*_t(*inputs), chunk=8)
    want_k = _jitted(j_wkv, chunk=8, force_kernel=True, interpret=True)(*map(jnp.asarray, inputs))
    want_y, want_S = _jitted(j_wkv_scan, chunk=8)(*map(jnp.asarray, inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want_y), **TOL["float32"])
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S), **TOL["float32"])


@pytest.mark.parametrize("T,chunk", [(32, 8), (12, 64), (1, 64)])
def test_given_state_and_final_state_match_wkv_scan(T, chunk):
    """Starting from a given S0 (decode: T = 1), y and S_fin equal the JAX
    scan's, and the state carries: two halves equal the whole."""
    inputs = _mk_model(2, T, 4, 16, seed=7)
    S0 = np.random.default_rng(8).normal(size=(2, 4, 16, 16)).astype(np.float32)
    got, S = wkv(*_t(*inputs), chunk=chunk, S0=torch.from_numpy(S0))
    want_y, want_S = _jitted(j_wkv_scan, chunk=chunk)(*map(jnp.asarray, inputs), jnp.asarray(S0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_y), **TOL["float32"])
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S), **TOL["float32"])
    if T % 2 == 0 and T > 1:
        h = T // 2
        ts = _t(*inputs)
        y1, S1 = wkv(*(t[:, :h] for t in ts[:4]), ts[4], chunk=chunk, S0=torch.from_numpy(S0))
        y2, S2 = wkv(*(t[:, h:] for t in ts[:4]), ts[4], chunk=chunk, S0=S1)
        np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), got.numpy(), **TOL["float32"])
        np.testing.assert_allclose(S2.numpy(), S.numpy(), **TOL["float32"])


def test_strong_decay_stable():
    r, k, v, lw, u = _mk(1, 32, 8, seed=3)
    lw = np.full_like(lw, -12.0)
    want = _jitted(j_wkv_chunked, chunk=8, interpret=True)(*map(jnp.asarray, (r, k, v, lw, u)))
    got = wkv_chunked_ref(*_t(r, k, v, lw, u), chunk=8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_length_not_a_multiple_of_the_chunk_raises_like_jax():
    """The reference's quirk, matched: T above the chunk must be a multiple
    of it (T = 100 with chunk 64 raises in both packages)."""
    inputs = _mk_model(1, 100, 2, 8)
    with pytest.raises(AssertionError):
        j_wkv_scan(*map(jnp.asarray, inputs), chunk=64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv(*_t(*inputs), chunk=64)


def test_wkv_refuses_other_devices():
    # meta is the kernels' dry-run route (shapes and dtypes, no launch); any
    # device but the CPU, CUDA and meta is refused
    x = torch.zeros((1, 4, 1, 8), device="meta")
    y, S = wkv(x, x, x, x, torch.zeros((1, 8), device="meta"), chunk=4)
    assert (y.shape, y.device.type, S.shape, S.dtype) == (x.shape, "meta", (1, 1, 8, 8),
                                                           torch.float32)
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        wkv(other, x, x, x, x, chunk=4)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_chunked(x, x, x, x, torch.zeros((2, 16)), chunk=8)


# the model's decay clamp (models/rwkv.py): lw = -exp(clamp(., -8, 4))
CLAMP_ENDS = {"strong": -float(np.exp(4.0)), "weak": -float(np.exp(-8.0))}


def _factored_wkv(r, k, v, lw, u, *, chunk, S0=None, sb=16):
    """Plain float32 emulation of the CUDA kernel's per-chunk arithmetic
    (``csrc/wkv.cu``): rows r, k, v, lw (R, T, hd), u (R, hd), S0 (R, hd,
    hd).  Each chunk is padded with zero rows to sub-blocks of ``sb`` rows;
    sums of lw are taken inside each sub-block (Cl inclusive, Cp exclusive,
    tot the sub-block's); off-diagonal sub-blocks of A are the three-factor
    product (r e^Cp) diag(e^{b_{p-1} - b_q}) (k e^{tot - Cl})^T, diagonal
    ones take exp(min(Cp_t - Cl_s, 0)) per pair plus the bonus; the state
    term and update reuse the factors.  Returns (y (R, T, hd), S (R, hd, hd))."""
    R, T, hd = r.shape
    c = min(chunk, T)
    S = torch.zeros((R, hd, hd)) if S0 is None else S0.clone()
    ys = []
    for t0 in range(0, T, c):
        cp = -(-c // sb) * sb
        nsb = cp // sb

        def pad(x):
            out = torch.zeros((R, cp, hd))
            out[:, :c] = x[:, t0:t0 + c]
            return out.view(R, nsb, sb, hd)

        rc, kc, vc, lc = pad(r), pad(k), pad(v), pad(lw)
        Cl = torch.cumsum(lc, dim=2)
        Cp = torch.cat([torch.zeros_like(Cl[:, :, :1]), Cl[:, :, :-1]], dim=2)
        tot = Cl[:, :, -1]  # (R, nsb, hd)
        Rq = rc * torch.exp(Cp)
        Kq = kc * torch.exp(tot[:, :, None] - Cl)
        # b_{p-1} and cum_T - b_p, summed directly (no difference of large sums)
        before = torch.stack([tot[:, :p].sum(1) for p in range(nsb)], 1)
        after = torch.stack([tot[:, p + 1:].sum(1) for p in range(nsb)], 1)
        A = torch.zeros((R, cp, cp))
        lower = torch.tril(torch.ones(sb, sb, dtype=torch.bool), -1)[None, :, :, None]
        for p in range(nsb):
            pair = Cp[:, p, :, None] - Cl[:, p, None, :]  # (R, t, s, hd)
            D = torch.where(lower, torch.exp(torch.clamp(pair, max=0.0)), 0.0)
            blk = torch.einsum("rti,rsi,rtsi->rts", rc[:, p], kc[:, p], D)
            blk = blk + torch.diag_embed(torch.sum(rc[:, p] * u[:, None] * kc[:, p], -1))
            A[:, p * sb:(p + 1) * sb, p * sb:(p + 1) * sb] = blk
            for q in range(p):
                g = torch.exp(tot[:, q + 1:p].sum(1))  # e^{b_{p-1} - b_q}, exponent <= 0
                A[:, p * sb:(p + 1) * sb, q * sb:(q + 1) * sb] = torch.einsum(
                    "rti,ri,rsi->rts", Rq[:, p], g, Kq[:, q])
        rdec = (Rq * torch.exp(before)[:, :, None]).reshape(R, cp, hd)
        vf = vc.reshape(R, cp, hd)
        y = torch.einsum("rti,rij->rtj", rdec, S) + torch.einsum("rts,rsj->rtj", A, vf)
        ys.append(y[:, :c])
        upd = torch.einsum("rpsi,rpsj->rpij", Kq, vc)  # per sub-block
        S = torch.exp(tot.sum(1))[:, :, None] * S + torch.sum(torch.exp(after)[..., None] * upd, 1)
    return torch.cat(ys, dim=1), S


FACTORED_CASES = [("strong", False), ("strong", True), ("weak", False), ("weak", True),
                  ("model", True)]


def _factored_inputs(c, hd, decay, with_state):
    """One case's f32 numpy inputs (1, T, 2, hd) over two chunks of c: lw
    at either end of the model's decay clamp, or the model's random decays
    -exp(N(-1, 0.5)); S0 (1, 2, hd, hd) or None."""
    H, T = 2, (4 if c == 1 else 2 * c)
    rng = np.random.default_rng(c * 100 + hd)
    r, k, v = (rng.normal(size=(1, T, H, hd)).astype(np.float32) for _ in range(3))
    lw = (np.full((1, T, H, hd), CLAMP_ENDS[decay], np.float32) if decay in CLAMP_ENDS else
          -np.exp(rng.normal(-1.0, 0.5, size=(1, T, H, hd))).astype(np.float32))
    u = (rng.normal(size=(H, hd)) * 0.3).astype(np.float32)
    S0 = rng.normal(size=(1, H, hd, hd)).astype(np.float32) if with_state else None
    return r, k, v, lw, u, S0


@functools.cache
def _factored_refs(c, hd):
    """The JAX references of every case of :data:`FACTORED_CASES` at (c,
    hd), one compile each: ``wkv_scan`` over the cases' heads side by side
    (heads are independent; a missing S0 is the zeros JAX's scan starts
    from) and the Pallas kernel over the zero-state cases' rows stacked.
    Returns {case: (y (1, T, 2, hd), S (1, 2, hd, hd), y_kernel (2, T, hd)
    or None)}."""
    cases = [_factored_inputs(c, hd, *case) for case in FACTORED_CASES]
    cat = [np.concatenate([x[i] for x in cases], axis=2) for i in range(4)]
    u = np.concatenate([x[4] for x in cases], axis=0)
    S0 = np.concatenate([x[5] if x[5] is not None else np.zeros((1, 2, hd, hd), np.float32)
                         for x in cases], axis=1)
    y, S = map(np.asarray, _jitted(j_wkv_scan, chunk=c)(*map(jnp.asarray, (*cat, u, S0))))
    zero = [i for i, (_, with_state) in enumerate(FACTORED_CASES) if not with_state]
    rows = [np.concatenate([cases[i][j][0].transpose(1, 0, 2) for i in zero]) for j in range(4)]
    yk = np.asarray(_jitted(j_wkv_chunked, chunk=c, interpret=True)(
        *map(jnp.asarray, rows), jnp.asarray(np.concatenate([cases[i][4][:, None] for i in zero]))))
    out = {}
    for i, case in enumerate(FACTORED_CASES):
        h = slice(2 * i, 2 * i + 2)
        out[case] = (y[:, :, h], S[:, h],
                     yk[2 * zero.index(i):2 * zero.index(i) + 2] if i in zero else None)
    return out


@pytest.mark.parametrize("decay,with_state", FACTORED_CASES,
                         ids=["strong-zeros", "strong-S0", "weak-zeros", "weak-S0", "model-S0"])
@pytest.mark.parametrize("hd", [8, 64])
@pytest.mark.parametrize("c", [1, 5, 12, 16, 17, 37, 64])
def test_factored_chunk_arithmetic_matches_pallas_kernel_and_wkv_scan(c, hd, decay, with_state):
    """The kernel's factored sub-block arithmetic, emulated in float32,
    against the JAX Pallas kernel (interpret) and the JAX model's
    ``wkv_scan`` (given state), over two chunks of c: lw at either end of
    the model's decay clamp, or the model's random decays
    -exp(N(-1, 0.5)).  The JAX side runs the five decay cases of one (c,
    hd) in one call (:func:`_factored_refs`)."""
    r, k, v, lw, u, S0 = _factored_inputs(c, hd, decay, with_state)
    rows = [torch.from_numpy(x[0].transpose(1, 0, 2).copy()) for x in (r, k, v, lw)]
    y, S = _factored_wkv(*rows, torch.from_numpy(u), chunk=c,
                         S0=None if S0 is None else torch.from_numpy(S0[0]))
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    want_y, want_S, want_k = _factored_refs(c, hd)[decay, with_state]
    np.testing.assert_allclose(y.numpy(), want_y[0].transpose(1, 0, 2), **TOL["float32"])
    np.testing.assert_allclose(S.numpy(), want_S[0], **TOL["float32"])
    if S0 is None:
        np.testing.assert_allclose(y.numpy(), want_k, **TOL["float32"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,hd,chunk,with_state", [
    (1, 128, 32, 64, 64, False),  # rwkv6-1.6b prefill, two chunks
    (1, 5, 32, 64, 64, False),  # a chunk of 5
    (4, 1, 32, 64, 64, True),  # decode
    (2, 48, 3, 32, 16, True),
    (1, 64, 2, 8, 4, False),
    (3, 12, 4, 16, 64, True),
])
def test_cuda_kernel_matches_plain_version(cuda, dtype, B, T, H, hd, chunk, with_state):
    td = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(0)
    r, k, v = (torch.randn((B, T, H, hd), generator=g, device=cuda).to(td) for _ in range(3))
    lw = (-torch.rand((B, T, H, hd), generator=g, device=cuda) * 2 - 0.05).to(td)
    u = (torch.randn((H, hd), generator=g, device=cuda) * 0.3).to(td)
    S0 = torch.randn((B, H, hd, hd), generator=g, device=cuda) if with_state else None
    y, S = wkv_chunked(r, k, v, lw, u, chunk=chunk, S0=S0)
    want_y, want_S = wkv_plain(r.float(), k.float(), v.float(), lw.float(), u.float(),
                               chunk=chunk, S0=S0)
    assert y.dtype == td and y.is_contiguous() and S.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(S).all()
    torch.testing.assert_close(y.float(), want_y.to(td).float(), **TOL[dtype])
    torch.testing.assert_close(S, want_S, **TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_per_row_bonus_and_strided_inputs(cuda):
    """The JAX kernel's (BH, T, hd) signature as rows of one head with a
    per-row u, and a non-contiguous (B, T, H, hd) view."""
    r, k, v, lw, u = (torch.from_numpy(a).to(cuda) for a in _mk(3, 48, 32))
    y, _ = wkv_chunked(r[:, :, None], k[:, :, None], v[:, :, None], lw[:, :, None], u, chunk=16)
    torch.testing.assert_close(y[:, :, 0], wkv_chunked_ref(r, k, v, lw, u, chunk=16),
                               **TOL["float32"])
    rs = r.view(3, 48, 2, 16).transpose(0, 1).contiguous().transpose(0, 1)  # strided
    ks, vs, ls = (t.reshape(3, 48, 2, 16) for t in (k, v, lw))
    uh = u[0, 0].reshape(2, 16)
    y, S = wkv_chunked(rs, ks, vs, ls, uh, chunk=16)
    want_y, want_S = wkv_plain(rs, ks, vs, ls, uh, chunk=16)
    torch.testing.assert_close(y, want_y, **TOL["float32"])
    torch.testing.assert_close(S, want_S, **TOL["float32"])


@pytest.mark.cuda
def test_cuda_kernel_strong_decay_is_finite(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    r, k, v = (torch.randn((1, 128, 32, 64), generator=g, device=cuda) for _ in range(3))
    lw = torch.full_like(r, -12.0)
    u = torch.randn((32, 64), generator=g, device=cuda) * 0.3
    y, S = wkv_chunked(r, k, v, lw, u, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    want_y, want_S = wkv_plain(r, k, v, lw, u, chunk=64)
    torch.testing.assert_close(y, want_y, **TOL["float32"])
    torch.testing.assert_close(S, want_S, **TOL["float32"])


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 100, 2, 64), device=cuda)
    u = torch.zeros((2, 64), device=cuda)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv_chunked(x, x, x, x, u, chunk=64)
    y = torch.zeros((1, 8, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        wkv_chunked(y, y, y, y, torch.zeros((2, 128), device=cuda), chunk=8)
    with pytest.raises(ValueError, match="above the kernel"):
        wkv_chunked(x[:, :96], x[:, :96], x[:, :96], x[:, :96], u, chunk=96)


def _cuda_inputs(dev, B, T, H, hd, *, seed=0, dtype=torch.float32, state=False, lw_value=None):
    g = torch.Generator(dev).manual_seed(seed)
    r, k, v = (torch.randn((B, T, H, hd), generator=g, device=dev) for _ in range(3))
    lw = (torch.full_like(r, lw_value) if lw_value is not None else
          -torch.exp(torch.randn((B, T, H, hd), generator=g, device=dev) * 0.5 - 1.0))
    u = torch.randn((H, hd), generator=g, device=dev) * 0.3
    S0 = torch.randn((B, H, hd, hd), generator=g, device=dev) if state else None
    return [t.to(dtype) for t in (r, k, v, lw, u)], S0


def _check_against_plain(args, S0, chunk, dtype="float32", plain=torch.float32):
    """The kernel against ``wkv_plain`` run in ``plain`` (float64 where the
    float32 plain version's own rounding is above the tolerance)."""
    y, S = wkv_chunked(*args, chunk=chunk, S0=S0)
    want_y, want_S = wkv_plain(*(t.to(plain) for t in args), chunk=chunk,
                               S0=None if S0 is None else S0.to(plain))
    assert torch.isfinite(y.float()).all() and torch.isfinite(S).all()
    torch.testing.assert_close(y.float(), want_y.float().to(y.dtype).float(), **TOL[dtype])
    torch.testing.assert_close(S, want_S.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("c", [1, 5, 17, 37, 64])
def test_cuda_factored_kernel_ragged_chunks(cuda, c, hd, B):
    """Ragged chunks (padded to 16-row sub-blocks), every head size, at
    batch 1 and 4 (A shared by a pair of CTAs of a head where hd >= 32),
    two chunks, a given state at batch 4; c = 1 is the decode route over
    three tokens."""
    args, S0 = _cuda_inputs(cuda, B, 3 if c == 1 else 2 * c, 3, hd, seed=c + hd, state=B == 4)
    _check_against_plain(args, S0, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 3])
def test_cuda_decode_route_with_state(cuda, dtype, T):
    """The c = 1 route at rwkv6-1.6b's decode shape, batch 4, from a state."""
    args, S0 = _cuda_inputs(cuda, 4, T, 32, 64, seed=T, dtype=getattr(torch, dtype), state=True)
    _check_against_plain(args, S0, 1, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 37])
def test_cuda_kernel_per_row_bonus_misaligned_strides(cuda, chunk):
    """A per-row u (B, H, hd) and inputs whose rows are not 16-byte aligned
    (the plain-load staging path): views of (B, T, H, hd + 1) tensors."""
    g = torch.Generator(cuda).manual_seed(3)
    B, T, H, hd = 2, 74 if chunk == 37 else 3, 3, 32
    r, k, v = (torch.randn((B, T, H, hd + 1), generator=g, device=cuda)[..., 1:] for _ in range(3))
    lw = -torch.exp(torch.randn((B, T, H, hd + 1), generator=g, device=cuda) - 1.0)[..., :hd]
    u = torch.randn((B, H, hd), generator=g, device=cuda) * 0.3
    S0 = torch.randn((B, H, hd, hd), generator=g, device=cuda)
    assert r.stride(1) % 4 and r.data_ptr() % 16
    _check_against_plain((r, k, v, lw, u), S0, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ends", sorted(CLAMP_ENDS))
def test_cuda_kernel_at_the_decay_clamp_ends(cuda, ends, dtype):
    """lw = -exp(4) and -exp(-8) everywhere, the model's clamp ends: finite
    and within tolerance, prefill and decode.  Held against the plain
    version in float64: at lw = -exp(4) a 64-row sum of log decays reaches
    -3494, where float32's cum - lw (the plain version's cum_prev) is off
    from the previous row's sum by ulps of 2.4e-4, and the kernel's sums
    inside 16-row sub-blocks are not."""
    for B, T, chunk, state in ((1, 128, 64, False), (4, 1, 64, True), (2, 74, 37, True)):
        args, S0 = _cuda_inputs(cuda, B, T, 32, 64, dtype=getattr(torch, dtype), state=state,
                                lw_value=CLAMP_ENDS[ends])
        _check_against_plain(args, S0, chunk, dtype, plain=torch.float64)

