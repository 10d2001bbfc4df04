"""WKV chunk scan of the port: the plain version against the JAX oracle and
the JAX Pallas kernel (interpret mode), the model-layout wrapper against the
JAX model's ``wkv_scan`` (state in and out included), and the CUDA kernel
against the plain version on the card (``cuda``-marked, skipped without
one).

Tolerances, stated, as ``tests/kernels/test_wkv.py``: f32
``rtol=atol=3e-4`` (cumulative sums and the three products are summed in
other orders; the decays multiply the differences by up to exp(0) = 1), bf16
``rtol=atol=5e-2`` (f32 arithmetic on bf16 inputs, the output rounded to
bf16).
"""

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
    for want in (j_wkv_chunked_ref(*map(jnp.asarray, inputs), chunk=chunk),
                 j_wkv_chunked(*map(jnp.asarray, inputs), chunk=chunk, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("bh,T,hd,chunk", SHAPES)
def test_model_layout_wkv_matches_pallas_kernel(bh, T, hd, chunk):
    """``ops.wkv`` on the rows as batch entries of one head each, with the
    per-row bonus (B, H, hd), against the Pallas kernel."""
    r, k, v, lw, u = _mk(bh, T, hd, seed=5)
    want = j_wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)), chunk=chunk, interpret=True)
    y, S = wkv(*(t[:, :, None] for t in _t(r, k, v, lw)), torch.from_numpy(u), chunk=chunk)
    assert tuple(S.shape) == (bh, 1, hd, hd)
    np.testing.assert_allclose(y[:, :, 0].numpy(), np.asarray(want), **TOL["float32"])


def test_ref_bf16_matches_pallas_kernel():
    inputs = [jnp.asarray(a, jnp.bfloat16) for a in _mk(2, 32, 16, seed=1)]
    want = j_wkv_chunked(*inputs, chunk=8, interpret=True)
    got = wkv_chunked_ref(*_t(*_mk(2, 32, 16, seed=1), dtype=torch.bfloat16), chunk=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL["bfloat16"])


def test_model_layout_wrapper_matches_jax():
    """``ops.wkv`` on (B, T, H, hd) with a per-head u against the JAX
    wrapper (Pallas kernel, interpret) and the JAX model's ``wkv_scan``."""
    inputs = _mk_model(2, 16, 3, 8)
    got, S = wkv(*_t(*inputs), chunk=8)
    want_k = j_wkv(*map(jnp.asarray, inputs), chunk=8, force_kernel=True, interpret=True)
    want_y, want_S = j_wkv_scan(*map(jnp.asarray, inputs), chunk=8)
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
    want_y, want_S = j_wkv_scan(*map(jnp.asarray, inputs), jnp.asarray(S0), chunk=chunk)
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
    want = j_wkv_chunked(*map(jnp.asarray, (r, k, v, lw, u)), chunk=8, interpret=True)
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
    x = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wkv(x, x, x, x, torch.zeros((1, 8), device="meta"), chunk=4)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_chunked(x, x, x, x, torch.zeros((2, 16)), chunk=8)


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
