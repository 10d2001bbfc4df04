"""Flash attention of the port: the plain version against the JAX Pallas
kernel (interpret mode), and the CUDA kernel against the plain version on
the card (``cuda``-marked, skipped without one).

Tolerances, stated, as ``tests/kernels/test_flash.py``: bf16
``rtol=atol=2e-2`` (outputs rounded to bf16 after an f32 softmax summed in
another order), f32 ``rtol=atol=2e-5`` (online softmax against one softmax
over the row: a few f32 ulps of the running sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention as j_attention
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels.flash_attention import attention, attention_plain, attention_ref

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _mk(b, hq, hkv, sq, skv, d, seed=0):
    """(B, H, S, D) f32 numpy q, k, v."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,bq,bkv",
    [
        (1, 2, 2, 32, 32, 16, 16, 16),  # MHA square
        (2, 4, 2, 64, 64, 32, 32, 16),  # GQA
        (1, 8, 1, 32, 64, 16, 16, 32),  # MQA, rectangular
        (1, 2, 2, 16, 16, 8, 16, 16),  # single block
        (2, 2, 2, 48, 96, 16, 16, 32),  # non-pow2 q blocks
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_pallas_kernel(dtype, b, hq, hkv, sq, skv, d, bq, bkv, causal):
    q, k, v = _mk(b, hq, hkv, sq, skv, d)
    jd, td = DTYPES[dtype]
    want = j_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), causal=causal,
                   block_q=bq, block_kv=bkv, interpret=True)
    got = attention_ref(*(torch.from_numpy(t).to(td) for t in (q, k, v)), causal=causal)
    assert got.dtype == td and tuple(got.shape) == (b, hq, sq, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def test_ops_wrapper_layout_matches_jax():
    """ops.attention takes (B, S, H, D) and matches the JAX wrapper."""
    q, k, v = (t.swapaxes(1, 2) for t in _mk(2, 4, 2, 32, 32, 16))
    want = j_attention(*(jnp.asarray(t) for t in (q, k, v)), causal=True, force_kernel=True,
                       interpret=True, block_q=16, block_kv=16)
    got = attention(*(torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v)), causal=True)
    assert tuple(got.shape) == (2, 32, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("sq,skv", [(64, 64), (96, 40), (8, 128)])
def test_fully_masked_blocks_are_finite(sq, skv):
    """Causal boundaries inside and across blocks (Sq > Skv leaves whole
    blocks of keys masked for the first rows) produce no NaN."""
    q, k, v = (torch.from_numpy(t) for t in _mk(1, 2, 1, sq, skv, 16, seed=3))
    out = attention_ref(q, k, v, causal=True)
    assert torch.isfinite(out).all()
    row0 = torch.softmax((q[:, :, :1] @ k.repeat_interleave(2, 1)[:, :, :1].mT) / 4.0, -1)
    torch.testing.assert_close(out[:, :, 0], (row0 @ v.repeat_interleave(2, 1)[:, :, :1])[:, :, 0])


def test_scale_argument():
    q, k, v = (torch.from_numpy(t) for t in _mk(1, 2, 2, 16, 16, 8, seed=4))
    torch.testing.assert_close(attention_ref(q, k, v, scale=0.5),
                               attention_ref(q * 0.5 / (8 ** -0.5), k, v))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 8, 32, 8, 128), (2, 100, 4, 4, 64), (1, 1000, 32, 8, 128),
                                   (1, 5, 2, 1, 64)])
def test_cuda_kernel_matches_plain_version(cuda, dtype, causal, shape):
    b, s, hq, hkv, d = shape
    g = torch.Generator(cuda).manual_seed(0)
    td = DTYPES[dtype][1]
    q = torch.randn((b, hq, s, d), generator=g, device=cuda).to(td).transpose(1, 2)  # strided
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=cuda).to(td) for _ in range(2))
    got = attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    assert got.is_contiguous() and got.dtype == td
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention(q, q, q)
