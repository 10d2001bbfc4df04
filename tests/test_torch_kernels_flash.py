"""Flash attention of the port: the plain version against the JAX Pallas
kernel (interpret mode), and the CUDA kernel against the plain version on
the card (``cuda``-marked, skipped without one).

Tolerances, stated, as ``tests/kernels/test_flash.py``: bf16
``rtol=atol=2e-2`` (outputs rounded to bf16 after an f32 softmax summed in
another order), f32 ``rtol=atol=2e-5`` (online softmax against one softmax
over the row: a few f32 ulps of the running sums).  The bf16 route of the
CUDA kernel runs both products on the tensor cores and rounds P to bf16
before P.V; :func:`_tensor_core_emulation` repeats that rounding in plain
PyTorch and is held to the Pallas kernel at the same bf16 tolerance.  On
the card that route is also held to ``REL_TOL`` in relative norm against
the plain version in f32 on the same inputs (``chip_smoke.py``'s
``FLASH_REL_TOL``), which the long causal rows' small values cannot hide in.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention as j_attention
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels.flash_attention import attention, attention_plain, attention_ref
from repro_torch.kernels.flash_attention.flash import check_rows_aligned

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
REL_TOL = 5e-3


@functools.cache
def _jitted(fn, **static):
    """``fn`` with its keyword arguments fixed, jitted once for the module
    with XLA's backend optimisation off, which about halves the compile of
    an interpret-mode kernel here."""
    return jax.jit(functools.partial(fn, **static),
                   compiler_options={"xla_backend_optimization_level": 0})


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
    want = _jitted(j_flash, causal=causal, block_q=bq, block_kv=bkv, interpret=True)(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd))
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


def _tensor_core_emulation(q, k, v, *, causal, tile=64):
    """The rounding of the CUDA kernel's bf16 route on (B, H, S, D) bf16
    tensors: f32 scores of the bf16 operands, an online softmax over tiles
    of ``tile`` keys in the log2 domain with f32 running max and sum, P
    rounded to bf16 before P.V (f32 accumulation), ``acc / max(l, 1e-30)``
    rounded to bf16.  Masked scores add exactly 0."""
    b, hq, sq, d = q.shape
    group, skv = hq // k.shape[1], k.shape[2]
    kf = k.repeat_interleave(group, 1).float()
    vf = v.repeat_interleave(group, 1)
    scale_log2 = np.float32(1.0 / np.sqrt(d)) * np.float32(np.log2(np.e))
    x = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * float(scale_log2)
    ok = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        ok = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, skv, tile):
        xt = x[..., k0:k0 + tile].masked_fill(~ok[:, k0:k0 + tile], -1e30)
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -1e30, 0.0, m_new)
        p = torch.exp2(xt - m_use)
        corr = torch.exp2(m - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                                        vf[:, :, k0:k0 + tile].float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,bq,bkv",
    [
        (2, 4, 2, 64, 64, 32, 32, 16),  # GQA
        (1, 8, 1, 32, 64, 16, 16, 32),  # MQA, rectangular
        (2, 2, 2, 48, 96, 16, 16, 32),  # ragged against the 64-key tile
        (1, 2, 1, 96, 40, 16, 16, 8),  # Sq > Skv: whole tiles masked for the first rows
        (1, 2, 1, 8, 128, 16, 8, 16),  # two 64-key tiles for 8 rows
    ],
)
def test_tensor_core_rounding_matches_pallas_kernel(b, hq, hkv, sq, skv, d, bq, bkv, causal):
    """P rounded to bf16 before P.V (the tensor-core route) stays within the
    bf16 tolerance of the Pallas kernel run in bf16."""
    q, k, v = _mk(b, hq, hkv, sq, skv, d, seed=5)
    want = _jitted(j_flash, causal=causal, block_q=bq, block_kv=bkv, interpret=True)(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    got = _tensor_core_emulation(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
                                 causal=causal)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL["bfloat16"])


def test_rows_aligned_check():
    """The tensor-core route's 16-byte row check: it passes the model's
    layouts (contiguous q/k/v, the transposed q of a (B, H, S, D) tensor, a
    cache slice) and raises on a misaligned base or row stride."""
    x = torch.zeros((2, 16, 4, 128), dtype=torch.bfloat16)
    cache = torch.zeros((3, 2, 32, 4, 64), dtype=torch.bfloat16)  # (layers, B, S, H, D)
    q_bhsd = torch.zeros((1, 8, 16, 64), dtype=torch.bfloat16)
    single = torch.zeros(80, dtype=torch.bfloat16).as_strided((1, 1, 1, 64), (7, 5, 3, 1))
    check_rows_aligned(x, cache[1, :, :16], q_bhsd.transpose(1, 2), single)
    with pytest.raises(ValueError, match="16-byte"):  # head stride of 66 bf16
        check_rows_aligned(torch.zeros((1, 4, 2, 66), dtype=torch.bfloat16)[..., :64])
    with pytest.raises(ValueError, match="16-byte"):  # base 2 bytes past a boundary
        check_rows_aligned(x.view(-1)[1:1 + 2 * 4 * 64].view(1, 2, 4, 64))
    with pytest.raises(ValueError, match="16-byte"):  # f32 head stride of 2 floats
        check_rows_aligned(torch.zeros(400).as_strided((1, 3, 4, 64), (0, 128, 2, 1)))


def test_scale_argument():
    q, k, v = (torch.from_numpy(t) for t in _mk(1, 2, 2, 16, 16, 8, seed=4))
    torch.testing.assert_close(attention_ref(q, k, v, scale=0.5),
                               attention_ref(q * 0.5 / (8 ** -0.5), k, v))


def test_every_config_head_dim_is_a_kernel_head_dim():
    """Every config that attends, at full width and ``reduced()``, has a head
    dim the CUDA kernel is instantiated for: on the card ``ops.attention``
    has no other route, so a missing one refuses the whole model there."""
    from repro_torch.configs.base import all_configs
    from repro_torch.kernels.flash_attention.flash import HEAD_DIMS
    dims = {(name, cfg.resolved_head_dim, cfg.reduced().resolved_head_dim)
            for name, cfg in all_configs().items() if cfg.n_heads}
    assert len(dims) == 9
    for name, full, reduced in dims:
        assert full in HEAD_DIMS and reduced in HEAD_DIMS, (name, full, reduced)
    assert {16, 32} <= set(HEAD_DIMS)  # the examples' widths (32) and reduced() (16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 8, 32, 8, 128), (2, 100, 4, 4, 64), (1, 1000, 32, 8, 128),
                                   (1, 5, 2, 1, 64),
                                   # the reduced configs' and the examples' head dims,
                                   # on the 64-wide tile zero-filled past D
                                   (2, 100, 4, 2, 16), (1, 300, 8, 4, 32), (8, 32, 4, 2, 16)])
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
@pytest.mark.parametrize("causal,b,sq,skv,hq,hkv,d", [
    (True, 1, 2048, 2048, 32, 8, 128),  # llama3-8b prefill, GQA 32/8
    (True, 1, 300, 100, 4, 2, 128),  # Sq > Skv: whole kv tiles masked for the first rows
    (False, 2, 77, 200, 4, 1, 64),  # ragged Sq and Skv, MQA
    (True, 1, 130, 190, 8, 8, 64),  # Sq < Skv: the mask crosses a ragged tile
    (True, 2, 512, 512, 8, 4, 32),  # the ring example's shape, GQA 8/4
    (False, 3, 77, 200, 4, 2, 16),  # reduced configs' head dim, ragged, GQA 4/2
    (True, 1, 2048, 2048, 4, 1, 16),  # long causal rows at D = 16, MQA
])
def test_cuda_tensor_core_route(cuda, causal, b, sq, skv, hq, hkv, d):
    """The bf16 (tensor-core) route against the plain version."""
    g = torch.Generator(cuda).manual_seed(1)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    got = attention(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL["bfloat16"])
    want32 = attention_plain(*(t.float() for t in (q, k, v)), causal=causal)
    assert ((got.float() - want32).norm() / want32.norm()).item() < REL_TOL


@pytest.mark.cuda
def test_cuda_kernel_refuses_misaligned_bf16_rows(cuda):
    q = torch.zeros((1, 8, 2, 66), dtype=torch.bfloat16, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        attention(q, q, q)


@pytest.mark.cuda
def test_cuda_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention(q, q, q)
