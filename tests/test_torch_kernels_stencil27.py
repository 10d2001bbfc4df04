"""27-point stencil of the port: plain version against the JAX Pallas kernel.

Tolerance, stated: the port's ``stencil27_ref`` rounds each product and
each sum separately (one multiply and one add per term, dz -> dy -> dx);
the Pallas interpreter's XLA CPU code may contract them into FMAs, which
moves each partial sum by up to an ulp of the running sum.  Over 27 terms
of unit-normal data that bounds the error near 27 * 2^-24 * sum|w*x|
(about 2e-5), whatever the size of the result after cancellation.  f32:
``rtol=1e-5, atol=1e-5`` (the JAX kernel's own test uses the same).
bf16 output: one bf16 ulp (``rtol=2**-7``) of the rounded result, plus
``atol=1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stencil27 import stencil27 as j_stencil27
from repro_torch.kernels.stencil27 import jacobi_weights, stencil27_ref, stencil_update

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2.0**-7, atol=1e-6)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tile", [
    ((8, 8, 16), (4, 4, 8)),
    ((6, 10, 12), (2, 5, 6)),
    ((4, 4, 4), (4, 4, 4)),
    ((16, 8, 32), (8, 8, 8)),
    ((1, 5, 7), (1, 5, 7)),    # a 1-cell-thick shell, ragged y and x
    ((3, 1, 130), (3, 1, 130)),  # thin in y, x not a multiple of any tile
])
def test_stencil27_ref_matches_pallas_kernel(dtype, shape, tile):
    rng = np.random.default_rng(0)
    x = rng.normal(size=tuple(s + 2 for s in shape)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = j_stencil27(jnp.asarray(x, jd), jnp.asarray(w), tile=tile, interpret=True)
    got = stencil27_ref(torch.from_numpy(x).to(td), torch.from_numpy(w))
    assert got.dtype == td and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def test_batched_over_ranks_equals_per_block():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 6, 7, 8)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 3, 3)).astype(np.float32))
    got = stencil27_ref(x, w)
    for r in range(3):
        assert torch.equal(got[r], stencil27_ref(x[r], w))


def test_jacobi_constant_field_is_fixed_point():
    x = torch.full((2, 10, 10, 10), 3.25)
    out = stencil_update(x, jacobi_weights())
    np.testing.assert_allclose(out.numpy(), 3.25, rtol=1e-6)


def test_identity_weights():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 8, 8, 8)).astype(np.float32))
    w = torch.zeros((3, 3, 3))
    w[1, 1, 1] = 1.0
    assert torch.equal(stencil_update(x, w), x[:, 1:-1, 1:-1, 1:-1])


def test_jacobi_weights_equal_jax():
    from repro.kernels.stencil27 import jacobi_weights as j_jacobi

    np.testing.assert_array_equal(jacobi_weights().numpy(), np.asarray(j_jacobi()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 10, 12, 9), (8, 3, 34, 40), (2, 35, 19, 70)])
def test_cuda_kernel_matches_plain_version(cuda, dtype, shape):
    g = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn((3, 3, 3), generator=g, device=cuda)
    got = stencil_update(x, w)
    want = stencil27_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(), **TOL[str(dtype).split(".")[1]])
