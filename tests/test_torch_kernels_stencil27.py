"""27-point stencil of the port: plain version against the JAX Pallas kernel.

Tolerance, stated: the port's ``stencil27_ref`` rounds each product and
each sum separately (one multiply and one add per term, dz -> dy -> dx);
the Pallas interpreter's XLA CPU code may contract them into FMAs, which
moves each partial sum by up to an ulp of the running sum.  Over 27 terms
of unit-normal data that bounds the error near 27 * 2^-24 * sum|w*x|
(about 2e-5), whatever the size of the result after cancellation.  f32:
``rtol=1e-5, atol=1e-5`` (the JAX kernel's own test uses the same).
bf16 output: one bf16 ulp (``rtol=2**-7``) of the rounded result, plus
``atol=1e-6``.  The Pallas kernel runs jitted once per shape and tile, with
XLA's backend optimisation off (:func:`_jitted`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stencil27 import stencil27 as j_stencil27
from repro_torch.kernels.stencil27 import jacobi_weights, stencil27_ref, stencil_update

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2.0**-7, atol=1e-6)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.cache
def _jitted(fn, **static):
    """``fn`` with its keyword arguments fixed, jitted once for the module
    with XLA's backend optimisation off, which about halves the compile of
    an interpret-mode kernel here."""
    return jax.jit(functools.partial(fn, **static),
                   compiler_options={"xla_backend_optimization_level": 0})


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
    want = _jitted(j_stencil27, tile=tile, interpret=True)(jnp.asarray(x, jd), jnp.asarray(w))
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tile", [
    ((4, 6, 8), (4, 6, 8)),   # a heat3d block: (R, Z+2, Y+2, X) updated in place
    ((1, 5, 7), (1, 5, 7)),   # a 1-cell z shell, ragged y and x
])
def test_stencil_update_into_strided_interior_equals_pallas_kernel(dtype, shape, tile):
    """``stencil_update(xp, w, out=view)`` on the CPU writes the JAX kernel's
    values (Pallas interpreter, same tolerance as above) into the interior
    window of a block whose x is not wrapped (heat3d's layout: ghosts on z
    and y, x whole), and leaves every ghost cell as it was."""
    rng = np.random.default_rng(3)
    z, y, x = shape
    xp = rng.normal(size=(2, z + 2, y + 2, x + 2)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3)).astype(np.float32)
    jd, td = DTYPES[dtype]
    block = torch.full((2, z + 2, y + 2, x), -7.0, dtype=td)
    view = block[:, 1:-1, 1:-1, :]
    assert not view.is_contiguous()
    got = stencil_update(torch.from_numpy(xp).to(td), torch.from_numpy(w), out=view)
    assert got.data_ptr() == view.data_ptr()
    for r in range(2):
        want = _jitted(j_stencil27, tile=tile, interpret=True)(jnp.asarray(xp[r], jd),
                                                                jnp.asarray(w))
        np.testing.assert_allclose(block[r, 1:-1, 1:-1].float().numpy(),
                                   np.asarray(want, np.float32), **TOL[dtype])
    ghosts = block.clone()
    ghosts[:, 1:-1, 1:-1, :] = -7.0
    assert bool((ghosts == -7.0).all())


@pytest.mark.parametrize("shape,want", [
    ((8, 256, 512, 512), (256, 8)),  # heat3d: 8 x 16 tiles x 8 ranks, a whole Z each
    ((8, 1, 512, 512), (1, 8)),      # the overlap schedule's z shell: nothing to split
    ((8, 256, 1, 512), (32, 64)),    # its y shell: 128 tiles, Z cut into 8 marches
    ((2, 40, 30, 30), (20, 4)),      # Z cut, but no march below MIN_MARCH
    ((1, 5, 10, 10), (5, 1)),        # Z shorter than MIN_MARCH
    ((70000, 1, 1, 2), (1, 65535)),  # more ranks than the grid's z: the kernel loops
])
def test_march_gives_the_card_enough_blocks(shape, want):
    """The z march and grid of the CUDA launch (host side, no card needed)."""
    from repro_torch.kernels.stencil27.stencil27 import march

    assert march(*shape) == want


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "heat3d interior", "z shell", "y shell", "Z below the march", "odd x", "grid limit",
])
def test_cuda_kernel_strided_out_and_edges(cuda, dtype, case):
    """The kernel against ``stencil27_ref`` on the card, bitwise (separate
    rounded multiply and add in the reference's order): into the interior
    window of a heat3d-layout block (strided, ghosts untouched), the overlap
    schedule's 3-cell z and y shells, a Z shorter than any march, rows of
    odd length (one element a copy), and more ranks than the grid's 65535."""
    from repro_torch.kernels.stencil27.stencil27 import march

    g = torch.Generator(cuda).manual_seed(1)
    shape = {"heat3d interior": (8, 34, 70, 66), "z shell": (8, 3, 70, 66),
             "y shell": (8, 34, 3, 66), "Z below the march": (4, 5, 40, 38),
             "odd x": (3, 20, 40, 37), "grid limit": (70000, 3, 3, 4)}[case]
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn((3, 3, 3), generator=g, device=cuda)
    want = stencil27_ref(x, w)
    if case == "heat3d interior":
        block = torch.full((shape[0], shape[1], shape[2], shape[3] - 2), -7.0, dtype=dtype,
                           device=cuda)
        got = stencil_update(x, w, out=block[:, 1:-1, 1:-1, :])
        assert torch.equal(got, want)
        block[:, 1:-1, 1:-1, :] = -7.0
        assert bool((block == -7.0).all())
    else:
        assert torch.equal(stencil_update(x, w), want)
    if case == "grid limit":
        assert march(*want.shape)[1] == 65535
