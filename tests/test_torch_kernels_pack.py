"""Pack kernels of the port: plain versions against the JAX Pallas kernels.

The port's ``pack_2d_ref``/``unpack_2d_ref``/``gather_pack_ref`` are held
BITWISE to JAX ``pack_2d``/``unpack_2d``/``gather_pack_1d`` run in the
Pallas interpreter, on the shapes of ``tests/kernels/test_pack.py`` and on
the coalesced wire layouts of real halo schedules, with f32 and bf16 wire
and scale 1 and 8.  The dispatching ``ops`` wrappers on CPU tensors are the
plain versions.  The CUDA kernels themselves are held to the plain versions
on the card (``cuda`` marker; ``chip_smoke.py`` does the same at full size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.halo import HaloSpec as JHaloSpec
from repro.core.halo import fused_slab_table, sequential_message_groups as j_seq
from repro.core.transport import get_packer as j_get_packer, schedule_layouts as j_layouts
from repro.kernels.pack import gather_pack_1d, pack_2d, unpack_2d
from repro_torch.kernels.pack import (
    gather_pack,
    gather_pack_ref,
    pack_2d_ref,
    pack_slab,
    unpack_2d_ref,
    unpack_slab,
)

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype_in,dtype_out", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
])
@pytest.mark.parametrize("shape,blocks", [
    ((64, 128), (32, 64)),
    ((17, 130), (16, 64)),   # the TPU kernel's padding path
    ((1, 256), (8, 128)),
    ((300, 7), (64, 8)),
])
def test_pack_2d_ref_equals_pallas_kernel(dtype_in, dtype_out, shape, blocks):
    data = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = pack_2d(jnp.asarray(data, DTYPES[dtype_in][0]), out_dtype=DTYPES[dtype_out][0],
                   block_lead=blocks[0], block_lane=blocks[1], interpret=True)
    got = pack_2d_ref(torch.from_numpy(data).to(DTYPES[dtype_in][1]),
                      out_dtype=DTYPES[dtype_out][1])
    assert got.dtype == DTYPES[dtype_out][1] and tuple(got.shape) == shape
    np.testing.assert_array_equal(_np32(got), _np32(want))


@pytest.mark.parametrize("scale", [1.0, 8.0, 3.0])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_pack_unpack_scale_equals_pallas_kernel(scale, wire):
    """Scaled pack to the wire and the ``1/scale`` unpack back to f32: the
    f32 rounding of ``1/scale`` (3 is not a power of two) matches too."""
    data = np.random.default_rng(1).normal(size=(32, 64)).astype(np.float32)
    jw = pack_2d(jnp.asarray(data), out_dtype=DTYPES[wire][0], scale=scale, interpret=True)
    tw = pack_2d_ref(torch.from_numpy(data), out_dtype=DTYPES[wire][1], scale=scale)
    np.testing.assert_array_equal(_np32(tw), _np32(jw))
    jb = unpack_2d(jw, out_dtype=jnp.float32, scale=scale, interpret=True)
    tb = unpack_2d_ref(tw, out_dtype=torch.float32, scale=scale)
    np.testing.assert_array_equal(_np32(tb), _np32(jb))


def _fused_segments(shape, halo):
    spec = JHaloSpec(mesh_axes=("px", "py", "pz")[:len(shape)],
                     array_axes=tuple(range(len(shape))), halo=halo)
    segments, offset = [], 0
    for slab in fused_slab_table(shape, spec):
        segments.append((offset, slab.src_start, slab.shape))
        offset += int(np.prod(slab.shape))
    return tuple(segments), offset


def _schedule_segments(shape, names, sizes, n_parts):
    """Every coalesced layout of a sequential schedule (as segment tuples)."""
    spec = JHaloSpec(mesh_axes=names, array_axes=tuple(range(len(names))), n_parts=n_parts)
    groups = j_seq(shape, spec, dict(zip(names, sizes)))
    return [
        (tuple((s.offset, s.src_start, s.shape) for s in lay.segments), lay.total)
        for lay in j_layouts(groups, j_get_packer("pallas"), jnp.float32)
    ]


LAYOUTS = (
    [_fused_segments((8, 6, 5), 1), _fused_segments((6, 7), 2)]
    + _schedule_segments((6, 10, 5), ("pz", "py"), (4, 2), 1)
    + _schedule_segments((6, 10, 5), ("pz", "py"), (4, 2), 3)
)


@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_gather_pack_ref_equals_pallas_kernel(layout, wire, scale):
    """Batched over 2 ranks: each rank's row equals the TPU kernel on that
    rank's block."""
    segments, total = LAYOUTS[layout]
    ndim = len(segments[0][1])
    shape = {3: (8, 6, 5) if layout == 0 else (6, 10, 5), 2: (6, 7)}[ndim]
    blocks = np.random.default_rng(layout).normal(size=(2, *shape)).astype(np.float32)
    got = gather_pack_ref(torch.from_numpy(blocks), segments, total=total,
                          out_dtype=DTYPES[wire][1], scale=scale)
    assert tuple(got.shape) == (2, total)
    for r in range(2):
        want = gather_pack_1d(jnp.asarray(blocks[r]), segments=segments, total=total,
                              out_dtype=DTYPES[wire][0], scale=scale, interpret=True)
        np.testing.assert_array_equal(_np32(got[r]), _np32(want))


def test_cpu_ops_are_the_plain_versions():
    """``pack_slab`` reads a strided window, ``unpack_slab`` writes one in
    place, ``gather_pack`` fills (R, total): on CPU tensors, the plain path."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 6, 7, 5)).astype(np.float32))
    win = x[:, 1:2, :, 1:4]
    buf = pack_slab(win, out_dtype=torch.bfloat16)
    assert buf.is_contiguous() and buf.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(buf), _np32(pack_2d_ref(win, out_dtype=torch.bfloat16)))
    y = torch.zeros_like(x)
    unpack_slab(buf, y[:, 5:6, :, 1:4])
    np.testing.assert_array_equal(_np32(y[:, 5:6, :, 1:4]), _np32(buf))
    assert float(y[:, :5].abs().sum()) == 0.0
    segments = ((0, (1, 0, 0), (1, 7, 5)), (35, (2, 1, 1), (2, 3, 2)))
    out = gather_pack(x, segments, total=47)
    np.testing.assert_array_equal(out.numpy(), gather_pack_ref(x, segments, total=47).numpy())


def test_segment_table_rejects_windows_outside_the_block():
    from repro_torch.kernels.pack.pack import segment_rows

    assert segment_rows(((0, (1, 2), (3, 4)),), (6, 7)) == [[0, 0, 1, 2, 1, 3, 4]]
    with pytest.raises(ValueError):
        segment_rows(((0, (4, 0), (3, 4)),), (6, 7))
    with pytest.raises(ValueError):
        segment_rows(((1, (0, 0), (1, 1)),), (6, 7))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
def test_cuda_kernels_equal_plain_versions(cuda, wire):
    from repro_torch.kernels.pack.pack import copy_convert, gather_pack as kernel, segment_table

    x = torch.randn((8, 10, 12, 9), generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    win = x[:, 1:2, :, 2:7]
    out = torch.empty(win.shape, dtype=wire, device=cuda)
    assert torch.equal(copy_convert(win, out, scale=8.0), pack_2d_ref(win, out_dtype=wire, scale=8.0))
    segments, total = LAYOUTS[2]
    segments = tuple((o, s, n) for o, s, n in segments)
    xx = torch.randn((8, 6, 10, 5), generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    buf = torch.empty((8, total), dtype=wire, device=cuda)
    kernel(xx, segment_table(segments, (6, 10, 5), cuda), buf)
    assert torch.equal(buf, gather_pack_ref(xx, segments, total=total, out_dtype=wire))
