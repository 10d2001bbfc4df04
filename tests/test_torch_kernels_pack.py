"""Pack kernels of the port: plain versions against the JAX Pallas kernels.

The port's ``pack_2d_ref``/``unpack_2d_ref``/``gather_pack_ref`` are held
BITWISE to JAX ``pack_2d``/``unpack_2d``/``gather_pack_1d`` run in the
Pallas interpreter, on the shapes of ``tests/kernels/test_pack.py`` and on
the coalesced wire layouts of real halo schedules, with f32 and bf16 wire
and scale 1 and 8.  The gather kernel's work table is walked in plain
PyTorch as the kernel walks it (chunk, row, vector part, scalar tail) on
the heat3d schedules' layouts and held bitwise to both.  The dispatching
``ops`` wrappers on CPU tensors are the plain versions.  The CUDA kernels themselves are held to the plain versions
on the card (``cuda`` marker; ``chip_smoke.py`` does the same at full size).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.halo import HaloSpec as JHaloSpec
from repro.core.halo import fused_slab_table, sequential_message_groups as j_seq
from repro.core.transport import get_packer as j_get_packer, schedule_layouts as j_layouts
from repro.kernels.pack import gather_pack_1d, pack_2d, unpack_2d
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels.pack import (
    gather_pack,
    gather_pack_ref,
    pack_2d_ref,
    pack_slab,
    unpack_2d_ref,
    unpack_slab,
)
from repro_torch.kernels.pack.pack import CHUNK, segment_rows, work_rows
from repro_torch.stencil import Domain, StrategyConfig, make_driver

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


def _walk_work_table(x, table, total, *, out_dtype, scale):
    """The gather kernel's walk of a work table in plain PyTorch: chunk by
    chunk, row by row, the vector part and then the scalar tail (vectors of
    16 bytes of the wider type where the launch and the chunk are aligned to
    them, as the wrapper and the kernel decide).  Asserts what the kernel
    trusts: each read lies in the rank's block, each vector row starts
    aligned on both sides, and the rows cover the wire once, in order."""
    ranks = x.shape[0]
    flat = x.reshape(ranks, -1)
    block = flat.shape[1]
    wide = 16 // max(x.element_size(), torch.empty((), dtype=out_dtype).element_size())
    vec_ok = block % wide == 0 and total % wide == 0  # torch's bases are 16-byte aligned
    out = torch.empty((ranks, total), dtype=out_dtype)
    at = 0
    for wire, src, rows, run, srow, shift, align in table:
        assert 0 <= shift <= 8 and align in (1, 2, 4, 8)
        vec = vec_ok and align % wide == 0
        for k in range(rows):
            s, d = src + k * srow, wire + k * run
            assert d == at and 0 <= s and s + run <= block
            cut = run // wide * wide if vec else 0
            assert not vec or (s % wide == 0 and d % wide == 0)
            for lo, hi in ((0, cut), (cut, run)):
                out[:, d + lo:d + hi] = pack_2d_ref(flat[:, s + lo:s + hi],
                                                    out_dtype=out_dtype, scale=scale)
            at += run
    assert at == total
    return out


#: heat3d-shaped: a (4, 2) mesh over (pz, py), x whole; local blocks
#: (6, 8, X) ghosted, X = 8 (rows aligned to vectors) or 6 (some not)
HEAT_STRATEGIES = {"persistent": 1, "partitioned": 4, "partitioned, 3 parts": 3, "fused": 1}


@functools.lru_cache(maxsize=None)
def _heat_case(strategy: str, x_len: int):
    """The local block shape, 8 stacked ranks of data and the coalesced
    layouts (as segment tuples) of one heat3d schedule."""
    mesh = make_mesh((4, 2), ("pz", "py"), device="cpu")
    dom = Domain(mesh, (16, 12, x_len), ("pz", "py", None))
    drv = make_driver(StrategyConfig(name=strategy.split(",")[0], packer="cuda",
                                     n_parts=HEAT_STRATEGIES[strategy]),
                      mesh, dom.halo_spec, ndim=3)
    layouts = [(tuple((s.offset, s.src_start, s.shape) for s in lay.segments), lay.total)
               for lay in drv.wire_layouts(dom.random(0))]
    x = np.random.default_rng(x_len).normal(size=(8, *dom.local_ghosted)).astype(np.float32)
    return dom.local_ghosted, x, layouts


@functools.lru_cache(maxsize=None)
def _heat_pallas(strategy: str, x_len: int, wire: str, scale: float) -> np.ndarray:
    """JAX ``gather_pack_1d`` (interpreter) of rank 0's block over every
    layout of the schedule at once: the segments laid end to end give the
    layouts' wires laid end to end (one compile a schedule)."""
    _, x, layouts = _heat_case(strategy, x_len)
    segments, base = [], 0
    for segs, total in layouts:
        segments += [(base + off, start, shape) for off, start, shape in segs]
        base += total
    return _np32(gather_pack_1d(jnp.asarray(x[0]), segments=tuple(segments), total=base,
                                out_dtype=DTYPES[wire][0], scale=scale, interpret=True))


@pytest.mark.parametrize("chunk", [CHUNK, 16])
@pytest.mark.parametrize("x_len", [8, 6])
@pytest.mark.parametrize("strategy", list(HEAT_STRATEGIES))
def test_work_table_walk_equals_ref_and_pallas_kernel(strategy, x_len, chunk):
    """Every coalesced layout of the heat3d schedules, f32 wire and bf16 wire
    at scale 8: the work table walked as the kernel walks it is bitwise
    equal to ``gather_pack_ref`` on 8 stacked ranks and to the JAX
    ``gather_pack_1d`` (Pallas interpreter) on rank 0.  Chunks of 16
    elements cut the faces into pieces and row groups."""
    local, xn, layouts = _heat_case(strategy, x_len)
    x = torch.from_numpy(xn)
    for wire, scale in (("float32", 1.0), ("bfloat16", 8.0)):
        walked = []
        for segments, total in layouts:
            rows = tuple(map(tuple, segment_rows(segments, local)))
            table = work_rows(rows, local, chunk)
            assert all(r * n <= max(chunk, n) for _, _, r, n, *_ in table)
            got = _walk_work_table(x, table, total, out_dtype=DTYPES[wire][1], scale=scale)
            assert torch.equal(got, gather_pack_ref(x, segments, total=total,
                                                    out_dtype=DTYPES[wire][1], scale=scale))
            walked.append(got[0])
        np.testing.assert_array_equal(_np32(torch.cat(walked)),
                                      _heat_pallas(strategy, x_len, wire, scale))


def test_work_table_cuts_heat3d_faces():
    """At the heat3d size ((258, 514, 512) ghosted blocks): the pz face is one
    run of 263168, cut into 65 chunks (64 of 4096 and one of 1024); a py
    face is 258 rows of 512 at the block's plane stride, 8 rows a chunk;
    every chunk of both is aligned to 8 elements."""
    local = (258, 514, 512)
    pz = work_rows(tuple(map(tuple, segment_rows(((0, (1, 0, 0), (1, 514, 512)),), local))), local)
    assert len(pz) == 65 and {c[3] for c in pz} == {4096, 1024}
    assert all(c[2] == 1 and c[5] == 8 and c[6] == 8 for c in pz)
    assert pz[0][:2] == (0, 514 * 512) and pz[-1][0] == 64 * 4096
    py = work_rows(tuple(map(tuple, segment_rows(((0, (0, 1, 0), (258, 1, 512)),), local))), local)
    assert len(py) == 33 and py[0] == (0, 512, 8, 512, 514 * 512, 7, 8)
    assert py[-1][2] == 2 and sum(c[2] for c in py) == 258


def test_work_table_edge_and_strided_segments():
    """Segments that collapse to rows of one element (an x face: runs
    strided in the source), a corner, and a window starting one element
    past a vector: the walk still equals ``gather_pack_ref`` bitwise, the
    strided and misaligned chunks are scalar (alignment 1), and a chunk
    size that is not a multiple of 8 is refused."""
    local = (5, 6, 12)
    segments = ((0, (1, 1, 0), (3, 4, 1)), (12, (4, 5, 11), (1, 1, 1)),
                (13, (2, 0, 1), (2, 6, 9)), (121, (0, 0, 0), (5, 6, 12)))
    total = 121 + 360
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, *local)).astype(np.float32))
    rows = tuple(map(tuple, segment_rows(segments, local)))
    for chunk in (CHUNK, 24):
        table = work_rows(rows, local, chunk)
        assert table[0][3] == 1 and table[0][6] == 1  # the x face: runs of one, strided rows
        assert all(c[6] == 1 for c in table if 12 <= c[0] < 121)
        for wire in ("float32", "bfloat16"):
            got = _walk_work_table(x, table, total, out_dtype=DTYPES[wire][1], scale=8.0)
            assert torch.equal(got, gather_pack_ref(x, segments, total=total,
                                                    out_dtype=DTYPES[wire][1], scale=8.0))
    with pytest.raises(ValueError):
        work_rows(rows, local, 12)


def _offsets(shape, strides) -> np.ndarray:
    """Element offsets a strided window addresses, in row-major order."""
    idx = np.indices(shape, dtype=np.int64).reshape(len(shape), -1)
    return (np.asarray(strides, np.int64)[:, None] * idx).sum(0)


_BLOCK = torch.zeros((4, 6, 7, 9))  # 4 stacked ranks of a (6, 7, 9) ghosted block
WINDOWS = {
    "z face": _BLOCK[:, 1:2],
    "y face": _BLOCK[:, :, 1:2],
    "x face": _BLOCK[..., 1:2],
    "zy edge": _BLOCK[:, 1:2, 5:6],
    "zx edge": _BLOCK[:, 1:2, :, 7:8],
    "corner": _BLOCK[:, 5:6, 1:2, 1:2],
    "interior": _BLOCK[:, 1:-1, 1:-1, 1:-1],
    "whole": _BLOCK,
    "z slab of 2": _BLOCK[:, 1:3],
    "strided": _BLOCK[:, ::2, :, 1:5],
    "transposed": _BLOCK.transpose(2, 3)[:, 1:3],
    "one rank": _BLOCK[2:3, 1:2, :, :],
}


@pytest.mark.parametrize("dst_kind", ["contiguous", "window", "wider block"])
@pytest.mark.parametrize("name", list(WINDOWS))
def test_collapse_window_addresses_the_same_elements(name, dst_kind):
    """The collapsed (shape, src strides, dst strides) of a window pair
    address exactly the elements the 4-D window addresses, in the same order,
    on both sides: a pack into a contiguous buffer, a copy into the same
    window of another block, and one into a block of other strides."""
    from repro_torch.kernels.pack.pack import collapse_window

    src = WINDOWS[name]
    dst_strides = {"contiguous": torch.empty(src.shape).stride(), "window": src.stride(),
                   "wider block": (864, 108, 12, 1)}[dst_kind]
    n, ss, ds = collapse_window(src.shape, src.stride(), dst_strides)
    assert len(n) <= src.dim() and math.prod(n) == src.numel()
    assert not any(d == 1 for d in n) or n == (1,)
    np.testing.assert_array_equal(_offsets(n, ss), _offsets(src.shape, src.stride()))
    np.testing.assert_array_equal(_offsets(n, ds), _offsets(src.shape, dst_strides))


def test_collapse_window_merges_faces_to_one_run():
    from repro_torch.kernels.pack.pack import collapse_window

    xb = torch.empty((8, 258, 514, 512)).as_strided((8, 258, 514, 512), (258 * 514 * 512, 514 * 512, 512, 1))
    pz, py = xb[:, 1:2], xb[:, :, 1:2]
    assert collapse_window(pz.shape, pz.stride(), (514 * 512, 514 * 512, 512, 1)) == (
        (8, 514 * 512), (258 * 514 * 512, 1), (514 * 512, 1))
    assert collapse_window(py.shape, py.stride(), (258 * 512, 512, 512, 1)) == (
        (8 * 258, 512), (514 * 512, 1), (512, 1))
    assert collapse_window((1, 1), (5, 3), (1, 1)) == ((1,), (1,), (1,))


@pytest.mark.parametrize("case,want", [
    # (shape, src strides, dst strides, src ptr, dst ptr, src bytes, dst bytes)
    (((8, 263168), (67897344, 1), (263168, 1), 4096, 8192, 4, 4), 4),  # pz face f32
    (((8, 263168), (67897344, 1), (263168, 1), 4096, 8192, 4, 2), 4),  # f32 -> bf16 wire
    (((8, 263168), (263168, 1), (67897344, 1), 4096, 8192, 2, 4), 4),  # bf16 wire -> f32
    (((8, 263168), (263168, 1), (67897344, 1), 4096, 8192, 2, 2), 8),  # bf16 -> bf16
    (((8, 263168), (67897344, 1), (263168, 1), 4100, 8192, 4, 4), 1),  # src base off by 4 B
    (((8, 263168), (67897344, 1), (263168, 1), 4096, 8200, 4, 2), 4),  # bf16 side at 8 B
    (((8, 263168), (67897344, 1), (263168, 1), 4096, 8196, 4, 2), 1),  # bf16 side off by 4 B
    (((8, 263168), (263168, 1), (263168, 1), 4096, 8200, 2, 2), 1),  # bf16 -> bf16 needs 16 B
    (((8, 263174), (263174, 1), (263174, 1), 4096, 8192, 2, 2), 1),  # bf16 rows 4 B apart
    (((8, 497, 510), (67897344, 512, 1), (67897344, 512, 1), 4096, 8192, 4, 4), 4),  # run 510: tail
    (((8, 497, 510), (67897344, 512, 1), (253470, 510, 1), 4096, 8192, 4, 4), 1),  # dst rows of 510
    (((1, 497, 510), (7, 512, 1), (9, 512, 1), 4096, 8192, 4, 4), 4),  # a unit row dim's stride
    (((2064, 512), (263168, 2), (512, 1), 4096, 8192, 4, 4), 1),  # strided run
    (((2064, 3), (512, 1), (3, 1), 4096, 8192, 4, 4), 1),  # run shorter than a vector
])
def test_vector_width_only_where_alignment_allows(case, want):
    from repro_torch.kernels.pack.pack import vector_width

    assert vector_width(*case) == want


@pytest.mark.parametrize("name", list(WINDOWS))
def test_launch_layout_is_collapse_and_vector_width(name):
    """The layout the wrapper caches per window is the collapsed window,
    padded to 4 dims with unit dims of stride 0, and the vector width the
    strides allow; with aligned base pointers that is :func:`vector_width`'s."""
    from repro_torch.kernels.pack.pack import _launch_layout, collapse_window, vector_width

    src = WINDOWS[name]
    dst_strides = torch.empty(src.shape).stride()
    n, ss, ds, vec = _launch_layout(src.shape, src.stride(), dst_strides, 4, 2)
    cn, css, cds = collapse_window(src.shape, src.stride(), dst_strides)
    pad = 4 - len(cn)
    assert (n, ss, ds) == ((1,) * pad + cn, (0,) * pad + css, (0,) * pad + cds)
    assert vec == vector_width(cn, css, cds, 4096, 8192, 4, 2)
    hits = _launch_layout.cache_info().hits
    assert _launch_layout(src.shape, src.stride(), dst_strides, 4, 2) == (n, ss, ds, vec)
    assert _launch_layout.cache_info().hits == hits + 1  # computed once per layout


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


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [
    (slice(1, 2), slice(3, 40), slice(1, 31)),  # misaligned start: scalar path
    (slice(1, 2), slice(3, 40), slice(0, 30)),  # aligned rows, run of 30: vectors + tail
    (slice(None), slice(1, 2), slice(None)),  # y face, one run per (rank, z) row
    (slice(2, 5), slice(None), slice(4, 12)),  # aligned run of 8, three row dims
])
def test_cuda_copy_convert_ragged_windows_bitwise(cuda, wire, window):
    """Pack into a wire buffer, unpack into another block's window, and copy
    window to window: bitwise equal to the plain versions."""
    from repro_torch.kernels.pack.pack import copy_convert

    x = torch.randn((8, 10, 44, 32), generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    win = x[(slice(None), *window)]
    for scale in (1.0, 8.0):
        buf = torch.empty(win.shape, dtype=wire, device=cuda)
        want = pack_2d_ref(win, out_dtype=wire, scale=scale)
        assert torch.equal(copy_convert(win, buf, scale=scale), want)
        back = torch.zeros_like(x)
        ghost = back[(slice(None), *window)]
        copy_convert(buf, ghost, scale=1.0 / scale)
        assert torch.equal(ghost, unpack_2d_ref(want, out_dtype=torch.float32, scale=scale))
        ghost.zero_()
        assert not back.any()  # nothing written outside the window
        other = torch.zeros((8, 10, 44, 32), dtype=wire, device=cuda)
        copy_convert(win, other[(slice(None), *window)], scale=scale)
        assert torch.equal(other[(slice(None), *window)], want)


@pytest.mark.cuda
@pytest.mark.parametrize("wire,scale", [(torch.float32, 1.0), (torch.bfloat16, 8.0),
                                        (torch.float32, 8.0)])
@pytest.mark.parametrize("chunk", [CHUNK, 24])
def test_cuda_gather_pack_ragged_misaligned_edge_segments(cuda, wire, scale, chunk):
    """``gather_pack`` bitwise against ``gather_pack_ref`` on segments whose
    rows are ragged (runs of 29 and 33) and start one element past a vector,
    collapse to rows of one element (an x face) or to one corner cell, beside
    a whole-face run cut into chunks; on 8 stacked ranks, and on 3 whose
    blocks start one element past a vector (no vectors in the launch)."""
    from repro_torch.kernels.pack.pack import gather_pack as kernel

    local = (6, 40, 36)
    segments = ((0, (1, 3, 5), (1, 7, 29)), (203, (0, 0, 1), (3, 1, 1)),
                (206, (2, 1, 0), (2, 3, 36)), (422, (5, 0, 3), (1, 40, 33)),
                (1742, (1, 2, 35), (4, 38, 1)), (1894, (5, 39, 35), (1, 1, 1)),
                (1895, (0, 0, 0), (1, 40, 36)))
    total = 1895 + 1440
    rows = tuple(map(tuple, segment_rows(segments, local)))
    table = torch.tensor(work_rows(rows, local, chunk), dtype=torch.int64, device=cuda)
    for ranks, shift in ((8, 0), (3, 1)):
        # shift 1: blocks one element past an aligned base, so the wrapper
        # refuses vectors for the whole launch and every chunk moves scalars
        n = ranks * math.prod(local)
        x = torch.empty(n + shift, device=cuda)[shift:].view(ranks, *local)
        x.copy_(torch.randn((ranks, *local), generator=torch.Generator(cuda).manual_seed(3),
                            device=cuda))
        out = torch.empty((ranks, total), dtype=wire, device=cuda)
        kernel(x, table, out, scale=scale)
        assert torch.equal(out, gather_pack_ref(x, segments, total=total, out_dtype=wire,
                                                scale=scale))
