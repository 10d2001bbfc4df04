"""The port's partitioned collectives (``repro_torch/core/partitioned.py``)
against the JAX package's under ``shard_map``.

One ``(2, 4)`` mesh over ``("data", "model")`` (the conftest's 8 virtual
CPU devices); every collective runs over ``"model"``, so each one works
within the two groups of 4 ranks that share a data coordinate.  The same
numpy inputs, made from a seed, go through one jitted ``shard_map`` of the
JAX functions (compiled once for the module) and through the port's
functions on the stacked ranks ``(8, ...)``: device ``(d, m)`` holds the
JAX shard of rank ``4 d + m``, the port's row-major rank.

Tolerances, stated: data movement (permutes, gathers, all-to-alls, the
hooks' elementwise work) is bitwise; ``message_all_to_all`` equals
``partitioned_all_to_all`` bitwise for the exact packers (``slice``,
``cuda``), coalesced or not, partitioned or not.  Arithmetic is f32: the
matmuls and the sums of the reductions within ``rtol=atol=1e-5`` (XLA and
PyTorch sum the products of a 5-long dot and the 4 ranks' terms in other
orders, a few f32 ulps of values of order 1-10).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compat as j_compat
from repro.core import partitioned as j_part
from repro_torch.core import partitioned as t_part
from repro_torch.core.mesh import make_mesh

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

MESH, NAMES, AX = (2, 4), ("data", "model"), "model"
R, K = 8, 4
EXACT = dict(rtol=0, atol=0)
F32 = dict(rtol=1e-5, atol=1e-5)
SHIFT = [(i, i + 1) for i in range(K - 1)]  # non-periodic: rank 0 receives zeros


def _inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.normal(size=(R, *shape)).astype(np.float32)

    return dict(x=normal(6, 4), x2=normal(8, 6), xm=normal(3, 5), w=normal(5, 7),
                w2=normal(5, 2), xr=normal(8, 5), ta=normal(3, 2), tb0=normal(5),
                tb1=normal(2, 2))


def _jax_cells(a: dict) -> dict:
    """Every cell's JAX result, one shard_map of per-device functions."""
    def tree(a):
        return {"a": a["ta"], "b": [a["tb0"], a["tb1"]]}

    return {
        "ppermute": j_part.partitioned_ppermute(a["x"], AX, j_part.ring_perm(AX)),
        "ppermute_p4_hooks": j_part.partitioned_ppermute(
            a["x"], AX, j_part.ring_perm(AX), n_parts=4, pack_fn=lambda c: c * 2.0,
            consume_fn=lambda c: c + 1.0),
        "ppermute_shift_axis1_p3": j_part.partitioned_ppermute(
            a["x"], AX, SHIFT, n_parts=3, split_axis=1),
        "all_gather": j_part.ring_all_gather(a["x"], AX),
        "all_gather_p4": j_part.ring_all_gather(a["x"], AX, n_parts=4),
        "all_gather_axis1": j_part.ring_all_gather(a["x"], AX, gather_axis=1, n_parts=3),
        "ag_matmul": j_part.ring_all_gather_matmul(a["xm"], a["w"], AX),
        "ag_matmul_pair": jnp.concatenate(
            j_part.ring_all_gather_matmul(a["xm"], [a["w"], a["w2"]], AX), axis=-1),
        "matmul_rs": j_part.ring_matmul_reduce_scatter(a["xr"], a["w"], AX),
        "all_to_all": j_part.partitioned_all_to_all(a["x2"], AX, split_axis=0, concat_axis=0),
        "all_to_all_concat1": j_part.partitioned_all_to_all(
            a["x2"], AX, split_axis=0, concat_axis=1),
        "all_to_all_p4": j_part.partitioned_all_to_all(
            a["x2"], AX, split_axis=0, concat_axis=0, n_parts=4, consume_fn=lambda c: c * 3.0),
        "all_to_all_p3_rescale": j_part.partitioned_all_to_all(
            a["x2"], AX, split_axis=0, concat_axis=0, n_parts=3, consume_fn=lambda c: c[:, ::2]),
        "message_all_to_all": j_part.message_all_to_all(
            a["x2"], AX, split_axis=0, concat_axis=0, n_parts=2),
        "psum_scatter": j_part.partitioned_psum_scatter(a["x"], AX, scatter_axis=1),
        "psum_scatter_p4": j_part.partitioned_psum_scatter(a["x"], AX, scatter_axis=1,
                                                           n_parts=4, chunk_axis=0),
        "psum": j_part.partitioned_psum(a["x"], AX),
        "psum_p4": j_part.partitioned_psum(a["x"], AX, n_parts=4),
        "bucketed_psum_tree": jnp.concatenate(
            [leaf.reshape(-1) for leaf in
             jax.tree.leaves(j_part.bucketed_psum_tree(tree(a), AX, 2))])[None],
    }


def _torch_cells(a: dict, mesh) -> dict:
    """The same cells through the port on the stacked ranks."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    perm = t_part.ring_perm(K)
    tree = {"a": t["ta"], "b": [t["tb0"], t["tb1"]]}
    summed = t_part.bucketed_psum_tree(tree, mesh, AX, 2)
    return {
        "ppermute": t_part.partitioned_ppermute(t["x"], mesh, AX, perm),
        "ppermute_p4_hooks": t_part.partitioned_ppermute(
            t["x"], mesh, AX, perm, n_parts=4, pack_fn=lambda c: c * 2.0,
            consume_fn=lambda c: c + 1.0),
        "ppermute_shift_axis1_p3": t_part.partitioned_ppermute(
            t["x"], mesh, AX, SHIFT, n_parts=3, split_axis=1),
        "all_gather": t_part.ring_all_gather(t["x"], mesh, AX),
        "all_gather_p4": t_part.ring_all_gather(t["x"], mesh, AX, n_parts=4),
        "all_gather_axis1": t_part.ring_all_gather(t["x"], mesh, AX, gather_axis=1, n_parts=3),
        "ag_matmul": t_part.ring_all_gather_matmul(t["xm"], t["w"], mesh, AX),
        "ag_matmul_pair": torch.cat(
            t_part.ring_all_gather_matmul(t["xm"], [t["w"], t["w2"]], mesh, AX), dim=-1),
        "matmul_rs": t_part.ring_matmul_reduce_scatter(t["xr"], t["w"], mesh, AX),
        "all_to_all": t_part.partitioned_all_to_all(t["x2"], mesh, AX, split_axis=0,
                                                    concat_axis=0),
        "all_to_all_concat1": t_part.partitioned_all_to_all(t["x2"], mesh, AX, split_axis=0,
                                                            concat_axis=1),
        "all_to_all_p4": t_part.partitioned_all_to_all(
            t["x2"], mesh, AX, split_axis=0, concat_axis=0, n_parts=4,
            consume_fn=lambda c: c * 3.0),
        "all_to_all_p3_rescale": t_part.partitioned_all_to_all(
            t["x2"], mesh, AX, split_axis=0, concat_axis=0, n_parts=3,
            consume_fn=lambda c: c[:, :, ::2]),
        "message_all_to_all": t_part.message_all_to_all(
            t["x2"], mesh, AX, split_axis=0, concat_axis=0, n_parts=2),
        "psum_scatter": t_part.partitioned_psum_scatter(t["x"], mesh, AX, scatter_axis=1),
        "psum_scatter_p4": t_part.partitioned_psum_scatter(t["x"], mesh, AX, scatter_axis=1,
                                                           n_parts=4, chunk_axis=0),
        "psum": t_part.partitioned_psum(t["x"], mesh, AX),
        "psum_p4": t_part.partitioned_psum(t["x"], mesh, AX, n_parts=4),
        "bucketed_psum_tree": torch.cat([summed["a"].reshape(R, -1),
                                         summed["b"][0].reshape(R, -1),
                                         summed["b"][1].reshape(R, -1)], dim=1)[:, None],
    }


TOL = {"ppermute": EXACT, "ppermute_p4_hooks": EXACT, "ppermute_shift_axis1_p3": EXACT,
       "all_gather": EXACT, "all_gather_p4": EXACT, "all_gather_axis1": EXACT,
       "ag_matmul": F32, "ag_matmul_pair": F32, "matmul_rs": F32,
       "all_to_all": EXACT, "all_to_all_concat1": EXACT, "all_to_all_p4": EXACT,
       "all_to_all_p3_rescale": EXACT, "message_all_to_all": EXACT,
       "psum_scatter": F32, "psum_scatter_p4": F32, "psum": F32, "psum_p4": F32,
       "bucketed_psum_tree": F32}


@pytest.fixture(scope="module")
def cells():
    if len(jax.devices()) < R:
        pytest.skip(f"needs {R} virtual devices (conftest)")
    a = _inputs()
    jmesh = j_compat.make_mesh(MESH, NAMES, devices=jax.devices()[:R])
    spec = P(NAMES)
    names = sorted(a)

    def inner(*shards):
        return _jax_cells(dict(zip(names, shards)))

    run = _jitr(j_compat.shard_map(inner, mesh=jmesh, in_specs=(spec,) * len(names),
                                     out_specs=spec))
    out = run(*[jnp.asarray(a[n].reshape(-1, *a[n].shape[2:])) for n in names])
    want = {k: np.asarray(v).reshape(R, -1, *v.shape[1:]) for k, v in out.items()}
    got = _torch_cells(a, make_mesh(MESH, NAMES, device="cpu"))
    return got, want


@pytest.mark.parametrize("name", sorted(TOL))
def test_primitive_matches_jax(cells, name):
    got, want = cells
    g, w = got[name].numpy(), want[name]
    assert g.shape == w.shape, (g.shape, w.shape)
    if TOL[name] is EXACT:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, **TOL[name])


def test_non_periodic_permute_gives_zeros_to_rank_without_source(cells):
    got, _ = cells
    out = got["ppermute_shift_axis1_p3"].reshape(MESH[0], K, 6, 4)
    assert not out[:, 0].any() and out[:, 1:].abs().sum() > 0


@pytest.mark.parametrize("packer", ["slice", "cuda"])
@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("n_parts", [1, 4])
def test_message_all_to_all_bitwise_equals_native(packer, coalesce, n_parts):
    """The ring-shift Message table through the transport equals the native
    all-to-all bitwise for the exact packers (the port's ``cuda`` packer
    takes its plain version on the CPU)."""
    mesh = make_mesh(MESH, NAMES, device="cpu")
    x = torch.from_numpy(_inputs()["x2"])
    kw = dict(split_axis=0, concat_axis=0, n_parts=n_parts, consume_fn=lambda c: c - 0.5)
    want = t_part.partitioned_all_to_all(x, mesh, AX, **kw)
    got = t_part.message_all_to_all(x, mesh, AX, packer=packer, coalesce=coalesce, **kw)
    assert torch.equal(got, want)


def test_message_all_to_all_lossy_wire_within_tolerance():
    mesh = make_mesh(MESH, NAMES, device="cpu")
    x = torch.from_numpy(_inputs()["x2"])
    want = t_part.partitioned_all_to_all(x, mesh, AX, split_axis=0, concat_axis=0)
    got = t_part.message_all_to_all(x, mesh, AX, split_axis=0, concat_axis=0, packer="bf16")
    torch.testing.assert_close(got, want, rtol=1.0 / 128.0, atol=1e-6)


def test_all_to_all_messages_table_equals_jax():
    import dataclasses

    got = t_part.all_to_all_messages((8, 6), AX, K, split_axis=0)
    want = j_part.all_to_all_messages((8, 6), AX, K, split_axis=0)
    assert [dataclasses.astuple(m) for m in got] == [dataclasses.astuple(m) for m in want]


def test_bucket_tree_equals_jax_buckets():
    a = _inputs()
    t_tree = {"a": torch.from_numpy(a["ta"]), "b": [torch.from_numpy(a["tb0"]),
                                                    torch.from_numpy(a["tb1"])]}
    j_tree = {"a": a["ta"][0], "b": [a["tb0"][0], a["tb1"][0]]}  # one rank's leaves
    for n in (1, 2, 3, 5):
        got = [[i for i, _ in b] for b in t_part.bucket_tree(t_tree, n)]
        want = [[i for i, _ in b] for b in j_part.bucket_tree(j_tree, n)]
        assert got == want, n


def test_ring_of_one_is_local():
    mesh = make_mesh((4, 1), NAMES, device="cpu")
    x = torch.arange(24.0).reshape(4, 3, 2)
    assert torch.equal(t_part.ring_all_gather(x, mesh, AX), x)
    assert torch.equal(t_part.partitioned_psum(x, mesh, AX), x)
    assert torch.equal(t_part.message_all_to_all(x, mesh, AX, split_axis=0, concat_axis=0), x)


def test_mesh_over_processes_is_refused():
    mesh = make_mesh(MESH, NAMES, device="cpu", processes=2)
    x = torch.zeros(4, 6, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 17"):
        t_part.ring_all_gather(x, mesh, AX)
