"""Transport tables of the port: field-equal to the JAX package's.

Message tables (sequential and fused), partitions, ``WireLayout``s of every
packer pair (JAX ``pallas`` <-> port ``cuda``), ``composed_hop`` pairs and
``scheduled_collective_count`` are compared for the same geometry on 1-D,
2-D and 3-D meshes, with partition counts that do and do not divide the
face, periodic and non-periodic.  Then the loopback transport's rank
gather is checked against the hop tables it implements (no sender ->
zeros), and the port's plan cache counters.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.core import compat as j_compat
from repro.core import halo as j_halo
from repro.core import transport as j_tr
from repro_torch.core import halo as t_halo
from repro_torch.core import transport as t_tr
from repro_torch.core.mesh import make_mesh
from repro_torch.core.plan import PlanCache, stale_epoch, transport_plan

torch.set_num_threads(1)

#: (mesh axis names, sizes, local ghosted block); decomposed = first axes
GEOMETRIES = [
    (("px",), (4,), (6,)),
    (("px",), (1,), (5, 7)),
    (("pz", "py"), (4, 2), (6, 10, 5)),
    (("px", "py"), (2, 3), (7, 6)),
    (("px", "py", "pz"), (2, 2, 2), (5, 6, 7)),
    (("px", "py", "pz"), (1, 3, 2), (6, 5, 9)),
]
PACKER_PAIRS = [("slice", "slice"), ("pallas", "cuda"), ("bf16", "bf16"),
                ("scaled-int8", "scaled-int8")]


def _astuple(x):
    return tuple(dataclasses.astuple(m) for m in x)


def _groups(mod, kind, names, sizes, shape, n_parts, periodic, halo=1):
    spec = mod.HaloSpec(mesh_axes=names, array_axes=tuple(range(len(names))), halo=halo,
                        n_parts=n_parts, periodic=periodic)
    sz = dict(zip(names, sizes))
    if kind == "fused":
        return (mod.fused_message_group(shape, spec, sz),)
    return mod.sequential_message_groups(shape, spec, sz)


CASES = [
    (g, kind, n_parts, periodic)
    for g in range(len(GEOMETRIES))
    for kind in ("sequential", "fused")
    for n_parts in ((1, 3, 4) if kind == "sequential" else (1,))
    for periodic in (True, False)
]


@pytest.mark.parametrize("g,kind,n_parts,periodic", CASES)
def test_message_tables_equal_jax(g, kind, n_parts, periodic):
    names, sizes, shape = GEOMETRIES[g]
    want = _groups(j_halo, kind, names, sizes, shape, n_parts, periodic)
    got = _groups(t_halo, kind, names, sizes, shape, n_parts, periodic)
    assert len(got) == len(want)
    for gg, wg in zip(got, want):
        assert _astuple(gg) == _astuple(wg)
        for gm, wm in zip(gg, wg):
            assert _astuple(gm.partitions()) == _astuple(wm.partitions())
    for coalesce in (True, False):
        assert (t_tr.scheduled_collective_count(got, coalesce=coalesce)
                == j_tr.scheduled_collective_count(want, coalesce=coalesce))


@pytest.mark.parametrize("jp,tp", PACKER_PAIRS)
@pytest.mark.parametrize("g", range(len(GEOMETRIES)))
def test_wire_layouts_equal_jax(g, jp, tp):
    names, sizes, shape = GEOMETRIES[g]
    for kind, n_parts in (("sequential", 3), ("fused", 1)):
        want = j_tr.schedule_layouts(
            _groups(j_halo, kind, names, sizes, shape, n_parts, True), jp, jnp.float32)
        got = t_tr.schedule_layouts(
            _groups(t_halo, kind, names, sizes, shape, n_parts, True), tp, torch.float32)
        assert _astuple(got) == _astuple(want)
        assert [lay.wire_bytes for lay in got] == [lay.wire_bytes for lay in want]
    assert (t_tr.get_packer(tp).wire_tolerance("float32")
            == j_tr.get_packer(jp).wire_tolerance(jnp.float32))


@pytest.mark.parametrize("g", range(len(GEOMETRIES)))
def test_composed_hops_equal_jax(g, monkeypatch):
    """Every fused chain composes to the same joint permutation (the JAX
    side reads axis sizes from the mesh inside ``shard_map``; here from the
    same size table)."""
    names, sizes, shape = GEOMETRIES[g]
    sz = dict(zip(names, sizes))
    monkeypatch.setattr(j_compat, "axis_size", lambda name: sz[name])
    for periodic in (True, False):
        for msg in _groups(t_halo, "fused", names, sizes, shape, 1, periodic)[0]:
            assert t_tr.composed_hop(msg.hops, sz) == j_tr.composed_hop(msg.hops)


def test_partitioner_and_non_dividing_partitions_equal_jax():
    for n_parts, size in ((3, 7), (4, 6), (7, 5), (1, 9)):
        assert (t_tr.Partitioner(n_parts).slices(size)
                == j_tr.Partitioner(n_parts).slices(size))
    msg = dict(src_start=(1, 0, 0), dst_start=(5, 0, 0), shape=(1, 7, 5), n_parts=3, part_axis=1)
    assert (_astuple(t_tr.Message(**msg).partitions())
            == _astuple(j_tr.Message(**msg).partitions()))


def test_schedule_info_tag_matches_jax_format():
    kw = dict(kind="fused", mesh_axes=("pz", "py"), packer="bf16", coalesce=True,
              mapping="blocked", epoch=3)
    assert (t_tr.ScheduleInfo(transport="loopback", **kw).tag()
            == j_tr.ScheduleInfo(transport="loopback", **kw).tag())


def test_halo_spec_validates_like_jax():
    spec = t_halo.HaloSpec(mesh_axes=("px",), array_axes=(0,), mapping="rb")
    assert spec.mapping == "recursive-bisection"
    with pytest.raises(KeyError):
        t_halo.HaloSpec(mesh_axes=("px",), array_axes=(0,), packer="pallas")
    with pytest.raises(KeyError):
        t_halo.HaloSpec(mesh_axes=("px",), array_axes=(0,), mapping="nope")


@pytest.mark.parametrize("periodic", [True, False])
def test_loopback_gather_follows_the_hop_table(periodic):
    """Each rank's row lands where the composed table sends it, along the
    named axes only; ranks nobody sends to receive zeros."""
    mesh = make_mesh((3, 2, 2), ("a", "b", "c"), device="cpu")
    to_right = tuple((i, (i + 1) % 3) for i in range(3) if periodic or i < 2)
    to_left = ((0, 1), (1, 0)) if periodic else ((1, 0),)
    hops = (("a", to_right), ("c", to_left))
    hop = t_tr.composed_hop(hops, mesh.shape)
    buf = torch.arange(1, mesh.size + 1, dtype=torch.float32).view(-1, 1).repeat(1, 3)
    t = t_tr.get_transport("loopback")
    out = t.move(buf, t.route_table(hop, mesh))
    for r in range(mesh.size):
        a, b, c = mesh.coords(r)
        src = [(sa, b, sc) for sa, da in to_right for sc, dc in to_left if (da, dc) == (a, c)]
        want = float(mesh.rank(src[0]) + 1) if src else 0.0
        assert out[r].tolist() == [want] * 3


def test_prepared_exchange_owns_tables_and_buffers():
    mesh = make_mesh((4, 2), ("pz", "py"), device="cpu")
    spec = t_halo.HaloSpec(mesh_axes=("pz", "py"), array_axes=(0, 1), n_parts=3)
    groups = t_halo.sequential_message_groups((6, 10, 5), spec, mesh.shape)
    prep = t_tr.PreparedExchange(groups, mesh=mesh, local_shape=(6, 10, 5),
                                 dtype=torch.float32, packer="cuda", coalesce=True)
    assert tuple(prep.layouts) == t_tr.schedule_layouts(groups, "cuda", torch.float32)
    with pytest.raises(ValueError):
        prep.run(torch.zeros((8, 6, 10, 6)))


def test_plan_cache_counters():
    mesh = make_mesh((2,), ("px",), device="cpu")
    spec = t_halo.HaloSpec(mesh_axes=("px",), array_axes=(0,), epoch=2)
    cache = PlanCache()
    built = []

    def factory():
        built.append(1)
        return lambda x: x + 1

    kw = dict(device=mesh.device, schedule=spec.schedule_info("sequential"), cache=cache)
    p1 = transport_plan(factory, key=("k", spec), **kw)
    p2 = transport_plan(factory, key=("k", spec), **kw)
    assert p1 is p2 and len(built) == 1
    assert cache.stats.inits == 1 and cache.stats.cache_hits == 1
    assert p1.start(torch.ones(2)).tolist() == [2.0, 2.0]
    assert stale_epoch(("k", spec), 3) and not stale_epoch(("k", spec), 2)
    assert cache.invalidate_stale_epochs(2) == 0
    assert cache.invalidate_stale_epochs(3) == 1
    assert cache.stats.invalidations == 1 and len(cache) == 0
    with pytest.raises(RuntimeError, match="after free"):
        p1.start(torch.ones(2))
