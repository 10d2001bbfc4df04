"""Process-to-node mapping and hop locality of the port, against the JAX
package.

* Every registered mapping's ``placement``, ``node_of`` and
  ``permute_devices`` equal JAX's over mesh shapes (2, 2), (4, 2), (2, 4),
  (8,) and (2, 2, 2) and node sizes 1, 2 and 4; the registry, the ``rb``
  alias, unknown names and ``default_node_size`` too.
* ``mesh_node_ids`` of a port mesh built with a mapping's placement equals
  JAX ``mesh_node_ids`` of the JAX mesh built from ``permute_devices``.
* ``schedule_locality`` of every strategy's tables (``n_parts`` 1 and 3) on
  (2, 2), (4, 2) and (2, 4) meshes under each mapping equals JAX's field
  for field; blocked strictly lowers the inter-node sends on the two-node
  (2, 4) grid, and every mapping's exchange stays bitwise-equal to
  ``reference_exchange``.
* Under 2 and 4 processes a mapping puts each coordinate in the process
  that JAX's permuted device list gives it (``VirtualMesh.process_of``,
  ``local_coords``).
* ``cuda``-marked (run on the card, skipped here): a 2-process grid on one
  card moves every strategy x packer ``slice``/``cuda`` x coalesce cell
  through the ``multihost`` transport bitwise-equal to a one-process
  ``loopback`` exchange of the same block, on each process's rows, with
  its plans eager and the pack kernels launched in both processes.
"""

import json
import math
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from repro.core.compat import make_mesh as j_make_mesh
from repro.core.transport import schedule_locality as j_schedule_locality
from repro.launch import mapping as j_mapping
from repro.stencil import Domain as JDomain
from repro.stencil import StrategyConfig as JConfig
from repro.stencil import make_driver as j_make_driver
from repro_torch.core.mesh import VirtualMesh, make_mesh
from repro_torch.core.transport import HopLocality, schedule_locality
from repro_torch.launch import mapping as t_mapping
from repro_torch.stencil import Domain, StrategyConfig, make_driver, reference_exchange

torch.set_num_threads(1)

SHAPES = [(2, 2), (4, 2), (2, 4), (8,), (2, 2, 2)]
NODE_SIZES = [1, 2, 4]
STRATEGIES = ("standard", "persistent", "partitioned", "fused", "overlap")


def test_registry_aliases_and_errors_match_jax():
    assert t_mapping.available_mappings() == j_mapping.available_mappings()
    assert t_mapping.ALIASES == j_mapping.ALIASES
    for name in (*j_mapping.available_mappings(), "rb"):
        assert t_mapping.canonical_mapping(name) == j_mapping.canonical_mapping(name)
        assert t_mapping.get_mapping(name).name == j_mapping.get_mapping(name).name
    with pytest.raises(KeyError) as te:
        t_mapping.canonical_mapping("nope")
    with pytest.raises(KeyError) as je:
        j_mapping.canonical_mapping("nope")
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="already registered"):
        t_mapping.register_mapping(t_mapping.BlockedMapping())


@pytest.mark.parametrize("node_size", NODE_SIZES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", j_mapping.available_mappings())
def test_placement_node_of_and_permute_devices_equal_jax(name, shape, node_size):
    tm, jm = t_mapping.get_mapping(name), j_mapping.get_mapping(name)
    assert tm.placement(shape, node_size) == jm.placement(shape, node_size)
    assert tm.node_of(shape, node_size) == jm.node_of(shape, node_size)
    devices = [f"dev{i}" for i in range(int(np.prod(shape)))]
    assert (tm.permute_devices(devices, shape, node_size)
            == jm.permute_devices(devices, shape, node_size))
    if name == "blocked":
        assert tm.block_dims(shape, node_size) == jm.block_dims(shape, node_size)


def test_default_node_size_matches_jax():
    for n in range(1, 17):
        for processes in (1, 2, 3, 4, 8):
            assert (t_mapping.default_node_size(n, processes)
                    == j_mapping.default_node_size(n, processes)), (n, processes)


@pytest.mark.parametrize("node_size", [0, 2, 4])
@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2, 2)], ids=str)
def test_mesh_node_ids_equal_jax_on_a_placed_mesh(shape, node_size):
    names = ("px", "py", "pz")[: len(shape)]
    for name in j_mapping.available_mappings():
        ns = node_size or t_mapping.default_node_size(int(np.prod(shape)))
        mesh = make_mesh(shape, names, device="cpu",
                         placement=t_mapping.get_mapping(name).placement(shape, ns))
        devices = j_mapping.get_mapping(name).permute_devices(
            jax.devices()[: int(np.prod(shape))], shape, ns)
        jmesh = j_make_mesh(shape, names, devices=devices)
        assert (t_mapping.mesh_node_ids(mesh, node_size)
                == j_mapping.mesh_node_ids(jmesh, node_size)), name


def test_placement_is_validated_and_defaults_to_identity():
    mesh = make_mesh((4, 2), ("px", "py"), device="cpu")
    assert mesh.placement == tuple(range(8))
    with pytest.raises(ValueError, match="permutation"):
        make_mesh((2, 2), ("px", "py"), device="cpu", placement=(0, 1, 1, 3))
    with pytest.raises(ValueError, match="permutation"):
        VirtualMesh((2,), ("px",), torch.device("cpu"), (0, 1, 2))
    placed = make_mesh((2, 4), ("px", "py"), device="cpu",
                       placement=t_mapping.get_mapping("blocked").placement((2, 4), 4))
    assert placed != make_mesh((2, 4), ("px", "py"), device="cpu")  # part of plan keys


# ---------------------------------------------------------------------------
# hop locality
# ---------------------------------------------------------------------------


def _tables(shape, strategy, n_parts):
    """Each package's own message tables of one strategy on a 2-D mesh over
    the first two axes of a (12, 8, 5) interior."""
    names = ("px", "py")
    d = Domain(make_mesh(shape, names, device="cpu"), (12, 8, 5), (*names, None))
    drv = make_driver(StrategyConfig(name=strategy, n_parts=n_parts), d.mesh, d.halo_spec,
                      ndim=3)
    groups = drv.replan_tables(torch.empty(d.stacked_shape, device="meta"))[0]
    jd = JDomain(j_make_mesh(shape, names, devices=jax.devices()[: int(np.prod(shape))]),
                 (12, 8, 5), (*names, None))
    jdrv = j_make_driver(JConfig(name=strategy, n_parts=n_parts), jd.mesh, jd.halo_spec,
                         ndim=3)
    jgroups = jdrv.replan_tables(jax.ShapeDtypeStruct(jd.stored_global, np.float32))[0]
    return groups, jgroups


@pytest.mark.parametrize("n_parts", [1, 3])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4)], ids=str)
def test_schedule_locality_equals_jax(shape, strategy, n_parts):
    groups, jgroups = _tables(shape, strategy, n_parts)
    sizes = dict(zip(("px", "py"), shape))
    n = int(np.prod(shape))
    for name in j_mapping.available_mappings():
        for node_size in (2, t_mapping.default_node_size(n)):
            node_of = t_mapping.get_mapping(name).node_of(shape, node_size)
            kw = dict(axis_order=("px", "py"), axis_sizes=sizes, node_of=node_of)
            got = schedule_locality(groups, **kw)
            want = j_schedule_locality(jgroups, **kw)
            assert (got.intra_sends, got.inter_sends, got.intra_elems, got.inter_elems) == (
                want.intra_sends, want.inter_sends, want.intra_elems, want.inter_elems
            ), (name, node_size)
            assert got.total_sends == want.total_sends


@pytest.mark.parametrize("strategy", ["persistent", "fused"])
def test_blocked_strictly_lowers_inter_node_sends(strategy):
    """Two 4-rank nodes on a (2, 4) grid: from the static tables alone,
    blocked and recursive bisection send fewer messages across the node
    boundary than row-major; the total is conserved."""
    groups, _ = _tables((2, 4), strategy, 1)
    kw = dict(axis_order=("px", "py"), axis_sizes={"px": 2, "py": 4})
    tally = {name: schedule_locality(groups, node_of=t_mapping.get_mapping(name).node_of(
        (2, 4), 4), **kw) for name in t_mapping.available_mappings()}
    rm, bl, rb = tally["row-major"], tally["blocked"], tally["recursive-bisection"]
    assert rm.total_sends == bl.total_sends == rb.total_sends
    assert bl.inter_sends < rm.inter_sends and rb.inter_sends < rm.inter_sends
    assert (rm.inter_sends, bl.inter_sends) == {"persistent": (16, 8), "fused": (48, 24)}[strategy]
    assert HopLocality(1, 2, 3, 4) + HopLocality(1, 1, 1, 1) == HopLocality(2, 3, 4, 5)


@pytest.mark.parametrize("name", t_mapping.available_mappings())
def test_exchange_on_a_placed_mesh_equals_reference(name):
    """Placement is a label on one card: every strategy's exchange on a
    placed mesh equals ``reference_exchange`` bitwise."""
    mesh = make_mesh((4, 2), ("px", "py"), device="cpu",
                     placement=t_mapping.get_mapping(name).placement((4, 2), 2))
    d = Domain(mesh, (12, 6), ("px", "py"))
    interior = np.random.default_rng(7).normal(size=d.global_interior).astype(np.float32)
    want = reference_exchange(d, interior)
    for strategy in STRATEGIES:
        drv = make_driver(StrategyConfig(name=strategy, mapping=name,
                                         n_parts=2 if strategy == "partitioned" else 1),
                          mesh, d.halo_spec, ndim=2)
        got = drv.wait(drv.step(d.from_global_interior(interior)))
        drv.free()
        assert torch.equal(got, want), strategy


@pytest.mark.parametrize("processes", [2, 4])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4), (8,)], ids=str)
@pytest.mark.parametrize("name", j_mapping.available_mappings())
def test_a_grid_mesh_holds_the_coordinates_of_jaxs_process_devices(name, shape, processes):
    """JAX places device ``placement[c]`` at coordinate ``c``, and a device
    belongs to process ``id // local``; the port's process stacks exactly
    those coordinates, in coordinate order."""
    n = math.prod(shape)
    local = n // processes
    devices = [types.SimpleNamespace(id=i, process_index=i // local) for i in range(n)]
    placed = j_mapping.get_mapping(name).permute_devices(devices, shape, local)
    placement = t_mapping.get_mapping(name).placement(shape, local)
    names = ("px", "py")[:len(shape)]
    held = []
    for q in range(processes):
        mesh = make_mesh(shape, names, device="cpu", placement=placement,
                         processes=processes, process_index=q)
        assert mesh.local_coords == tuple(c for c, d in enumerate(placed) if d.process_index == q)
        assert [mesh.process_of(c) for c in range(n)] == [d.process_index for d in placed]
        assert mesh.local_size == local and mesh.stacked_dims == (local,)
        held += mesh.local_coords
    assert sorted(held) == list(range(n))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


_CARD_GRID_PROG = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.launch.stencil import maybe_initialize_from_env
    rank = maybe_initialize_from_env()
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.stencil import Domain, StrategyConfig, available_strategies, make_driver
    shape, names, size, axes = (4, 2), ("pz", "py"), (32, 16, 8), ("pz", "py", None)
    one = Domain(make_mesh(shape, names, device="cuda"), size, axes)
    grid = Domain(make_mesh(shape, names, device="cuda", processes=2, process_index=rank),
                  size, axes)
    rows = list(grid.mesh.local_coords)
    x1, xg = one.random(0), grid.random(0)
    cells = [[torch.equal(x1.reshape(8, *one.local_ghosted)[rows], xg)]]
    for s in available_strategies():
        for p in ("slice", "cuda"):
            for c in (True, False):
                cfg = StrategyConfig(name=s, packer=p, coalesce=c,
                                     n_parts=4 if s == "partitioned" else 1)
                d1 = make_driver(cfg, one.mesh, one.halo_spec, ndim=3)
                dg = make_driver(cfg.with_(transport="multihost"), grid.mesh, grid.halo_spec,
                                 ndim=3)
                a, b = x1.clone(), xg.clone()
                for _ in range(3):
                    a = d1.step(a)
                a = d1.wait(a).reshape(8, *one.local_ghosted)[rows]
                _build.reset_launches()
                for _ in range(3):
                    b = dg.step(b)
                b = dg.wait(b)
                plan = getattr(dg, "plan", None)
                cells.append([s, p, c, torch.equal(a, b), plan is not None and plan.captured,
                              dict(_build.LAUNCHES)])
                d1.free()
                dg.free()
    with open(sys.argv[1] + f"/rank{rank}.json", "w") as f:
        json.dump(cells, f)
""")


@pytest.mark.cuda
def test_multihost_on_the_card_equals_loopback_bitwise(cuda, tmp_path):
    from repro_torch.launch.stencil import launch_grid

    prog = tmp_path / "card_grid.py"
    prog.write_text(_CARD_GRID_PROG)
    launch_grid([sys.executable, str(prog), str(tmp_path)], processes=2, timeout=300.0)
    for r in range(2):
        (start,), *cells = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert start, f"rank {r}: Domain.random's rows differ from the one-process draw"
        assert len(cells) == 5 * 2 * 2
        for s, p, c, equal, captured, launched in cells:
            assert equal, (r, s, p, c)
            assert not captured, (r, s, p, c)  # the grid's plans run eagerly
            want = ({"copy_convert", "gather_pack"} if c else {"copy_convert"}) if p == "cuda" \
                else set()
            assert {k for k, v in launched.items() if v} == want, (r, s, p, c, launched)
