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
"""

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
