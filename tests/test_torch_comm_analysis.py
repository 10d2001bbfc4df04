"""The port's collective accounting (``repro_torch/core/comm_analysis.py``)
against the JAX package's ``hlo_analysis``.

* The three coalescing cells of ``tests/core/test_coalesce.py`` (a fused
  3-D step on a 2x2x2 torus, a fused 2-D step on ``(4, 2)``, a 2-part
  ``partitioned`` step on ``(2, 2)``), coalesced and not: the port's
  ``count_collectives`` around one eager step of its driver gives the op
  counts and wire bytes that JAX's ``parse_collectives`` reads off the
  compiled step, and both equal the drivers' ``scheduled_collectives``.
* The stacked-rank reductions: ``partitioned_psum``,
  ``partitioned_psum_scatter``, ``partitioned_all_to_all`` and a ring
  all-gather against one jitted ``shard_map`` of JAX's (never an eager
  ``shard_map``), op counts and wire bytes equal.  XLA's all-reduce
  combiner merges the chunks of a partitioned ``psum`` into one op; the
  port counts the chunks it issues, so there only the bytes are equal.
* ``roofline`` and ``RooflineTerms`` under ``V5E`` equal JAX's; under
  ``H100`` ``mfu_bound`` divides by the H100's peak.
* With the log off nothing is recorded.

Counts and bytes are integers or exact binary fractions here, compared
with ``==``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compat as j_compat
from repro.core import hlo_analysis as j_hlo
from repro.core import partitioned as j_part
from repro.stencil import Domain as JDomain
from repro.stencil import StrategyConfig as JConfig
from repro.stencil import make_driver as j_make_driver
from repro_torch.core import comm_analysis as ca
from repro_torch.core import partitioned as t_part
from repro_torch.core import transport
from repro_torch.core.mesh import make_mesh
from repro_torch.stencil import Domain, StrategyConfig, make_driver

torch.set_num_threads(1)

#: (mesh shape, axis names, global interior, strategy, n_parts, counts
#: coalesced / not) of tests/core/test_coalesce.py:468-550
COALESCE_CELLS = {
    "fused-3d-2x2x2": ((2, 2, 2), ("px", "py", "pz"), (8, 6, 4), "fused", 1, (7, 54)),
    "fused-2d-4x2": ((4, 2), ("px", "py"), (16, 8), "fused", 1, (5, 12)),
    "partitioned-p2-2x2": ((2, 2), ("px", "py"), (8, 8), "partitioned", 2, (4, 8)),
}


def _jax_counts(key, coalesce):
    shape, names, gi, strategy, n_parts, _ = COALESCE_CELLS[key]
    mesh = j_compat.make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])
    dom = JDomain(mesh, global_interior=gi, mesh_axes=names)
    x = dom.random(0)
    drv = j_make_driver(JConfig(name=strategy, coalesce=coalesce, n_parts=n_parts), dom.mesh,
                        dom.halo_spec, ndim=len(gi))
    stats = j_hlo.parse_collectives(drv.compiled_text(x))
    scheduled = drv.scheduled_collectives(x)
    drv.free()
    return stats, scheduled


def _port_counts(key, coalesce, packer="slice"):
    shape, names, gi, strategy, n_parts, _ = COALESCE_CELLS[key]
    dom = Domain(make_mesh(shape, names, device="cpu"), gi, names)
    x = dom.random(0)
    drv = make_driver(StrategyConfig(name=strategy, coalesce=coalesce, n_parts=n_parts,
                                     packer=packer), dom.mesh, dom.halo_spec, ndim=len(gi))
    drv.init(x)
    # the plan's eager step (a graph replay on the card would log nothing)
    stats = ca.count_collectives(drv.plan.fn, x)
    scheduled = drv.scheduled_collectives(x)
    drv.free()
    return stats, scheduled


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("key", sorted(COALESCE_CELLS))
def test_coalescing_cells_equal_jax(key, coalesce):
    want, j_scheduled = _jax_counts(key, coalesce)
    got, t_scheduled = _port_counts(key, coalesce)
    expected = COALESCE_CELLS[key][-1][0 if coalesce else 1]
    assert got.by_op_counts == want.by_op_counts == {"collective-permute": expected}
    assert got.by_op_bytes == want.by_op_bytes
    assert got.wire_bytes == want.wire_bytes > 0
    assert t_scheduled == j_scheduled == expected
    assert got.summary().startswith(f"wire={got.wire_bytes/1e9:.3f}GB")


def test_count_follows_the_packers_wire():
    """The ``cuda`` packer moves the ``slice`` wire; ``bf16`` moves half of
    a float32 block's bytes in the same collectives."""
    key = "fused-2d-4x2"
    base, _ = _port_counts(key, True)
    cuda, _ = _port_counts(key, True, "cuda")
    bf16, _ = _port_counts(key, True, "bf16")
    assert cuda.by_op_counts == bf16.by_op_counts == base.by_op_counts
    assert cuda.wire_bytes == base.wire_bytes == 2 * bf16.wire_bytes


def test_standard_step_counts_its_schedule():
    """``standard`` builds its exchange every step (no plan): one step still
    issues its schedule's collectives once."""
    shape, names, gi, *_ = COALESCE_CELLS["fused-2d-4x2"]
    dom = Domain(make_mesh(shape, names, device="cpu"), gi, names)
    x = dom.random(0)
    for coalesce in (True, False):
        drv = make_driver(StrategyConfig(name="standard", coalesce=coalesce), dom.mesh,
                          dom.halo_spec, ndim=2)
        stats = ca.count_collectives(drv.step, x)
        assert stats.by_op_counts == {"collective-permute": drv.scheduled_collectives(x)}


# -- the stacked-rank reductions against jitted shard_map ---------------------

MESH, NAMES, AX, R = (2, 4), ("data", "model"), "model", 8


def _reduction_inputs():
    rng = np.random.default_rng(0)
    return dict(x=rng.normal(size=(R, 8, 4)).astype(np.float32),
                x2=rng.normal(size=(R, 8, 6)).astype(np.float32))


JAX_CELLS = {
    "psum": lambda a: j_part.partitioned_psum(a["x"], AX),
    "psum_p4": lambda a: j_part.partitioned_psum(a["x"], AX, n_parts=4),
    "psum_scatter": lambda a: j_part.partitioned_psum_scatter(a["x"], AX, scatter_axis=1),
    "all_to_all": lambda a: j_part.partitioned_all_to_all(a["x2"], AX, split_axis=0,
                                                         concat_axis=0),
    "all_to_all_p2": lambda a: j_part.partitioned_all_to_all(a["x2"], AX, split_axis=0,
                                                            concat_axis=0, n_parts=2),
    "all_gather": lambda a: j_part.ring_all_gather(a["x"], AX),
}


def _port_cell(name, t, mesh):
    return {
        "psum": lambda: t_part.partitioned_psum(t["x"], mesh, AX),
        "psum_p4": lambda: t_part.partitioned_psum(t["x"], mesh, AX, n_parts=4),
        "psum_scatter": lambda: t_part.partitioned_psum_scatter(t["x"], mesh, AX,
                                                                scatter_axis=1),
        "all_to_all": lambda: t_part.partitioned_all_to_all(t["x2"], mesh, AX, split_axis=0,
                                                            concat_axis=0),
        "all_to_all_p2": lambda: t_part.partitioned_all_to_all(t["x2"], mesh, AX, split_axis=0,
                                                               concat_axis=0, n_parts=2),
        "all_gather": lambda: t_part.ring_all_gather(t["x"], mesh, AX),
    }[name]


@pytest.fixture(scope="module")
def reduction_counts():
    """Every cell's JAX stats from its own jitted shard_map, and the port's
    count of the same cell on the stacked ranks."""
    if len(jax.devices()) < R:
        pytest.skip(f"needs {R} virtual devices (conftest)")
    a = _reduction_inputs()
    jmesh = j_compat.make_mesh(MESH, NAMES, devices=jax.devices()[:R])
    spec = P(NAMES)
    args = [jnp.asarray(a[n].reshape(-1, *a[n].shape[2:])) for n in ("x", "x2")]
    mesh = make_mesh(MESH, NAMES, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    out = {}
    for name, cell in JAX_CELLS.items():
        def inner(x, x2, cell=cell):
            return cell({"x": x, "x2": x2})

        fn = jax.jit(j_compat.shard_map(inner, mesh=jmesh, in_specs=(spec, spec),
                                        out_specs=spec))
        want = j_hlo.parse_collectives(fn.lower(*args).compile().as_text())
        got = ca.count_collectives(_port_cell(name, t, mesh))
        out[name] = (got, want)
    return out


@pytest.mark.parametrize("name", ["psum", "psum_scatter", "all_to_all", "all_to_all_p2",
                                  "all_gather"])
def test_reduction_cells_equal_jax(reduction_counts, name):
    got, want = reduction_counts[name]
    assert got.by_op_counts == want.by_op_counts
    assert got.by_op_bytes == want.by_op_bytes
    assert got.wire_bytes == want.wire_bytes > 0


def test_partitioned_psum_counts_its_chunks_where_xla_combines_them(reduction_counts):
    got, want = reduction_counts["psum_p4"]
    assert want.by_op_counts == {"all-reduce": 1}  # XLA's all-reduce combiner
    assert got.by_op_counts == {"all-reduce": 4}
    assert got.by_op_bytes == want.by_op_bytes
    assert got.wire_bytes == want.wire_bytes == reduction_counts["psum"][0].wire_bytes


def test_grouped_psum_is_an_all_reduce_over_its_group():
    """``axis_index_groups`` (the MoE hidden-split slots): the group size,
    not the axis size, sets the ring factor; a group of one is no
    collective."""
    mesh = make_mesh(MESH, NAMES, device="cpu")
    x = torch.from_numpy(_reduction_inputs()["x"])
    pairs = ca.count_collectives(t_part.partitioned_psum, x, mesh, AX,
                                 axis_index_groups=[[0, 1], [2, 3]])
    assert pairs.by_op_counts == {"all-reduce": 1}
    assert pairs.wire_bytes == 2.0 * 128 * (2 - 1) / 2
    alone = ca.count_collectives(t_part.partitioned_psum, x, mesh, AX,
                                 axis_index_groups=[[0], [1], [2], [3]])
    assert alone.by_op_counts == {} and alone.wire_bytes == 0.0


# -- the roofline ---------------------------------------------------------------

ROOFLINE_CASES = [
    dict(hlo_flops_per_device=3.1e15, hlo_bytes_per_device=4.2e11,
         wire_bytes_per_device=7.3e9, model_flops_global=2.2e16, n_chips=8),
    dict(hlo_flops_per_device=1e9, hlo_bytes_per_device=8e12,
         wire_bytes_per_device=0.0, model_flops_global=1e9, n_chips=0),
    dict(hlo_flops_per_device=0.0, hlo_bytes_per_device=0.0,
         wire_bytes_per_device=5e9, model_flops_global=0.0, n_chips=4),
]


@pytest.mark.parametrize("kw", ROOFLINE_CASES)
def test_roofline_equals_jax_under_v5e(kw):
    got, want = ca.roofline(**kw, hw=ca.V5E), j_hlo.roofline(**kw, hw=j_hlo.V5E)
    assert dataclasses.asdict(ca.V5E) == dataclasses.asdict(j_hlo.V5E)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("bottleneck", "step_time_s", "useful_flops_ratio", "mfu_bound"):
        assert getattr(got, prop) == getattr(want, prop), prop
    terms = ca.RooflineTerms(*(getattr(want, f.name) for f in dataclasses.fields(want)))
    assert terms.hw == ca.V5E and terms.mfu_bound == want.mfu_bound


def test_mfu_bound_divides_by_the_h100_peak():
    kw = ROOFLINE_CASES[0]
    got = ca.roofline(**kw, hw=ca.H100)
    assert ca.H100.peak_flops == 989e12 and ca.H100.hbm_bw == 3.35e12
    assert got.compute_s == kw["hlo_flops_per_device"] / 989e12
    assert got.mfu_bound == (kw["model_flops_global"] / 8 / 989e12) / got.step_time_s
    jax_terms = j_hlo.roofline(**kw, hw=j_hlo.Hardware(
        name="h100", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, hbm_per_chip=80e9))
    # JAX's property divides by V5E's peak whatever hw the terms came from
    assert jax_terms.mfu_bound == got.mfu_bound * 989e12 / j_hlo.V5E.peak_flops


# -- the log's switch -------------------------------------------------------------


def test_nothing_is_recorded_with_the_log_off():
    shape, names, gi, *_ = COALESCE_CELLS["fused-2d-4x2"]
    dom = Domain(make_mesh(shape, names, device="cpu"), gi, names)
    x = dom.random(0)
    drv = make_driver(StrategyConfig(name="fused", coalesce=True), dom.mesh, dom.halo_spec,
                      ndim=2)
    assert transport.OP_LOG is None
    drv.step(x)
    t_part.partitioned_psum(torch.ones(8, 2), make_mesh(MESH, NAMES, device="cpu"), AX)
    assert transport.OP_LOG is None
    outer = ca.count_collectives(lambda: (drv.step(x), ca.count_collectives(drv.step, x))[1])
    assert transport.OP_LOG is None
    inner = outer.result
    assert inner.by_op_counts == {"collective-permute": 5}
    assert outer.by_op_counts == {"collective-permute": 10}
    with pytest.raises(ZeroDivisionError):
        ca.count_collectives(lambda: 1 / 0)
    assert transport.OP_LOG is None
