"""The port's halo-exchange slice as a whole, against the JAX package.

* Every port strategy x packer x coalesce mode on 1-D, 2-D and 3-D virtual
  meshes (CPU) equals JAX ``reference_exchange`` of the same interior,
  converted to the port's stacked layout: bitwise for the exact packers,
  within the packer's ``wire_tolerance`` for the lossy ones.  Partition
  counts include ones that do not divide the face and ones beyond it.
* A few cells run end to end through JAX ``make_driver`` on the 8 virtual
  devices, periodic and not, with f32 and bf16 blocks; their stored
  outputs equal the port's bitwise (the lossy wires too: both round to
  nearest even the same way).
* Heat3d on the ``(4, 2)`` mesh at a small size: the port's
  ``comb_measure`` against the JAX one, and the port's cycles against the
  periodic numpy oracle.  Tolerance ``rtol=atol=2e-4`` on the interior, as
  ``examples/stencil_heat3d.py`` holds the JAX package (summation order
  differs), and ``1e-5`` on the checksums.  ``comb_measure`` refuses an
  exact-packer cell whose last block is one ulp off the first cell's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compat import make_mesh as j_make_mesh
from repro.kernels.stencil27 import stencil27_ref as j_stencil27_ref
from repro.stencil import Domain as JDomain
from repro.stencil import StrategyConfig as JConfig
from repro.stencil import comb_measure as j_comb_measure
from repro.stencil import make_driver as j_make_driver
from repro.stencil.domain import periodic_oracle_step
from repro.stencil.domain import reference_exchange as j_reference_exchange
from repro_torch.core.mesh import make_mesh
from repro_torch.core.transport import available_packers, get_packer
from repro_torch.kernels.stencil27 import jacobi_weights
from repro_torch.stencil import (
    Domain,
    StrategyConfig,
    available_strategies,
    comb_measure,
    make_driver,
    reference_exchange,
    stacked_from_stored,
    stored_from_stacked,
)
from repro_torch.stencil.heat3d import heat3d_update

torch.set_num_threads(1)

#: (mesh shape, axis names, global interior, domain axes, halo)
MESHES = {
    "1d": ((4,), ("px",), (12,), ("px",), 1),
    "2d": ((4, 2), ("pz", "py"), (12, 6, 5), ("pz", "py", None), 1),
    "3d": ((2, 2, 2), ("px", "py", "pz"), (8, 10, 6), ("px", "py", "pz"), 2),
}


def _port_domain(key, dtype="float32"):
    shape, names, gi, axes, halo = MESHES[key]
    return Domain(make_mesh(shape, names, device="cpu"), gi, axes, halo=halo, dtype=dtype)


def _jax_domain(key, dtype="float32"):
    shape, names, gi, axes, halo = MESHES[key]
    mesh = j_make_mesh(shape, names, devices=jax.devices()[: int(np.prod(shape))])
    return JDomain(mesh, gi, axes, halo=halo, dtype=dtype)


def _interior(domain, seed=0):
    return np.random.default_rng(seed).normal(size=domain.global_interior).astype(np.float32)


def test_layout_converters_roundtrip_and_match_jax_stored_layout():
    for key in MESHES:
        d, jd = _port_domain(key), _jax_domain(key)
        interior = _interior(d)
        stored = jd.stored_from_interior(interior)
        stacked = stacked_from_stored(d, stored)
        assert tuple(stacked.shape) == d.stacked_shape
        np.testing.assert_array_equal(stored_from_stacked(d, stacked), stored)
        np.testing.assert_array_equal(stored_from_stacked(d, d.from_global_interior(interior)), stored)
        np.testing.assert_array_equal(d.to_global_interior(stacked), interior)
        assert d.face_bytes() == jd.face_bytes()
        np.testing.assert_array_equal(
            stored_from_stacked(d, reference_exchange(d, interior)),
            j_reference_exchange(jd, interior))


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("packer", ["slice", "cuda", "bf16", "scaled-int8"])
@pytest.mark.parametrize("strategy", ["standard", "persistent", "partitioned", "fused", "overlap"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_strategy_matches_jax_reference_exchange(mesh, strategy, packer, coalesce):
    d, jd = _port_domain(mesh), _jax_domain(mesh)
    interior = _interior(d, seed=len(strategy))
    want = j_reference_exchange(jd, interior)
    rtol, atol = get_packer(packer).wire_tolerance(d.dtype)
    for n_parts in ((3, 7) if strategy == "partitioned" else (1,)):
        drv = make_driver(StrategyConfig(name=strategy, n_parts=n_parts, packer=packer,
                                         coalesce=coalesce),
                          d.mesh, d.halo_spec, ndim=len(d.global_interior))
        got = stored_from_stacked(d, drv.wait(drv.step(d.from_global_interior(interior))))
        drv.free()
        msg = f"{strategy} {packer} coalesce={coalesce} n_parts={n_parts} {mesh}"
        if rtol == 0.0 and atol == 0.0:
            np.testing.assert_array_equal(got, want, err_msg=msg)
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=msg)


def test_every_registered_strategy_and_packer_is_covered():
    assert set(available_strategies()) == {"standard", "persistent", "partitioned", "fused", "overlap"}
    assert set(available_packers()) == {"slice", "cuda", "bf16", "scaled-int8"}


#: (mesh, strategy, JAX packer, port packer, coalesce, n_parts, periodic,
#: block dtype): every strategy non-periodic, and bf16 blocks through exact
#: and lossy wires, as the sweep drives them
DRIVER_CELLS = [
    ("2d", "partitioned", "pallas", "cuda", True, 3, True, "float32"),
    ("3d", "fused", "pallas", "cuda", False, 1, True, "float32"),
    ("2d", "persistent", "bf16", "bf16", True, 1, True, "float32"),
    ("3d", "partitioned", "scaled-int8", "scaled-int8", False, 4, True, "float32"),
    ("1d", "standard", "slice", "slice", True, 1, False, "float32"),
    ("2d", "fused", "pallas", "cuda", True, 1, False, "float32"),
    ("2d", "standard", "pallas", "cuda", False, 1, False, "float32"),
    ("3d", "persistent", "slice", "slice", True, 1, False, "float32"),
    ("3d", "partitioned", "pallas", "cuda", True, 3, False, "float32"),
    ("2d", "overlap", "bf16", "bf16", False, 1, False, "float32"),
    ("2d", "persistent", "pallas", "cuda", True, 1, True, "bfloat16"),
    ("3d", "fused", "slice", "slice", False, 1, False, "bfloat16"),
    ("2d", "partitioned", "bf16", "bf16", False, 3, True, "bfloat16"),
    ("1d", "overlap", "scaled-int8", "scaled-int8", True, 1, True, "bfloat16"),
]


def _cell_id(cell):
    """The cell's values joined; f32 cells keep their ids from before the
    dtype column."""
    *head, dtype = cell
    return "-".join(map(str, head)) + ("" if dtype == "float32" else f"-{dtype}")


@pytest.mark.parametrize("mesh,strategy,jp,tp,coalesce,n_parts,periodic,dtype", DRIVER_CELLS,
                         ids=[_cell_id(c) for c in DRIVER_CELLS])
def test_port_equals_jax_driver_bitwise(mesh, strategy, jp, tp, coalesce, n_parts, periodic,
                                        dtype):
    d, jd = _port_domain(mesh, dtype), _jax_domain(mesh, dtype)
    interior = _interior(d, seed=7)
    jdrv = j_make_driver(JConfig(name=strategy, n_parts=n_parts, packer=jp, coalesce=coalesce),
                         jd.mesh, lambda: jd.halo_spec().with_(periodic=periodic),
                         ndim=len(jd.global_interior))
    want = np.asarray(jdrv.wait(jdrv.step(jd.from_global_interior(interior))), np.float32)
    jdrv.free()
    drv = make_driver(StrategyConfig(name=strategy, n_parts=n_parts, packer=tp, coalesce=coalesce),
                      d.mesh, lambda: d.halo_spec().with_(periodic=periodic),
                      ndim=len(d.global_interior))
    got = stored_from_stacked(d, drv.wait(drv.step(d.from_global_interior(interior))))
    np.testing.assert_array_equal(got, want)


def test_persistent_plan_holds_tables_and_buffers():
    d = _port_domain("2d")
    drv = make_driver(StrategyConfig(name="partitioned", n_parts=3, packer="cuda"),
                      d.mesh, d.halo_spec, ndim=3)
    x = d.from_global_interior(_interior(d))
    drv.init(x)
    plan = drv.plan
    assert plan.schedule.tag() == "sequential[pzxpy]@cuda/loopback+coalesced"
    assert plan.wire_layouts == drv.wire_layouts(x) == tuple(plan.exchange.layouts)
    assert drv.scheduled_collectives(x) == len(plan.wire_layouts)
    out = drv.step(x)
    assert out.data_ptr() == x.data_ptr()  # donated: updated in place
    drv.free()


def test_overlap_never_writes_its_input():
    d = _port_domain("2d")
    upd = heat3d_update(jacobi_weights(), d.device)
    drv = make_driver("overlap", d.mesh, d.halo_spec, ndim=3, update_fn=upd)
    x = d.from_global_interior(_interior(d))
    before = x.clone()
    y = drv.step(x)
    z = drv.step(y)
    assert torch.equal(x, before)
    assert y.data_ptr() != x.data_ptr() and z.data_ptr() not in (x.data_ptr(), y.data_ptr())


def _jax_heat_update(w):
    def update(xl):
        xp = jnp.concatenate([xl[..., -1:], xl, xl[..., :1]], axis=-1)
        return jax.lax.dynamic_update_slice(xl, j_stencil27_ref(xp, jnp.asarray(w)), (1, 1, 0))
    return update


HEAT = ((4, 2), ("pz", "py"), (16, 8, 6))


def test_heat3d_comb_measure_matches_jax_and_oracle(monkeypatch):
    w = jacobi_weights().numpy()
    jmesh = j_make_mesh(HEAT[0], HEAT[1])
    jd = JDomain(jmesh, HEAT[2], ("pz", "py", None))
    d = Domain(make_mesh(HEAT[0], HEAT[1], device="cpu"), HEAT[2], ("pz", "py", None))
    # the port draws its own state from torch generators; hand it the JAX draw
    monkeypatch.setattr(Domain, "random", lambda self, seed=0: self.from_global_interior(
        np.random.default_rng(seed).normal(size=self.global_interior).astype(np.float32)))
    strategies = ("standard", "persistent", "partitioned", "fused", "overlap")
    kw = dict(n_parts=3, n_cycles=2, repeats=1)
    jres = j_comb_measure(jd, strategies=tuple(JConfig(name=s, packer="pallas", n_parts=3 if s == "partitioned" else 1) for s in strategies),
                          update_fn=_jax_heat_update(w), **kw)
    tres = comb_measure(d, strategies=tuple(StrategyConfig(name=s, packer="cuda", n_parts=3 if s == "partitioned" else 1) for s in strategies),
                        update_fn=heat3d_update(w, d.device), **kw)
    assert [k.replace("@pallas", "") for k in jres] == [k.replace("@cuda", "") for k in tres]
    for (jk, jr), (tk, tr) in zip(jres.items(), tres.items()):
        assert tr.collective_count == jr.collective_count, tk
        assert tr.n_cycles == jr.n_cycles and tr.init_us >= 0 and tr.device == "cpu"
        np.testing.assert_allclose(tr.checksum, jr.checksum, rtol=1e-5, atol=1e-5, err_msg=tk)

    interior = np.random.default_rng(0).normal(size=HEAT[2]).astype(np.float32)
    want = interior.copy()
    for _ in range(3):
        want = periodic_oracle_step(want, w)
    for s in strategies:
        drv = make_driver(StrategyConfig(name=s, packer="cuda", n_parts=3), d.mesh,
                          d.halo_spec, ndim=3, update_fn=heat3d_update(w, d.device))
        x = d.from_global_interior(interior)
        for _ in range(3):
            x = drv.step(x)
        np.testing.assert_allclose(d.to_global_interior(drv.wait(x)), want,
                                   rtol=2e-4, atol=2e-4, err_msg=s)


@pytest.mark.parametrize("packer,raises", [("cuda", True), ("bf16", False)])
def test_comb_measure_holds_exact_cells_bitwise(monkeypatch, packer, raises):
    """One ulp off in one element of a cell's last block moves the checksum
    far less than its tolerance; ``comb_measure`` still refuses it for an
    exact packer, and leaves a lossy packer to the checksum check."""
    from repro_torch.stencil import comb

    d = Domain(make_mesh(HEAT[0], HEAT[1], device="cpu"), HEAT[2], ("pz", "py", None))
    real = comb.run_cycles

    def off_by_one_ulp(driver, x, **kw):
        res, final = real(driver, x, **kw)
        if driver.config.packer == packer:
            final = final.clone()
            flat = final.view(-1)
            flat[7] = torch.nextafter(flat[7], torch.tensor(float("inf")))
        return res, final

    monkeypatch.setattr(comb, "run_cycles", off_by_one_ulp)
    strategies = (StrategyConfig(name="standard", packer="slice"),
                  StrategyConfig(name="persistent", packer="cuda"),
                  StrategyConfig(name="persistent", packer="bf16"))
    if raises:
        with pytest.raises(AssertionError, match="persistent@cuda's block differs from standard"):
            comb_measure(d, strategies=strategies, n_cycles=1, repeats=1)
    else:
        assert len(comb_measure(d, strategies=strategies, n_cycles=1, repeats=1)) == 3


def test_exchange_driver_facade_and_deliver():
    """``ExchangeDriver`` lifts the strategy from the spec; ``deliver`` is one
    group of ``exchange_messages``; both equal the reference."""
    from repro_torch.core.halo import sequential_message_groups
    from repro_torch.core.transport import deliver
    from repro_torch.stencil import ExchangeDriver

    d, jd = _port_domain("2d"), _jax_domain("2d")
    interior = _interior(d, seed=3)
    want = j_reference_exchange(jd, interior)
    drv = ExchangeDriver(d.mesh, lambda: d.halo_spec("partitioned", n_parts=3), ndim=3)
    assert drv.strategy == "partitioned" and drv.n_parts == 3
    got = stored_from_stacked(d, drv.wait(drv.step(d.from_global_interior(interior))))
    np.testing.assert_array_equal(got, want)
    x = d.from_global_interior(interior)
    xb = x.view(d.mesh.size, *d.local_ghosted)
    for group in sequential_message_groups(d.local_ghosted, d.halo_spec(), d.mesh.shape):
        deliver(xb, group, mesh=d.mesh, packer="cuda", coalesce=True)
    np.testing.assert_array_equal(stored_from_stacked(d, x), want)


@pytest.mark.filterwarnings("ignore:CUDA is not available")
def test_device_breakdown_needs_the_card():
    """The profiler breakdown reads device activity only; a CPU run has none
    and must say so rather than report a CPU time as a device time."""
    from repro_torch.stencil.comb import device_breakdown

    d = _port_domain("1d")
    drv = make_driver("persistent", d.mesh, d.halo_spec, ndim=1)
    with pytest.raises(RuntimeError, match="no device activity"):
        device_breakdown(drv, d.from_global_interior(_interior(d)))
