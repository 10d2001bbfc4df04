"""The port's ``train/fault_tolerance.py`` against the JAX package's.

* The injector, heartbeat-ledger and straggler cases of JAX
  ``tests/train/test_fault_tolerance.py`` (not the training ones), run on
  both packages' classes with the same inputs, and the random failure path
  held step for step against JAX's over seeds and phases.
* ``reshard_state``: grow 4 -> 8, shrink 8 -> 6, 2 -> 6 and 12 rows from 4
  ranks to 6 (shard sizes that do not divide each other): each port rank's
  row of the stacked layout equals the matching JAX device shard bitwise;
  a 2-D mesh with a replicated axis, a grid mesh's own rows, bf16 and int
  leaves.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.train import fault_tolerance as j_ft
from repro_torch.core.mesh import make_mesh
from repro_torch.train import fault_tolerance as t_ft

torch.set_num_threads(1)

PACKAGES = {"jax": j_ft, "torch": t_ft}
pkgs = pytest.mark.parametrize("ft", list(PACKAGES.values()), ids=list(PACKAGES))


# ---------------------------------------------------------------------------
# the injector, ledger and straggler monitor (both packages, same cases)
# ---------------------------------------------------------------------------


@pkgs
def test_injector_raises_once_per_step(ft):
    inj = ft.FailureInjector(fail_at_steps=(2,))
    inj.check(1)
    with pytest.raises(ft.SimulatedFailure):
        inj.check(2)
    inj.check(2)  # second pass after restart: no refire


@pkgs
def test_injector_phase_filter_and_keying(ft):
    inj = ft.FailureInjector(fail_at_steps=(2,), phases=("mid-exchange",))
    inj.check(2)
    inj.check(2, phase="pre-step")
    with pytest.raises(ft.SimulatedFailure):
        inj.check(2, phase="mid-exchange")
    inj.check(2, phase="mid-exchange")
    inj2 = ft.FailureInjector(fail_at_steps=(2, 5), phases=("mid-exchange",))
    with pytest.raises(ft.SimulatedFailure):
        inj2.check(2, phase="mid-exchange")
    with pytest.raises(ft.SimulatedFailure):
        inj2.check(5, phase="mid-exchange")


def _fired_steps(ft, inj, phase, n=64):
    fired = []
    for step in range(n):
        try:
            inj.check(step, phase=phase)
        except ft.SimulatedFailure:
            fired.append(step)
    return fired


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("phase", [None, "mid-exchange", "plan-build:round"])
@pytest.mark.parametrize("probability", [0.1, 0.25, 0.6])
def test_random_failures_fire_on_the_same_steps_as_jax(seed, phase, probability):
    got = {name: _fired_steps(ft, ft.FailureInjector(probability=probability, seed=seed), phase)
           for name, ft in PACKAGES.items()}
    assert got["torch"] == got["jax"] and got["jax"]


@pkgs
def test_injector_probability_path_is_deterministic_and_dedups(ft):
    a = _fired_steps(ft, ft.FailureInjector(probability=0.25, seed=7), "mid-exchange")
    b = _fired_steps(ft, ft.FailureInjector(probability=0.25, seed=7), "mid-exchange")
    assert a == b and a
    inj = ft.FailureInjector(probability=0.25, seed=7)
    assert _fired_steps(ft, inj, "mid-exchange") == a
    assert _fired_steps(ft, inj, "mid-exchange") == []
    assert {(s, "mid-exchange") for s in a} <= inj._fired
    c = _fired_steps(ft, ft.FailureInjector(probability=0.25, seed=7, phases=()), "mid-exchange")
    d = _fired_steps(ft, ft.FailureInjector(probability=0.25, seed=7), "plan-build:round")
    assert c != d


@pkgs
def test_injector_disabled_never_fires(ft):
    inj = ft.FailureInjector(fail_at_steps=(0, 1), probability=1.0, enabled=False)
    for step in range(4):
        inj.check(step, phase="mid-exchange")
    assert not inj._fired


@pkgs
def test_join_phase_scope_cannot_fire_in_steady_state(ft):
    inj = ft.FailureInjector(probability=1.0, phases=("join",), seed=3)
    for step in range(3):
        inj.check(step)
    with pytest.raises(ft.SimulatedFailure):
        with inj.phase_scope("join"):
            inj.check(3)
    for step in range(4, 50):
        inj.check(step)
    assert inj._fired == {(3, "join")}
    assert inj._active_phase is None


@pkgs
def test_phase_scope_explicit_tags_win_and_scopes_nest(ft):
    inj = ft.FailureInjector(fail_at_steps=(5,), phases=("mid-exchange",))
    with pytest.raises(ft.SimulatedFailure):
        with inj.phase_scope("join"):
            inj.check(5, phase="mid-exchange")
    assert (5, "mid-exchange") in inj._fired
    inj2 = ft.FailureInjector(fail_at_steps=(1,), phases=("inner",))
    with inj2.phase_scope("outer"):
        with pytest.raises(ft.SimulatedFailure):
            with inj2.phase_scope("inner"):
                inj2.check(1)
        assert inj2._active_phase == "outer"
        inj2.check(1)
    assert inj2._fired == {(1, "inner")}


@pkgs
def test_heartbeat_ledger_timeout_window(ft):
    ledger = ft.HeartbeatLedger(timeout=1.0)
    ledger.beat(0, 0.0)
    ledger.beat(1, 0.0, step=4)
    assert ledger.missing(0.5) == ()
    ledger.beat(0, 1.0)
    assert ledger.missing(1.5) == (1,)
    assert ledger.last(1) == ft.Heartbeat(rank=1, when=0.0, step=4)
    assert ledger.evict(1) and not ledger.evict(1)
    assert ledger.ranks == (0,) and len(ledger) == 1
    assert 0 in ledger and 1 not in ledger


@pkgs
def test_epoch_bump_rejects_unknown_causes(ft):
    for cause in ("form", "join", "loss"):
        assert ft.EpochBump(epoch=1, cause=cause).cause == cause
    with pytest.raises(AssertionError):
        ft.EpochBump(epoch=1, cause="oops")


@pkgs
def test_straggler_monitor_flags_outliers(ft):
    mon = ft.StragglerMonitor(ewma=0.5, factor=2.0)
    hits = []
    mon.on_straggler = lambda s, t, m: hits.append(s)
    for step in range(10):
        mon.observe(step, 0.1)
    assert not mon.flagged
    assert mon.observe(10, 0.5)
    assert mon.flagged and hits == [10]
    assert not mon.observe(11, 0.1)


def test_straggler_monitor_tracks_jax_on_a_noisy_series():
    times = np.random.default_rng(3).lognormal(mean=-3.0, sigma=0.6, size=200)
    mons = {name: ft.StragglerMonitor(ewma=0.8, factor=2.0) for name, ft in PACKAGES.items()}
    flags = {name: [m.observe(i, float(t)) for i, t in enumerate(times)]
             for name, m in mons.items()}
    assert flags["torch"] == flags["jax"] and any(flags["jax"])
    assert mons["torch"].flagged == mons["jax"].flagged
    assert mons["torch"]._mean == mons["jax"]._mean


@pkgs
def test_run_with_restarts_retries_then_raises(ft):
    calls, restarts = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ft.SimulatedFailure("lost")
        return "done"

    assert ft.run_with_restarts(flaky, max_restarts=3, on_restart=restarts.append) == "done"
    assert restarts == [1, 2]

    def dead():
        raise ft.SimulatedFailure("always")

    with pytest.raises(ft.SimulatedFailure):
        ft.run_with_restarts(dead, max_restarts=1)


# ---------------------------------------------------------------------------
# reshard_state against JAX device shards
# ---------------------------------------------------------------------------


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _assert_rows_equal_jax_shards(stacked: torch.Tensor, jarr, jmesh):
    """Row ``coords`` of the port's stacked layout == the JAX shard on the
    device at those mesh coordinates, bitwise."""
    devs = jmesh.devices
    shards = {s.device: s for s in jarr.addressable_shards}
    for coords in np.ndindex(devs.shape):
        want = np.asarray(shards[devs[coords]].data)
        got = stacked[coords]
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.uint16).view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def _tree():
    rng = np.random.default_rng(7)
    return {"w": rng.normal(size=(24, 4)).astype(np.float32),
            "b": rng.normal(size=(24,)).astype(np.float32)}


SPECS = {"w": ("data", None), "b": ("data",)}


@pytest.mark.parametrize("n_old,n_new", [(4, 8), (8, 6), (2, 6)])
def test_reshard_state_across_unequal_meshes_equals_jax_shards(n_old, n_new):
    tree = _tree()
    jspecs = {k: P(*v) for k, v in SPECS.items()}
    jold = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(_jax_mesh((n_old,), ("data",)), s)),
        tree, jspecs)
    jmesh = _jax_mesh((n_new,), ("data",))
    jout = j_ft.reshard_state(jold, jmesh, jspecs)
    old_mesh = make_mesh((n_old,), ("data",), device="cpu")
    new_mesh = make_mesh((n_new,), ("data",), device="cpu")
    old = t_ft.reshard_state(tree, old_mesh, SPECS)
    for k in tree:
        assert tuple(old[k].shape) == (n_old, 24 // n_old, *tree[k].shape[1:])
        _assert_rows_equal_jax_shards(old[k], jold[k], _jax_mesh((n_old,), ("data",)))
    out = t_ft.reshard_state(old, new_mesh, SPECS, old_mesh=old_mesh)
    for k in tree:
        assert tuple(out[k].shape) == (n_new, 24 // n_new, *tree[k].shape[1:])
        _assert_rows_equal_jax_shards(out[k], jout[k], jmesh)


def test_reshard_state_non_dividing_shard_sizes_equals_jax_shards():
    x = np.arange(12 * 5, dtype=np.float32).reshape(12, 5)
    spec = ("data", None)
    jold = jax.device_put(x, NamedSharding(_jax_mesh((4,), ("data",)), P(*spec)))
    jmesh = _jax_mesh((6,), ("data",))
    jout = j_ft.reshard_state(jold, jmesh, P(*spec))
    old_mesh = make_mesh((4,), ("data",), device="cpu")
    old = t_ft.reshard_state(x, old_mesh, spec)
    out = t_ft.reshard_state(old, make_mesh((6,), ("data",), device="cpu"), spec,
                             old_mesh=old_mesh)
    assert tuple(out.shape) == (6, 2, 5)
    _assert_rows_equal_jax_shards(out, jout, jmesh)


@pytest.mark.parametrize("spec", [("x", "y"), ("y", None), (None, "x"), (None, None)])
def test_reshard_state_on_a_2d_mesh_equals_jax_shards(spec):
    x = np.random.default_rng(1).normal(size=(8, 12)).astype(np.float32)
    jmesh = _jax_mesh((2, 2), ("x", "y"))
    jout = jax.device_put(x, NamedSharding(jmesh, P(*spec)))
    mesh = make_mesh((2, 2), ("x", "y"), device="cpu")
    out = t_ft.reshard_state({"a": x}, mesh, {"a": spec})["a"]
    _assert_rows_equal_jax_shards(out, jout, jmesh)
    # and on to a (4, 1) mesh under the same spec
    mesh41 = make_mesh((4, 1), ("x", "y"), device="cpu")
    back = t_ft.reshard_state(out, mesh41, spec, old_mesh=mesh)
    jmesh41 = _jax_mesh((4, 1), ("x", "y"))
    _assert_rows_equal_jax_shards(back, j_ft.reshard_state(jout, jmesh41, P(*spec)), jmesh41)


def test_reshard_state_keeps_dtypes_and_owns_its_memory():
    w = torch.randn(12, 4).to(torch.bfloat16)
    i = torch.arange(12, dtype=torch.int64)
    state = (w, [i, None])
    mesh = make_mesh((3,), ("data",), device="cpu")
    out = t_ft.reshard_state(state, mesh, (("data", None), [("data",), None]))
    assert out[0].dtype == torch.bfloat16 and out[1][0].dtype == torch.int64
    assert out[1][1] is None
    assert torch.equal(out[0].reshape(12, 4), w) and torch.equal(out[1][0].reshape(12), i)
    w.add_(1)  # the result is a copy, not a view of the input
    assert not torch.equal(out[0].reshape(12, 4), w)


def test_reshard_state_onto_a_grid_mesh_keeps_this_process_rows():
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    whole = t_ft.reshard_state(x, make_mesh((4,), ("px",), device="cpu"), ("px", None))
    for index in range(2):
        grid = make_mesh((4,), ("px",), device="cpu", processes=2, process_index=index)
        rows = t_ft.reshard_state(x, grid, ("px", None))
        assert torch.equal(rows, whole[list(grid.local_coords)])
        with pytest.raises(ValueError, match="own rows"):
            t_ft.reshard_state(rows, make_mesh((2,), ("px",), device="cpu"), ("px", None),
                               old_mesh=grid)


def test_reshard_state_rejects_what_does_not_split():
    mesh = make_mesh((5,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        t_ft.reshard_state(np.zeros((12, 2), np.float32), mesh, ("data", None))
    with pytest.raises(ValueError, match="does not name"):
        t_ft.reshard_state(np.zeros((10, 2), np.float32), mesh, ("data",))
