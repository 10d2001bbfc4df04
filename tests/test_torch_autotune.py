"""The port's autotuner and ``auto`` strategy, against the JAX package.

* ``TraceCostModel.fit`` coefficients, ``Tuner.choose`` verdicts
  (candidate, tier, ``predicted_us``), ``cell_key``, ``default_candidates``
  and ``choose_mapping`` equal JAX's on the same inputs: the committed
  ``BENCH_stencil_sweep.json`` records fed to both as plain data, ``pallas``
  renamed ``cuda`` on the port's side.
* A calibration verdict round-trips through ``AutotuneCache``; a failing
  probe ends the calibration with its error and caches nothing; a corrupt
  cache file reads as empty; a verdict taken on one device never resolves a
  cell of another, and the cost model of one device never scores another's.
* ``AutoStrategy`` on a CPU mesh resolves by trace to the same candidate as
  JAX ``AutoStrategy`` on the same trace and mesh, and its output equals
  ``reference_exchange`` bitwise; without a trace it calibrates, and a
  second driver on the same cache replays the verdict.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import autotune as j_at
from repro.core.compat import make_mesh as j_make_mesh
from repro.stencil import Domain as JDomain
from repro.stencil import make_driver as j_make_driver
from repro.stencil.strategies import StrategyConfig as JConfig
from repro_torch.core import autotune as t_at
from repro_torch.core.mesh import make_mesh
from repro_torch.stencil import Domain, StrategyConfig, make_driver, reference_exchange
from repro_torch.stencil.strategies import AutoStrategy

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = ROOT / "BENCH_stencil_sweep.json"
PACKER = {"pallas": "cuda"}


def _jax_records():
    return json.loads(BASELINE.read_text())["records"]


def _port_record(r, device=None):
    out = dict(r, packer=PACKER.get(r["packer"], r["packer"]))
    if device is not None:
        out["device"] = device
    return out


def _port_cand(c):
    return t_at.Candidate(c.strategy, PACKER.get(c.packer, c.packer), c.coalesce, c.n_parts)


def _jax_cell(**kw):
    cell = dict(mesh_shape=(2, 2), shape=(20, 12), dtype="float32", halo=1,
                mapping="row-major", transport="ppermute", node_size=2, message_bytes=40)
    cell.update(kw)
    return cell


@pytest.fixture
def env(tmp_path, monkeypatch):
    """Both packages' tuners pointed at nothing but ``tmp_path``."""
    for var in (j_at.TRACE_ENV, t_at.TRACE_ENV):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(j_at.CACHE_ENV, str(tmp_path / "jax_autotune.json"))
    monkeypatch.setenv(t_at.CACHE_ENV, str(tmp_path / "torch_autotune.json"))
    j_at.reset_default_tuners()
    t_at.reset_default_tuners()
    yield tmp_path
    j_at.reset_default_tuners()
    t_at.reset_default_tuners()


def test_cost_model_fit_equals_jax_on_the_committed_trace():
    recs = _jax_records()
    jm = j_at.TraceCostModel.fit(recs)
    tm = t_at.TraceCostModel.fit([_port_record(r) for r in recs])
    strategies = sorted({r["strategy"] for r in recs})
    for s in strategies:
        assert tm.covers(s) and jm.covers(s)
        np.testing.assert_array_equal(tm._coefs[s], jm._coefs[s], err_msg=s)
        assert tm.locality_costs(s) == jm.locality_costs(s)
        feats = (100, 4, 8, 8)
        assert (tm.predict(s, t_at.CellFeatures(*feats))
                == jm.predict(s, j_at.CellFeatures(*feats)))
    rows = np.random.default_rng(0).normal(size=(12, 5))
    y = rows @ np.array([1.0, -2.0, 0.5, 3.0, -1.0])
    np.testing.assert_array_equal(t_at._fit_nonneg(rows, y), j_at._fit_nonneg(rows, y))


def test_default_candidates_equal_jax_and_exclude_lossy_packers():
    for dtype in ("float32", "bfloat16"):
        got = t_at.default_candidates(dtype=dtype)
        want = tuple(_port_cand(c) for c in j_at.default_candidates(dtype=dtype))
        assert got == want, dtype
    assert {c.packer for c in t_at.default_candidates()} == {"slice", "cuda"}
    pinned = t_at.default_candidates(strategies=("partitioned",), packers=("cuda",),
                                     coalesce_modes=(True,), part_counts=(3,))
    assert pinned == (t_at.Candidate("partitioned", "cuda", True, 3),)


#: (cell overrides, expected tier): the committed cells, an unswept size
#: (nearest swept size + the model's delta) and an unswept mesh (model only)
CHOOSE_CASES = [
    (dict(), "trace"),
    (dict(mapping="blocked"), "trace"),
    (dict(message_bytes=160), "trace-nearest"),
    (dict(mesh_shape=(4, 2), node_size=4, message_bytes=40), "model"),
]


@pytest.mark.parametrize("overrides,tier", CHOOSE_CASES)
def test_tuner_verdicts_equal_jax(overrides, tier):
    recs = _jax_records()
    jt = j_at.Tuner(recs)
    tt = t_at.Tuner([_port_record(r) for r in recs])
    jc = j_at.default_candidates()
    rng = np.random.default_rng(len(str(overrides)))
    feats = {c: tuple(int(v) for v in rng.integers(1, 64, size=4)) for c in jc}
    jv = jt.choose(jc, {c: j_at.CellFeatures(*f) for c, f in feats.items()}, _jax_cell(**overrides))
    tv = tt.choose(tuple(_port_cand(c) for c in jc),
                   {_port_cand(c): t_at.CellFeatures(*f) for c, f in feats.items()},
                   _jax_cell(**overrides))
    assert jv.selected_by == tv.selected_by == tier
    assert tv.candidate == _port_cand(jv.candidate)
    assert tv.predicted_us == jv.predicted_us


def test_cell_key_equals_jax_and_carries_the_device():
    cands = j_at.default_candidates(packers=("slice",))
    tc = tuple(_port_cand(c) for c in cands)
    assert t_at.cell_key(_jax_cell(), tc) == j_at.cell_key(_jax_cell(), cands)
    assert t_at.cell_key(_jax_cell(), tc[::-1]) == t_at.cell_key(_jax_cell(), tc)
    keyed = t_at.cell_key(_jax_cell(device="cpu"), tc)
    assert keyed == j_at.cell_key(_jax_cell(), cands) + "|device=cpu"
    assert keyed != t_at.cell_key(_jax_cell(device="NVIDIA H100 80GB HBM3"), tc)


@pytest.mark.parametrize("periodic", [True, False])
def test_choose_mapping_equals_jax(periodic):
    for shape in ((2, 2), (4, 2), (2, 4), (8,), (2, 2, 2), (4, 4), (3, 6)):
        for node_size in (1, 2, 3, 4, 6):
            assert (t_at.choose_mapping(shape, node_size, periodic)
                    == j_at.choose_mapping(shape, node_size, periodic)), (shape, node_size)


def test_calibration_round_trips_through_the_cache(tmp_path):
    path = str(tmp_path / "autotune.json")
    cands = t_at.default_candidates(strategies=("standard", "fused"), packers=("slice",))
    cell = _jax_cell(device="cpu")
    times = {c: 10.0 + i for i, c in enumerate(cands)}
    times[cands[2]] = 1.0
    probed = []

    def probe(c):
        probed.append(c)
        return times[c]

    first = t_at.Tuner(cache=t_at.AutotuneCache(path)).calibrate(cands, cell, probe)
    assert first.selected_by == "calibration" and first.candidate == cands[2]
    assert first.predicted_us == 1.0 and first.calibration_us > 0.0
    assert first.plan_stamp() == "calibration" and len(probed) == len(cands)
    again = t_at.Tuner(cache=t_at.AutotuneCache(path)).calibrate(cands, cell, probe)
    assert again.selected_by == "cache" and again.candidate == first.candidate
    assert again.predicted_us == 1.0 and again.calibration_us == 0.0
    assert again.plan_stamp() == "calibration" and len(probed) == len(cands)
    # a verdict taken on the CPU never resolves a cell on another device
    other = t_at.Tuner(cache=t_at.AutotuneCache(path)).calibrate(
        cands, dict(cell, device="NVIDIA H100 80GB HBM3"), probe)
    assert other.selected_by == "calibration" and len(probed) == 2 * len(cands)
    assert len(t_at.AutotuneCache(path)) == 2


def test_a_failing_probe_ends_calibration(tmp_path):
    """A probe error (a kernel that fails to build or launch) propagates:
    the cell is never handed to another packer, and nothing is cached."""
    path = str(tmp_path / "autotune.json")
    cands = t_at.default_candidates(strategies=("standard", "fused"))
    assert {c.packer for c in cands} == {"slice", "cuda"}
    probed = []

    def probe(c):
        probed.append(c)
        if c.packer == "cuda":
            raise RuntimeError("copy_convert: CUDA error 209 at launch")
        return 1.0

    feats = {c: t_at.CellFeatures(wire_bytes=4096, collective_count=4, intra_sends=8,
                                  inter_sends=8) for c in cands}
    tuner = t_at.Tuner(cache=t_at.AutotuneCache(path))
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        tuner.choose_or_calibrate(cands, feats, _jax_cell(device="cpu"), probe)
    assert probed[-1].packer == "cuda" and len(probed) < len(cands)
    assert len(t_at.AutotuneCache(path)) == 0


def test_corrupt_cache_reads_as_empty(tmp_path):
    path = tmp_path / "autotune.json"
    for text in ("{not json", "[1, 2]", ""):
        path.write_text(text)
        cache = t_at.AutotuneCache(str(path))
        assert len(cache) == 0 and cache.get("k") is None
    cache.put("k", {"strategy": "fused"})
    assert t_at.AutotuneCache(str(path)).get("k") == {"strategy": "fused"}


def test_trace_of_one_device_never_scores_another():
    recs = [_port_record(r, device="cpu") for r in _jax_records()]
    tuner = t_at.Tuner(recs)
    cands = tuple(_port_cand(c) for c in j_at.default_candidates())
    feats = {c: t_at.CellFeatures(40, 4, 8, 8) for c in cands}
    assert tuner.choose(cands, feats, _jax_cell(device="cpu")).selected_by == "trace"
    assert tuner.choose(cands, feats, _jax_cell(device="NVIDIA H100 80GB HBM3")) is None
    assert t_at.Tuner([_port_record(r) for r in recs[:1]] + [
        dict(recs[1], selected_by="trace")]).trace == [_port_record(recs[0])]


def test_default_tuner_reads_the_ports_own_env(env, monkeypatch):
    trace = env / "BENCH_trace.json"
    trace.write_text(json.dumps({"config": None, "records": [
        _port_record(r, device="cpu") for r in _jax_records()]}))
    monkeypatch.setenv(j_at.TRACE_ENV, str(trace))  # the JAX package's: ignored
    assert t_at.default_tuner().trace == []
    assert t_at.default_tuner() is t_at.default_tuner()
    monkeypatch.setenv(t_at.TRACE_ENV, str(trace))
    tuner = t_at.default_tuner()
    assert len(tuner.trace) == 96 and tuner.cache.path == str(env / "torch_autotune.json")
    monkeypatch.delenv(t_at.CACHE_ENV)
    assert t_at.default_cache_path().endswith("/.cache/repro_torch/autotune.json")


# ---------------------------------------------------------------------------
# AutoStrategy against JAX AutoStrategy
# ---------------------------------------------------------------------------


def _synthetic_trace(mesh_shape, node_size, message_bytes, seed):
    """One JAX-schema record per candidate of the cell, seeded timings."""
    rng = np.random.default_rng(seed)
    out = []
    for c in j_at.default_candidates():
        out.append(dict(
            strategy=c.strategy, packer=c.packer, coalesce=c.coalesce, n_parts=c.n_parts,
            us_per_cycle=float(rng.uniform(10, 100)), message_bytes=message_bytes,
            wire_bytes=message_bytes, collective_count=int(rng.integers(2, 12)),
            intra_node_sends=int(rng.integers(0, 16)), inter_node_sends=int(rng.integers(0, 16)),
            mapping="row-major", transport="ppermute", mesh_shape=list(mesh_shape),
            node_size=node_size, selected_by=None,
        ))
    return out


#: (mesh shape, global interior, trace): the committed cell, and a (4, 2)
#: mesh with a seeded trace of every candidate
AUTO_CASES = [
    ((2, 2), (16, 8), None),
    ((4, 2), (12, 6), 3),
]


@pytest.mark.parametrize("shape,interior,seed", AUTO_CASES)
def test_auto_strategy_resolves_by_trace_like_jax(env, monkeypatch, shape, interior, seed):
    names = ("px", "py")
    n = int(np.prod(shape))
    jd = JDomain(j_make_mesh(shape, names, devices=jax.devices()[:n]), interior, names)
    d = Domain(make_mesh(shape, names, device="cpu"), interior, names)
    assert d.max_face_bytes() == jd.max_face_bytes()
    jrecs = (_jax_records() if seed is None
             else _synthetic_trace(shape, n // 2, d.max_face_bytes(), seed))
    jtrace, ttrace = env / "BENCH_jax.json", env / "BENCH_torch.json"
    jtrace.write_text(json.dumps(jrecs))
    ttrace.write_text(json.dumps([dict(_port_record(r, device="cpu"), transport="loopback")
                                  for r in jrecs]))
    monkeypatch.setenv(j_at.TRACE_ENV, str(jtrace))
    monkeypatch.setenv(t_at.TRACE_ENV, str(ttrace))
    x = np.random.default_rng(5).normal(size=interior).astype(np.float32)

    jdrv = j_make_driver(JConfig(name="auto", packer="auto", coalesce="auto"),
                         jd.mesh, jd.halo_spec, ndim=2)
    jdrv.init(jd.from_global_interior(x))
    drv = make_driver(StrategyConfig(name="auto", packer="auto", coalesce="auto"),
                      d.mesh, d.halo_spec, ndim=2)
    assert isinstance(drv, AutoStrategy) and drv.strategy == "auto"
    got = drv.wait(drv.step(d.from_global_interior(x)))
    assert drv.selected_by == jdrv.selected_by == "trace"
    assert drv.predicted_us == jdrv.predicted_us
    assert (drv.strategy, drv.config.packer, drv.config.coalesce, drv.n_parts) == (
        jdrv.strategy, PACKER.get(jdrv.config.packer, jdrv.config.packer),
        jdrv.config.coalesce, jdrv.n_parts)
    assert drv.build_spec().selected_by == "trace"
    assert torch.equal(got, reference_exchange(d, x))
    jdrv.free()
    drv.free()


def test_autotuned_plan_never_aliases_a_pinned_one():
    """``selected_by`` is part of the spec and so of the plan key: the same
    cell pinned and autotuned builds two plans in one shared cache."""
    from repro_torch.core.plan import PlanCache

    d = Domain(make_mesh((4, 2), ("px", "py"), device="cpu"), (12, 6), ("px", "py"))
    cache = PlanCache()
    cfg = StrategyConfig(name="persistent", plan_cache=cache)
    x = d.from_global_interior(np.zeros(d.global_interior, np.float32))
    for builder in (d.halo_spec, lambda: d.halo_spec().with_(selected_by="trace"),
                    d.halo_spec):
        drv = make_driver(cfg, d.mesh, builder, ndim=2)
        drv.init(x)
        drv.free()
    assert (cache.stats.inits, cache.stats.cache_hits) == (2, 1)
    tags = sorted(p.schedule.tag() for p in cache._plans.values())
    assert tags == ["sequential[pxxpy]@slice/loopback+coalesced",
                    "sequential[pxxpy]@slice/loopback?trace+coalesced"]


def test_auto_strategy_calibrates_then_replays_the_cache(env):
    """No trace: the probes pick a cell (the winner's plan a cache hit for
    the resolved driver); a second driver replays the verdict from the
    cache; pinned axes stay pinned; both equal ``reference_exchange``."""
    d = Domain(make_mesh((4, 2), ("px", "py"), device="cpu"), (12, 6), ("px", "py"))
    x = np.random.default_rng(2).normal(size=d.global_interior).astype(np.float32)
    want = reference_exchange(d, x)
    cfg = StrategyConfig(name="auto", packer="auto", coalesce="auto")
    first = make_driver(cfg, d.mesh, d.halo_spec, ndim=2)
    assert torch.equal(first.wait(first.step(d.from_global_interior(x))), want)
    assert first.selected_by == "calibration" and first.calibration_us > 0.0
    if first.strategy != "standard":
        assert first._owned_cache.stats.cache_hits >= 1
    second = make_driver(cfg, d.mesh, d.halo_spec, ndim=2)
    second.init(d.from_global_interior(x))
    assert second.selected_by == "cache" and second.calibration_us == 0.0
    assert dataclasses.replace(second.config, plan_cache="private") == dataclasses.replace(
        first.config, plan_cache="private")
    assert torch.equal(second.wait(second.step(d.from_global_interior(x))), want)
    pinned = make_driver(StrategyConfig(name="fused", packer="auto", coalesce=True),
                         d.mesh, d.halo_spec, ndim=2)
    pinned.init(d.from_global_interior(x))
    assert pinned.strategy == "fused" and pinned.config.coalesce is True
    for drv in (first, second, pinned):
        drv.free()
    with pytest.raises(RuntimeError, match="before resolution"):
        make_driver(cfg, d.mesh, d.halo_spec, ndim=2).build_spec()
    with pytest.raises(TypeError):
        StrategyConfig(coalesce="sometimes")
