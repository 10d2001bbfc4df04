"""The port's §VI sweep against the JAX package's, on the CPU.

* A tiny CPU sweep (the smoke grid at 4 ranks, 1 cycle) yields records
  whose keys are JAX ``RECORD_KEYS`` plus ``device``; every rank count runs
  in this process.
* Its static fields (``collective_count``, ``wire_bytes``,
  ``message_bytes``, ``mesh_shape``, ``intra/inter_node_sends``,
  ``plan_cache_inits``, the cell coordinates) equal JAX ``sweep_cells`` on
  4 of the 8 virtual devices for a restricted grid (one packer, three
  strategies) that keeps the JAX compile time small.
* ``summarize``, ``regression_failures``, ``read/write_bench_json`` and the
  ``SweepConfig`` JSON round trip give JAX's outputs on the same records.
* The CLI writes a readable file on ``--device cpu``, raises without a card
  otherwise, and refuses ``--processes 2``; so does the torch heat3d
  example, which verifies its ``auto`` cell against the numpy oracle.
"""

import dataclasses
import importlib.util
import json
import pathlib

import pytest
import torch

from repro.stencil import sweep as j_sweep
from repro_torch.core import autotune as t_at
from repro_torch.stencil import sweep as t_sweep

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATIC = ("strategy", "n_devices", "n_parts", "coalesce", "mapping", "node_size",
          "collective_count", "wire_bytes", "message_bytes", "mesh_shape",
          "global_interior", "intra_node_sends", "inter_node_sends", "plan_cache_inits",
          "plan_cache_hits", "process_count", "is_multihost", "n_cycles", "repeats",
          "schema_version", "bench")
RESTRICTED = dict(device_counts=(4,), part_counts=(1, 2), sizes=((16, 8),),
                  strategies=("standard", "partitioned", "fused"), packers=("slice",),
                  coalesce_modes=(False, True), mappings=("row-major", "blocked"),
                  mesh_ndim=2, n_cycles=1, repeats=1)


@pytest.fixture(scope="module")
def records():
    config = dataclasses.replace(t_sweep.smoke_config(4), n_cycles=1)
    return t_sweep.sweep_cells(config, device="cpu")


def test_records_carry_the_jax_keys_plus_device(records):
    assert t_sweep.RECORD_KEYS == (*j_sweep.RECORD_KEYS, "device")
    assert len(records) == 2 * 2 * 4 * 6  # mappings x coalesce x packers x cells
    for r in records:
        assert tuple(r) and set(r) == set(t_sweep.RECORD_KEYS), set(r) ^ set(t_sweep.RECORD_KEYS)
        assert r["device"] == "cpu" and r["process_count"] == 1 and not r["is_multihost"]
        assert r["us_per_cycle"] > 0 and r["speedup_vs_baseline"] > 0
    json.dumps(records)


def test_exact_packers_agree_bitwise_within_a_cell(records):
    """The exchange only moves data: the exact packers' checksums are equal."""
    sums = {r["checksum"] for r in records if r["packer"] in ("slice", "cuda")}
    assert len(sums) == 1
    assert {r["packer"] for r in records} == {"slice", "cuda", "bf16", "scaled-int8"}
    assert all(r["wire_bytes"] < r["message_bytes"] for r in records
               if r["packer"] in ("bf16", "scaled-int8"))


def test_static_fields_equal_jax_sweep_cells():
    got = t_sweep.sweep_cells(t_sweep.SweepConfig(**RESTRICTED), device="cpu")
    want = j_sweep.sweep_cells(j_sweep.SweepConfig(**RESTRICTED), n_devices=4)
    assert len(got) == len(want) == 2 * 2 * 4
    for g, w in zip(got, want):
        assert {k: g[k] for k in STATIC} == {k: w[k] for k in STATIC}
        assert g["packer"] == w["packer"] == "slice"
        assert g["transport"] == "loopback" and w["transport"] == "ppermute"
        assert g["checksum"] == got[0]["checksum"]


def test_run_sweep_loops_rank_counts_in_process():
    config = t_sweep.SweepConfig(device_counts=(2, 4), part_counts=(2,), sizes=((24, 6),),
                                 strategies=("standard", "partitioned"), packers=("cuda",),
                                 coalesce_modes=(True,), n_cycles=1, repeats=1)
    recs = t_sweep.run_sweep(config, device="cpu")
    assert [(r["n_devices"], r["mesh_shape"]) for r in recs] == [
        (2, [2]), (2, [2]), (4, [4]), (4, [4])]
    assert [r["node_size"] for r in recs] == [1, 1, 2, 2]


def test_summarize_and_regression_guard_equal_jax(records):
    assert t_sweep.summarize(records) == j_sweep.summarize(records)
    slow = [dict(r, speedup_vs_baseline=r["speedup_vs_baseline"] * 0.5) for r in records]
    for old, new in ((records, records), (records, slow), (slow, records)):
        for threshold in (0.25, 0.6):
            assert (t_sweep.regression_failures(old, new, threshold=threshold)
                    == j_sweep.regression_failures(old, new, threshold=threshold))
    assert t_sweep.regression_failures(records, slow)
    auto = [dict(records[0], selected_by="trace", speedup_vs_baseline=0.1)]
    assert (t_sweep.regression_failures(records, auto)
            == j_sweep.regression_failures(records, auto))
    with pytest.raises(ValueError, match="missing 'strategy'"):
        t_sweep.regression_failures([{"speedup_vs_baseline": 1.0}], records)


def test_bench_json_and_config_round_trips_equal_jax(tmp_path, records):
    block = t_sweep.config_block(t_sweep.smoke_config(4), device="cpu", smoke=True)
    assert block["device"] == "cpu" and block["torch"] == torch.__version__
    assert block["effective_mesh_shapes"] == {"4": [2, 2]}
    for config in (block, None):
        path = tmp_path / "BENCH_port.json"
        t_sweep.write_bench_json(records, str(path), config=config)
        jpath = tmp_path / "BENCH_jax.json"
        j_sweep.write_bench_json(records, str(jpath), config=config)
        assert path.read_text() == jpath.read_text()
        assert t_sweep.read_bench_json(str(path)) == j_sweep.read_bench_json(str(path))
    assert t_sweep.read_bench_json(str(path)) == (records, None)
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text('{"rows": []}')
    with pytest.raises(ValueError, match="no 'records' key"):
        t_sweep.read_bench_json(str(bad))
    assert not t_sweep.is_bench_path("out.json") and t_sweep.is_bench_path("a/BENCH_x.json")
    jcfg = j_sweep.SweepConfig(**RESTRICTED)
    tcfg = t_sweep.SweepConfig(**RESTRICTED)
    assert tcfg.to_json() == jcfg.to_json().replace('"ppermute"', '"loopback"')
    assert t_sweep.SweepConfig.from_json(tcfg.to_json()) == tcfg
    defaults = json.loads(t_sweep.SweepConfig().to_json())
    jdefaults = json.loads(j_sweep.SweepConfig().to_json())
    assert {k for k in defaults if defaults[k] != jdefaults[k]} == {"packers", "transport"}
    assert defaults["packers"] == ["slice", "cuda"] and defaults["transport"] == "loopback"


def test_config_validates_like_jax():
    assert t_sweep.mesh_shape_for(8, 2) == j_sweep.mesh_shape_for(8, 2) == (4, 2)
    with pytest.warns(RuntimeWarning, match="degrading"):
        assert t_sweep.mesh_shape_for(3, 2, warn=True) == (3,)
    with pytest.raises(ValueError, match="not decomposable"):
        t_sweep.SweepConfig(device_counts=(8,), sizes=((12, 6),))
    with pytest.raises(ValueError, match="baseline cannot be autotuned"):
        t_sweep.SweepConfig(strategies=("auto",), baseline="auto")
    with pytest.raises(NotImplementedError, match="multi-process"):
        t_sweep.SweepConfig(processes=2, device_counts=(4,))
    assert t_sweep.SweepConfig(mappings=("rb",)).mappings == ("recursive-bisection",)
    assert t_sweep.smoke_config(4, strategies=("standard",)).strategies == ("standard",)


def test_auto_cell_resolves_from_a_cpu_trace(tmp_path, monkeypatch, records):
    """The sweep's ``auto`` cell on the smoke grid's own CPU records: one
    tuned record per mapping, resolved by trace to the fastest exact cell."""
    trace = tmp_path / "BENCH_trace.json"
    t_sweep.write_bench_json(records, str(trace))
    monkeypatch.setenv(t_at.TRACE_ENV, str(trace))
    monkeypatch.setenv(t_at.CACHE_ENV, str(tmp_path / "autotune.json"))
    t_at.reset_default_tuners()
    try:
        config = t_sweep.smoke_config(4, strategies=("standard", "auto"), packers=("slice",),
                                      mappings=("row-major",))
        recs = t_sweep.sweep_cells(dataclasses.replace(config, n_cycles=1), device="cpu")
    finally:
        t_at.reset_default_tuners()
    (auto,) = [r for r in recs if r["selected_by"]]
    assert auto["selected_by"] == "trace" and auto["calibration_us"] == 0.0
    cell = [r for r in records if r["mapping"] == "row-major" and r["packer"] in ("slice", "cuda")]
    best = min(cell, key=lambda r: r["us_per_cycle"])
    assert auto["predicted_us"] == best["us_per_cycle"]
    assert (auto["strategy"], auto["packer"], auto["coalesce"], auto["n_parts"]) == (
        best["strategy"], best["packer"], best["coalesce"], best["n_parts"])
    assert t_sweep.summarize([auto])[0].split(",")[0].endswith(f"/auto:{auto['strategy']}")


def test_cli_writes_a_readable_file_and_refuses_what_is_not_ported(tmp_path, capsys):
    out = tmp_path / "BENCH_torch_verify.json"
    t_sweep.main(["--smoke", "--device", "cpu", "--packer", "cuda", "--coalesce", "on",
                  "--out", str(out)])
    recs, config = t_sweep.read_bench_json(str(out))
    assert len(recs) == 2 * 6 and {r["packer"] for r in recs} == {"cuda"}
    assert config["device"] == "cpu" and config["smoke"] is True
    assert "records ->" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="multi-process"):
        t_sweep.main(["--smoke", "--device", "cpu", "--processes", "2", "--out", str(out)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_sweep.main(["--smoke", "--out", str(out)])
    with pytest.raises(SystemExit):
        t_sweep.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "x.json")])


def _example():
    spec = importlib.util.spec_from_file_location(
        "stencil_heat3d_torch", ROOT / "examples" / "stencil_heat3d_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_heat3d_example_verifies_its_auto_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv(t_at.TRACE_ENV, raising=False)
    monkeypatch.setenv(t_at.CACHE_ENV, str(tmp_path / "autotune.json"))
    t_at.reset_default_tuners()
    example = _example()
    try:
        example.main(["--device", "cpu", "--size", "16", "--cycles", "2", "--strategy", "auto"])
    finally:
        t_at.reset_default_tuners()
    text = capsys.readouterr().out
    assert "via calibration" in text and "verified against the periodic numpy oracle" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            example.main(["--size", "16", "--cycles", "1"])
