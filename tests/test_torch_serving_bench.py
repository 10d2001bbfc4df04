"""The port's serve benchmark (``repro_torch/serving/bench.py``) against the
JAX package's and its committed baselines.

* At JAX's defaults on the CPU (reduced stablelm-1.6b at width 64, 2
  layers, vocab 512, 6 requests of 9-16 tokens, 2 slots, 8 new tokens,
  seed 0), ``run_cells`` and the ``auto`` cell replayed from the committed
  ``BENCH_lm_serve.json`` give every ``STATIC_KEYS`` field of its records
  except ``transport`` (the port's ``loopback`` for JAX's ``ppermute``).
* ``ring_comm_stats`` equals JAX's (called live; it needs no mesh) over
  the packers, coalesce on and off and ``n_parts`` 1 and 2, float32-wire
  quirk included.
* The ``--check`` guard fails on a tampered baseline and a missing cell,
  as ``tests/benchmarks/test_lm_serve.py`` holds JAX's.
* Every record of the committed card run, ``BENCH_torch_lm_serve.json``,
  has its wire accounting reproduced from its own fields.
* ``count_collectives`` around one ring prefill at JAX's defaults counts
  the baseline's 28 (uncoalesced) and 14 (coalesced) collectives.

Everything compared is an integer or a string: ``==``.
"""

import json
import pathlib

import pytest
import torch

from repro.serving import bench as j_bench
from repro_torch.core import comm_analysis as ca
from repro_torch.core.compat import torch_dtype
from repro_torch.serving import bench as t_bench
from repro_torch.stencil.sweep import read_bench_json

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_BASELINE = ROOT / "BENCH_lm_serve.json"
CARD_BASELINE = ROOT / "BENCH_torch_lm_serve.json"
#: the port's packers by the JAX package's names for them
PACKERS = {"slice": "slice", "cuda": "pallas", "bf16": "bf16", "scaled-int8": "scaled-int8"}


def test_schema_equals_jax():
    assert t_bench.STATIC_KEYS == j_bench.STATIC_KEYS
    assert t_bench.RECORD_KEYS == j_bench.RECORD_KEYS
    assert t_bench.CELLS == j_bench.CELLS
    assert (t_bench.BENCH_NAME, t_bench.SCHEMA_VERSION) == (j_bench.BENCH_NAME,
                                                            j_bench.SCHEMA_VERSION)


@pytest.fixture(scope="module")
def cpu_records():
    records = t_bench.run_cells(device="cpu")
    records.append(t_bench.auto_cell(str(JAX_BASELINE), device="cpu"))
    return records


def test_cpu_cells_reproduce_the_jax_baseline(cpu_records):
    base, _ = read_bench_json(str(JAX_BASELINE))
    by_cell = {(r["packer"], r["coalesce"], r["selected_by"]): r for r in base}
    assert len(cpu_records) == len(by_cell) == 4
    for r in cpu_records:
        want = by_cell[(r["packer"], r["coalesce"], r["selected_by"])]
        assert set(r) == set(t_bench.RECORD_KEYS)
        for key in t_bench.STATIC_KEYS:
            if key != "transport":
                assert r[key] == want[key], (r["packer"], r["coalesce"], key)
        assert r["transport"] == "loopback" and want["transport"] == "ppermute"
        assert r["tokens_per_sec"] > 0 and r["us_per_cycle"] > 0
    # the only failures the guard reports against JAX's file are transport's
    failures = t_bench.check_records(cpu_records, str(JAX_BASELINE))
    assert len(failures) == 4 and all("transport" in f for f in failures)


def test_cli_writes_records_and_checks_them(tmp_path, capsys):
    out = tmp_path / "BENCH_torch_lm_serve_cpu.json"
    assert t_bench.main(["--device", "cpu", "--out", str(out), "--requests", "2",
                         "--max-new", "3"]) == 0
    records, config = read_bench_json(str(out))
    assert [(r["packer"], r["coalesce"]) for r in records] == list(t_bench.CELLS)
    assert config["card"] == "cpu" and config["device"] == "cpu"
    # a trace without a trace-provenance record: the best exact cell is
    # picked, and the guard then fails on the new cell
    assert t_bench.main(["--device", "cpu", "--check", str(out), "--requests", "2",
                         "--max-new", "3"]) == 1
    assert "not in baseline" in capsys.readouterr().err


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("packer", sorted(PACKERS))
def test_ring_comm_stats_equals_jax(packer, coalesce, n_parts):
    for shape in (dict(seq_bucket=16, n_layers=2, n_kv_heads=4, head_dim=32, dtype_bytes=2),
                  dict(seq_bucket=2048, n_layers=24, n_kv_heads=32, head_dim=64,
                       dtype_bytes=2),
                  dict(seq_bucket=64, n_layers=3, n_kv_heads=2, head_dim=16, dtype_bytes=4,
                       batch=3)):
        kw = dict(ring=8, coalesce=coalesce, n_parts=n_parts, **shape)
        assert (t_bench.ring_comm_stats(packer=packer, **kw)
                == j_bench.ring_comm_stats(packer=PACKERS[packer], **kw))


def _record(packer="slice", coalesce=True, selected_by="", **over):
    stats = t_bench.ring_comm_stats(
        seq_bucket=16, ring=8, n_layers=2, n_kv_heads=2, head_dim=32,
        dtype_bytes=4, packer=packer, coalesce=coalesce, n_parts=1)
    rec = dict(bench=t_bench.BENCH_NAME, schema_version=t_bench.SCHEMA_VERSION,
               strategy="ring-messages", arch="stablelm-1.6b", n_devices=8, n_parts=1,
               packer=packer, transport="loopback", coalesce=coalesce, mapping="row-major",
               seq_bucket=16, tokens_generated=48, decode_steps=21, prefills=6,
               plan_cache_inits=2, plan_cache_hits=25, selected_by=selected_by,
               tokens_per_sec=12.5, us_per_cycle=8000.0, **stats)
    rec.update(over)
    return rec


def _baseline(tmp_path, records):
    path = tmp_path / "BENCH_torch_lm_serve.json"
    path.write_text(json.dumps({"config": {}, "records": records}))
    return str(path)


def test_check_passes_on_matching_records(tmp_path):
    records = [_record("slice", False), _record("slice", True), _record("bf16", True),
               _record("slice", True, selected_by="trace")]
    path = _baseline(tmp_path, records)
    fresh = [dict(r, tokens_per_sec=99.0, us_per_cycle=1.0) for r in records]
    assert t_bench.check_records(fresh, path) == []


def test_check_fails_on_tampered_static_field(tmp_path):
    path = _baseline(tmp_path, [_record("slice", True)])
    failures = t_bench.check_records([_record("slice", True, plan_cache_inits=5)], path)
    assert len(failures) == 1 and "plan_cache_inits" in failures[0]
    wire = _record("slice", True)
    wire["wire_bytes"] += 1
    assert any("wire_bytes" in f for f in t_bench.check_records([wire], path))


def test_check_fails_on_unknown_cell_and_bad_wallclock(tmp_path):
    path = _baseline(tmp_path, [_record("slice", True)])
    missing = _record("bf16", True)
    assert any("not in baseline" in f for f in t_bench.check_records([missing], path))
    stalled = _record("slice", True, tokens_per_sec=0.0)
    assert any("tokens_per_sec" in f for f in t_bench.check_records([stalled], path))


def test_card_baseline_wire_accounting_is_reproduced():
    """Every record of the committed card run: its message/wire bytes and
    collective count from ``ring_comm_stats`` on the record's own fields
    and the config the file says was served."""
    records, config = read_bench_json(str(CARD_BASELINE))
    assert config["bench"] == t_bench.BENCH_NAME and config["full"] is True
    assert "H100" in config["card"] and config["card"].endswith("W")
    cells = {(r["packer"], r["coalesce"], r["selected_by"]) for r in records}
    assert {(p, c, "") for p, c in t_bench.CELLS} <= cells
    assert any(sel == "trace" for _, _, sel in cells)
    for r in records:
        assert set(t_bench.RECORD_KEYS) <= set(r)
        cfg = t_bench.bench_config(r["arch"], full=config["full"])
        stats = t_bench.ring_comm_stats(
            seq_bucket=r["seq_bucket"], ring=r["n_devices"], n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            dtype_bytes=torch_dtype(cfg.dtype).itemsize,
            packer=r["packer"], coalesce=r["coalesce"], n_parts=r["n_parts"])
        assert {k: r[k] for k in stats} == stats
        assert r["seq_bucket"] == 2048 and r["prefills"] == config["requests"]
        assert r["plan_cache_inits"] == 2  # one bucketed prefill + one decode
        assert r["tokens_per_sec"] > 0


@pytest.mark.parametrize("packer,coalesce,want", [("slice", False, 28), ("slice", True, 14),
                                                  ("bf16", True, 14)])
def test_one_ring_prefill_issues_the_counted_collectives(packer, coalesce, want):
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.context import ParallelContext

    cfg = t_bench.bench_config()
    model = build_model(cfg, "cpu")
    params = model.init(0)
    ctx = ParallelContext(mesh=make_mesh((1, 8), ("data", "model"), device="cpu"),
                          seq_parallel=True, comm_packer=packer, comm_coalesce=coalesce)
    tokens = torch.as_tensor([t_bench.bench_prompts(cfg.vocab_size, 1, (16, 17), 0)[0]])
    stats = ca.count_collectives(model.prefill, params, {"tokens": tokens},
                                 model.init_cache(1, 128), ctx=ctx)
    record = t_bench.ring_comm_stats(seq_bucket=16, ring=8, n_layers=cfg.n_layers,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.resolved_head_dim, dtype_bytes=2,
                                     packer=packer, coalesce=coalesce, n_parts=1)
    assert stats.by_op_counts == {"collective-permute": want} == {
        "collective-permute": record["collective_count"]}
    # what the wire carries: the KV's own bf16 bytes (the record's
    # wire_bytes counts float32 for the slice packer, ROADMAP)
    assert stats.wire_bytes == record["message_bytes"] == 14336
