"""The port's examples (``examples/quickstart_torch.py``,
``serve_batched_torch.py``, ``long_context_ring_torch.py``) and
``models.concrete_batch`` against the JAX package's, on the CPU.

* ``concrete_batch``: JAX's keys, shapes and dtypes for every family (the
  draws are the port's own generator's, not JAX's).
* quickstart: its train step at its own run (reduced llama3-8b, 8 x 32
  tokens, AdamW 1e-3 after 5 warmup steps, the config's microbatches)
  against JAX's jitted ``make_train_step`` from JAX's initial state carried
  over by ``train_state_from_jax``, 5 steps: losses within 1e-5 relative;
  its request through the engine: tokens and plan counts equal to JAX's
  engine from the same parameters.
* serve_batched's default run (12 requests, 4 slots, 16 new tokens):
  every request's tokens and the engine's counters equal to JAX's engine
  from the same converted parameters.
* long_context_ring: ring attention at its shapes (B 2, 512 tokens, 8 heads
  on 4 kv heads of 32, f32, causal, ``n_parts`` 1 and 4) against JAX's
  ring under ``shard_map`` on 8 virtual devices within 1e-5; zamba2's
  local and sequence-parallel losses against JAX's from the same
  parameters and batch within 1e-5 relative.
* Each example's ``main([..., "--device", "cpu"])`` runs to its end, and
  every attention call it makes at head dim 16 or 32 has a shape that
  ``chip_smoke.py``'s phase A holds the flash kernels to on the card
  (``tools/flash_head_dims.checked_shapes``; long_context_ring's at the
  lengths phase P runs, 512 and 4096 tokens).

Comparisons run in f32 (``dtype`` and ``param_dtype``; a random bf16
model's logits tie often and round in other orders); the examples
themselves run at their configs' bf16.  JAX parameters are drawn with numpy
at JAX init's statistics (``test_torch_models_hybrid.random_tree``), or
are the port's converted back, so no JAX init compiles but the
quickstart's, whose initial state the check is about.
"""

import dataclasses
import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import compat as j_compat
from repro.core import ring as j_ring
from repro.models import build_model as j_build_model
from repro.models import concrete_batch as j_concrete_batch
from repro.parallel.context import ParallelContext as JCtx
from repro.serving.engine import ServingEngine as JServingEngine
from repro.train import train_loop as JT
from test_torch_models_hybrid import random_tree
from repro_torch.configs import get_config
from repro_torch.core.mesh import make_mesh
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model, concrete_batch
from repro_torch.models.convert import params_from_jax, params_to_numpy, train_state_from_jax
from repro_torch.serving.engine import ServingEngine
from repro_torch.train.train_loop import make_train_step, microbatches_of

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(dtype="float32", param_dtype="float32")


def _example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _need(n: int) -> list:
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices (conftest)")
    return jax.devices()[:n]


def test_concrete_batch_matches_jax_keys_shapes_and_dtypes():
    """Every family: the same keys, shapes and dtypes as JAX's, tokens and
    labels in ``[0, vocab)``, the audio mask 0/1 near 30 %, and one seed
    gives one batch."""
    jdtype = {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}
    for arch in ("llama3-8b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "zamba2-1.2b",
                 "llama-3.2-vision-11b", "hubert-xlarge"):
        cfg, jcfg = get_config(arch).reduced(), j_get_config(arch).reduced()
        got = concrete_batch(cfg, 3, 40, seed=2, device="cpu")
        want = j_concrete_batch(jcfg, 3, 40, seed=2)
        assert sorted(got) == sorted(want), arch
        for key, w in want.items():
            assert tuple(got[key].shape) == w.shape, (arch, key)
            assert got[key].dtype == jdtype[str(w.dtype)], (arch, key)
            assert got[key].device.type == "cpu"
        for key in ("tokens", "labels"):
            if key in got:
                assert 0 <= int(got[key].min()) and int(got[key].max()) < cfg.vocab_size
        if "mask" in got:
            assert set(got["mask"].unique().tolist()) <= {0.0, 1.0}
            assert 0.2 < float(got["mask"].mean()) < 0.4
        again = concrete_batch(cfg, 3, 40, seed=2, device="cpu")
        assert all(torch.equal(got[k], again[k]) for k in got)
    from repro_torch.configs import SHAPES

    cfg = get_config("llama-3.2-vision-11b")
    shp = dataclasses.replace(SHAPES["train_4k"], global_batch=2, seq_len=8)
    assert tuple(concrete_batch(cfg, shp, device="cpu")["vision_emb"].shape) == (
        2, cfg.vision_tokens, cfg.d_vision)


def test_quickstart_steps_match_jax_from_its_initial_state():
    qs = _example("quickstart_torch")
    cfg = get_config("llama3-8b").reduced().with_updates(**F32)
    jcfg = j_get_config("llama3-8b").reduced().with_updates(**F32)
    run = qs.run_config(cfg)
    mb = microbatches_of(cfg, run.shape)
    assert mb > 1  # llama3-8b accumulates its train_microbatches
    o = run.optimizer
    jopt = JOptimizerConfig(lr=o.lr, warmup_steps=o.warmup_steps, total_steps=o.total_steps)
    jmodel = j_build_model(jcfg)
    jstate = _jitr(lambda key: JT.init_state(jmodel, jopt, key))(jax.random.key(0))
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate), "cpu")
    jstep = _jitr(JT.make_train_step(jmodel, jopt, microbatches=mb))
    step = make_train_step(build_model(cfg, "cpu"), o, microbatches=mb)
    data = SyntheticLM(cfg, run.shape.global_batch, run.shape.seq_len, seed=run.seed)
    losses, want = [], []
    for i in range(5):
        batch = data.batch_at(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(met["loss"].item())
        want.append(float(jmet["loss"]))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[-1] < losses[0]


def _engines(jcfg, cfg, seed, **kw):
    jmodel = j_build_model(jcfg)
    tree = random_tree(jmodel.init, seed)
    return (JServingEngine(jmodel, jax.tree.map(jnp.asarray, tree), **kw),
            ServingEngine(build_model(cfg, "cpu"), params_from_jax(cfg, tree, "cpu"), **kw))


def test_quickstart_request_matches_jax_engine():
    qs = _example("quickstart_torch")
    cfg = get_config("llama3-8b").reduced().with_updates(**F32)
    jcfg = j_get_config("llama3-8b").reduced().with_updates(**F32)
    jengine, engine = _engines(jcfg, cfg, 0, max_slots=2, max_len=64)
    # the JAX example's request, as generate() submits it
    uid = jengine.submit([1, 2, 3, 4], max_new_tokens=8)
    want = jengine.run()[uid]
    got, stats = qs.generate(engine.model, engine.params)
    assert got == want and len(got) == 8
    assert dataclasses.asdict(stats) == dataclasses.asdict(jengine.stats)
    assert stats.plan_inits > 0 and stats.plan_hits > 0


def test_serve_batched_default_run_matches_jax_engine():
    sb = _example("serve_batched_torch")
    upd = dict(d_model=128, n_layers=4, vocab_size=2048, d_ff=384, n_heads=4, n_kv_heads=4,
               head_dim=32, **F32)
    cfg = sb.example_config("stablelm-1.6b", 128, 4, 2048, False).with_updates(**F32)
    jcfg = j_get_config("stablelm-1.6b").reduced().with_updates(**upd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.resolved_head_dim == 32
    out = []
    for engine in _engines(jcfg, cfg, 1, max_slots=4, max_len=256):
        uids = sb.submit_requests(engine, cfg.vocab_size, 12, 16)
        results = engine.run()
        out.append(([results[u] for u in uids], dataclasses.asdict(engine.stats)))
    (want, jstats), (got, stats) = out
    assert stats == jstats
    # the prefill gives each request's first token, the decode steps the rest
    assert stats["tokens_generated"] == 12 * 15 and stats["prefills"] == 12
    assert [t[:1] for t in got] == [t[:1] for t in want]
    assert got == want and all(len(t) == 16 for t in got)


def test_ring_attention_at_the_example_shapes_matches_jax_shard_map():
    ring = _example("long_context_ring_torch")
    devices = _need(ring.SHARDS)
    rng = np.random.default_rng(0)
    seq = 512
    q = rng.normal(size=(ring.B, seq, ring.H, ring.D)).astype(np.float32)
    k = rng.normal(size=(ring.B, seq, ring.HKV, ring.D)).astype(np.float32)
    v = rng.normal(size=(ring.B, seq, ring.HKV, ring.D)).astype(np.float32)
    jmesh = j_compat.make_mesh((1, ring.SHARDS), ("data", "model"), devices=devices)
    spec = P(None, "model", None, None)

    def inner(qb, kb, vb):
        return tuple(j_ring.ring_attention(qb, kb, vb, "model", causal=True, n_parts=n)
                     for n in (1, 4))

    want = _jitr(j_compat.shard_map(inner, mesh=jmesh, in_specs=(spec,) * 3,
                                    out_specs=(spec, spec)))(*map(jnp.asarray, (q, k, v)))
    mesh = make_mesh((1, ring.SHARDS), ("data", "model"), device="cpu")
    outs, ms = ring.ring_cells(*(ring.stack_shards(torch.from_numpy(t), ring.SHARDS)
                                 for t in (q, k, v)), mesh, 4)
    assert set(ms) == {1, 4}
    for n, w in zip((1, 4), want):
        np.testing.assert_allclose(ring.unstack_shards(outs[n]).numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_zamba2_local_and_sequence_parallel_losses_match_jax():
    ring = _example("long_context_ring_torch")
    devices = _need(ring.SHARDS)
    cfg = get_config("zamba2-1.2b").reduced().with_updates(**F32)
    jcfg = j_get_config("zamba2-1.2b").reduced().with_updates(**F32)
    mesh = make_mesh((1, ring.SHARDS), ("data", "model"), device="cpu")
    params = build_model(cfg, "cpu").init(1)
    batch = concrete_batch(cfg, 4, 512 // 4, seed=1, device="cpu")
    local, seqp = ring.zamba2_losses(cfg, params, batch, mesh, 4)

    jmodel = j_build_model(jcfg)
    jmesh = j_compat.make_mesh((1, ring.SHARDS), ("data", "model"), devices=devices)
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(cfg, params))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ctxs = (JCtx(mesh=jmesh, model_axis="model"),
            JCtx(mesh=jmesh, model_axis="model", seq_parallel=True, n_parts=4))
    with j_compat.set_mesh(jmesh):
        want = _jitr(lambda p, b: tuple(jmodel.loss(p, b, ctx=c) for c in ctxs))(jparams, jbatch)
    np.testing.assert_allclose([local, seqp], [float(w) for w in want], rtol=1e-5)


def _attention_shapes(monkeypatch) -> set:
    """A set that collects ``(b, sq, skv, hq, hkv, d)`` of every call of
    ``ops.attention`` (on the CPU it calls the plain version; on the card
    the flash kernels) while the test runs."""
    seen: set = set()
    plain = flash_ops.attention_plain

    def record(q, k, v, **kw):
        seen.add((q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(flash_ops, "attention_plain", record)
    return seen


def _checked_shapes() -> dict:
    """``tools/flash_head_dims.checked_shapes`` by head dim, as
    ``(b, sq, skv, hq, hkv, d)``."""
    spec = importlib.util.spec_from_file_location("flash_head_dims",
                                                  ROOT / "tools" / "flash_head_dims.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return {d: {(*s, d) for s in mod.checked_shapes(d)} for d in mod.HEAD_DIMS}


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", []),
    ("serve_batched_torch", []),
    ("long_context_ring_torch", ["--seq", "256"]),
])
def test_example_main_runs_on_the_cpu(name, argv, capsys, monkeypatch):
    seen = _attention_shapes(monkeypatch)
    out = _example(name).main([*argv, "--device", "cpu"])
    text = capsys.readouterr().out
    checked = _checked_shapes()
    assert seen and all(s[-1] in checked for s in seen)
    if name == "long_context_ring_torch":  # zamba2's loss: 4 sequences of seq / 4
        assert {s[1:3] for s in seen} == {(64, 64)}
        seen = {(b, n, n, hq, hkv, d) for b, _, _, hq, hkv, d in seen for n in (128, 1024)}
    assert all(s in checked[s[-1]] for s in seen), seen
    if name == "quickstart_torch":
        assert out["losses"][-1] < out["losses"][0] and len(out["tokens"]) == 8
        assert "plan stats:" in text
    elif name == "serve_batched_torch":
        st = out["stats"]
        assert (st.prefills, st.tokens_generated) == (12, 12 * 15)
        assert all(len(out["results"][u]) == 16 for u in out["uids"])
        assert "persistent plans:" in text and "amortization=" in text
    else:
        assert "sequence-parallel == local" in text
        assert all(o.shape == (2, 256, 8, 32) for o in out["ring"].values())
