"""Serving engine of the port with an exact-length family (RWKV-6), on the
CPU: batched + continuous decoding equals the port's own sequential greedy
decode (the regression tests of ``tests/serving/test_engine.py`` that apply
to a family prefilled at the exact prompt length), and the port's engine
gives the JAX engine's tokens and plan counts for the same prompts and
parameters in f32.

Tokens are compared exactly: each is an argmax, and bf16 logits are
converted with ``.float()`` before it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)

NAME = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def setup():
    cfg = get_config(NAME).reduced()
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    return cfg, model, params


def _reference_generate(model, params, prompt, n_new):
    """Sequential greedy decode, batch 1, dedicated cache."""
    cache = model.init_cache(1, 128)
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt], dtype=torch.long)},
                                  cache)
    out = [int(logits[0, -1].float().argmax())]
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(params, torch.tensor([[out[-1]]]), cache)
        out.append(int(logits[0, 0].float().argmax()))
    return out


def test_batched_matches_sequential(setup):
    cfg, model, params = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 8, 3, 6)]
    engine = ServingEngine(model, params, max_slots=4, max_len=128)
    uids = [engine.submit(p, max_new_tokens=6) for p in prompts]
    results = engine.run()
    for uid, prompt in zip(uids, prompts):
        assert results[uid] == _reference_generate(model, params, prompt, 6), uid


def test_continuous_batching_more_requests_than_slots(setup):
    cfg, model, params = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=4 + i).tolist() for i in range(5)]
    engine = ServingEngine(model, params, max_slots=2, max_len=64)
    uids = [engine.submit(p, max_new_tokens=4) for p in prompts]
    results = engine.run()
    assert set(results) == set(uids)
    for uid, prompt in zip(uids, prompts):
        assert results[uid] == _reference_generate(model, params, prompt, 4), uid


def test_exact_generation_length_and_step_count(setup):
    cfg, model, params = setup
    engine = ServingEngine(model, params, max_slots=1, max_len=64)
    uid = engine.submit([3, 1, 4, 1, 5], max_new_tokens=5)
    results = engine.run()
    assert len(results[uid]) == 5
    assert engine.stats.prefills == 1
    assert engine.stats.decode_steps == 4
    assert engine.stats.tokens_generated == 4
    assert results[uid] == _reference_generate(model, params, [3, 1, 4, 1, 5], 5)


def test_max_new_tokens_one_finishes_at_prefill(setup):
    cfg, model, params = setup
    engine = ServingEngine(model, params, max_slots=2, max_len=64)
    uids = [engine.submit([7, 8, 9], max_new_tokens=1) for _ in range(3)]
    results = engine.run()
    assert engine.stats.decode_steps == 0
    assert all(len(results[u]) == 1 for u in uids)
    assert results[uids[0]] == _reference_generate(model, params, [7, 8, 9], 1)


def test_single_slot_engine_really_writes_the_state(setup):
    """max_slots=1: every recurrent-state entry has its slot axis from
    batch 1 against batch 2, so prefill writes the whole state."""
    cfg, model, params = setup
    engine = ServingEngine(model, params, max_slots=1, max_len=64)
    assert engine._slot_axes == {"tm_shift": 1, "cm_shift": 1, "wkv": 1, "pos": 0}
    uid = engine.submit([5, 9, 2, 6], max_new_tokens=6)
    results = engine.run()
    assert results[uid] == _reference_generate(model, params, [5, 9, 2, 6], 6)


def test_short_after_long_slot_reuse_matches_isolated(setup):
    """A slot that served a long prompt serves a short one as a fresh slot
    would: the new prefill replaces the whole recurrent state."""
    cfg, model, params = setup
    rng = np.random.default_rng(7)
    long_prompt = rng.integers(0, cfg.vocab_size, size=24).tolist()
    short_prompt = rng.integers(0, cfg.vocab_size, size=3).tolist()
    engine = ServingEngine(model, params, max_slots=1, max_len=64)
    uid_long = engine.submit(long_prompt, max_new_tokens=4)
    uid_short = engine.submit(short_prompt, max_new_tokens=6)
    results = engine.run()
    assert results[uid_short] == _reference_generate(model, params, short_prompt, 6)
    assert results[uid_long] == _reference_generate(model, params, long_prompt, 4)


def test_exact_length_prefill_one_plan_per_length(setup):
    """No buckets: one prefill plan per distinct prompt length plus one
    decode plan, and a repeated length hits its plan."""
    cfg, model, params = setup
    rng = np.random.default_rng(11)
    lengths = (3, 5, 6, 5, 3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]
    engine = ServingEngine(model, params, max_slots=1, max_len=64)
    assert engine._prefill_bucket(5) is None
    uids = [engine.submit(p, max_new_tokens=3) for p in prompts]
    results = engine.run()
    assert engine.stats.prefills == len(prompts)
    assert engine.stats.plan_inits == len(set(lengths)) + 1, engine.plans.stats
    for uid, p in zip(uids, prompts):
        assert results[uid] == _reference_generate(model, params, p, 3)


def test_persistent_plans_amortized(setup):
    cfg, model, params = setup
    engine = ServingEngine(model, params, max_slots=2, max_len=64)
    for i in range(3):
        engine.submit([1 + i, 2, 3], max_new_tokens=5)
    engine.run()
    st = engine.stats
    assert st.decode_steps >= 5
    assert st.plan_inits == 2  # one prompt length, one decode step
    assert st.plan_hits >= st.decode_steps - 2


def test_engine_tokens_equal_jax_engine_f32():
    """The same prompts through the JAX engine and the port's engine, with
    the same (converted) f32 parameters, give the same tokens and the same
    counts: both prefill at the exact length, one plan per distinct length
    plus one decode plan."""
    upd = dict(dtype="float32", param_dtype="float32")
    jcfg = j_get_config(NAME).reduced().with_updates(**upd)
    cfg = get_config(NAME).reduced().with_updates(**upd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = j_build_model(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(3)))
    lb = tree["layers"]["w_lora_b"]
    tree["layers"]["w_lora_b"] = (np.random.default_rng(3).normal(size=lb.shape)
                                  * 0.5).astype(lb.dtype)
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    model = build_model(cfg, "cpu")
    params = params_from_jax(cfg, tree, "cpu")
    rng = np.random.default_rng(5)
    lengths = (3, 11, 6, 11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]
    engines = (JServingEngine(jmodel, jparams, max_slots=2, max_len=64),
               ServingEngine(model, params, max_slots=2, max_len=64))
    results = []
    for engine in engines:
        uids = [engine.submit(p, max_new_tokens=5) for p in prompts]
        out = engine.run()
        results.append([out[u] for u in uids])
    assert results[1] == results[0]
    assert dataclasses.asdict(engines[1].stats) == dataclasses.asdict(engines[0].stats)
    assert engines[1].stats.plan_inits == len(set(lengths)) + 1


def test_serve_launcher_serves_rwkv_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", NAME, "--reduced", "--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "on cpu" in out and "3 prefills" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--arch", NAME, "--reduced"])
