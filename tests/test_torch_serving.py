"""Serving engine of the port on the CPU: batched + continuous decoding
equals the port's own sequential greedy decode (the regression tests of
``tests/serving/test_engine.py``), and the port's engine gives the JAX
engine's tokens for the same prompts and parameters in f32.

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
from repro_torch.serving.engine import ServingEngine, _next_pow2, _write_slot

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("stablelm-1.6b").reduced()
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    return cfg, model, params


def _reference_generate(model, params, prompt, n_new):
    """Sequential greedy decode, batch 1, dedicated cache."""
    cache = model.init_cache(1, 128)
    batch = {"tokens": torch.tensor([prompt], dtype=torch.long)}
    logits, cache = model.prefill(params, batch, cache)
    out = [int(logits[0, -1].float().argmax())]
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(params, torch.tensor([[out[-1]]]), cache)
        out.append(int(logits[0, 0].float().argmax()))
    return out


def test_batched_matches_sequential(setup):
    cfg, model, params = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 8, 3, 6)]
    n_new = 6
    engine = ServingEngine(model, params, max_slots=4, max_len=128)
    uids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    results = engine.run()
    for uid, prompt in zip(uids, prompts):
        want = _reference_generate(model, params, prompt, n_new)
        assert results[uid] == want, (uid, results[uid], want)


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
    """max_new_tokens=N yields exactly N tokens from 1 prefill + N-1 decode
    steps: no extra step whose token is silently dropped."""
    cfg, model, params = setup
    n_new = 5
    engine = ServingEngine(model, params, max_slots=1, max_len=64)
    uid = engine.submit([3, 1, 4, 1, 5], max_new_tokens=n_new)
    results = engine.run()
    assert len(results[uid]) == n_new
    assert engine.stats.prefills == 1
    assert engine.stats.decode_steps == n_new - 1
    assert engine.stats.tokens_generated == n_new - 1  # decode-sampled
    assert results[uid] == _reference_generate(model, params, [3, 1, 4, 1, 5], n_new)


def test_max_new_tokens_one_finishes_at_prefill(setup):
    cfg, model, params = setup
    engine = ServingEngine(model, params, max_slots=2, max_len=64)
    uids = [engine.submit([7, 8, 9], max_new_tokens=1) for _ in range(3)]
    results = engine.run()
    assert engine.stats.decode_steps == 0
    for uid in uids:
        assert len(results[uid]) == 1
    assert results[uids[0]] == _reference_generate(model, params, [7, 8, 9], 1)


def test_single_slot_engine_really_writes_the_cache(setup):
    """max_slots=1: batch-1 and batched cache shapes coincide; the slot axes
    come from batch 1 against batch 2, so prefill still writes the cache."""
    cfg, model, params = setup
    prompt = [5, 9, 2, 6]
    engine = ServingEngine(model, params, max_slots=1, max_len=64)
    assert engine._slot_axes == {"k": 1, "v": 1, "pos": 0}
    uid = engine.submit(prompt, max_new_tokens=6)
    results = engine.run()
    assert results[uid] == _reference_generate(model, params, prompt, 6)


def test_short_after_long_slot_reuse_matches_isolated(setup):
    cfg, model, params = setup
    rng = np.random.default_rng(7)
    long_prompt = rng.integers(0, cfg.vocab_size, size=24).tolist()
    short_prompt = rng.integers(0, cfg.vocab_size, size=3).tolist()
    engine = ServingEngine(model, params, max_slots=1, max_len=64)
    uid_long = engine.submit(long_prompt, max_new_tokens=4)
    uid_short = engine.submit(short_prompt, max_new_tokens=6)
    results = engine.run()
    alone = ServingEngine(model, params, max_slots=1, max_len=64)
    uid_alone = alone.submit(short_prompt, max_new_tokens=6)
    want = alone.run()[uid_alone]
    assert results[uid_short] == want
    assert want == _reference_generate(model, params, short_prompt, 6)
    assert results[uid_long] == _reference_generate(model, params, long_prompt, 4)


def test_bucketed_prefill_plan_inits_flat_across_lengths(setup):
    cfg, model, params = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (3, 5, 6, 8)]
    engine = ServingEngine(model, params, max_slots=1, max_len=64)
    uids = [engine.submit(p, max_new_tokens=3) for p in prompts]
    results = engine.run()
    # one bucketed prefill plan + one decode plan, regardless of lengths
    assert engine.stats.prefills == len(prompts)
    assert engine.stats.plan_inits == 2, engine.plans.stats
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
    assert st.plan_inits <= 4
    assert st.plan_hits >= st.decode_steps - 2


def test_buckets_and_write_slot_helpers():
    assert [_next_pow2(n) for n in (1, 8, 9, 100, 2000)] == [8, 8, 16, 128, 2048]
    dst = {"k": torch.zeros((2, 3, 4)), "pos": torch.zeros((3,), dtype=torch.int32)}
    src = {"k": torch.ones((2, 1, 4)), "pos": torch.full((1,), 7, dtype=torch.int32)}
    out = _write_slot(dst, src, 1, {"k": 1, "pos": 0})
    assert out is dst and dst["k"][:, 1].eq(1).all() and dst["k"][:, [0, 2]].eq(0).all()
    assert dst["pos"].tolist() == [0, 7, 0]


def test_engine_tokens_equal_jax_engine_f32():
    """The same prompts through the JAX engine and the port's engine, with
    the same (converted) f32 parameters, give the same tokens; both bucket
    prompts to powers of two and batch decode over the slots."""
    upd = dict(dtype="float32", param_dtype="float32")
    jcfg = j_get_config("stablelm-1.6b").reduced().with_updates(**upd)
    cfg = get_config("stablelm-1.6b").reduced().with_updates(**upd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(3))
    model = build_model(cfg, "cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (3, 11, 6, 20, 9)]
    engines = (JServingEngine(jmodel, jparams, max_slots=2, max_len=64),
               ServingEngine(model, params, max_slots=2, max_len=64))
    results = []
    for engine in engines:
        uids = [engine.submit(p, max_new_tokens=5) for p in prompts]
        out = engine.run()
        results.append([out[u] for u in uids])
    assert results[1] == results[0]
    assert dataclasses.asdict(engines[1].stats) == dataclasses.asdict(engines[0].stats)
