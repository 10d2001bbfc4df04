"""Serving engine of the port with the MoE family (reduced phi3.5-moe), on
the CPU: exact-length prefill (capacity routing is length-sensitive, so a
prompt is never padded), the dropless decode step, batched + continuous
decoding equal to a sequential greedy decode, the JAX engine's tokens and
plan counts for the same prompts and parameters in f32, and an
expert-parallel context: the same tokens as without it where no token
drops, and a prompt the model axis does not divide refused with
``ValueError``, as JAX's ``shard_map`` refuses it.

Tokens are compared exactly: each is an argmax of f32 logits.
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
from repro_torch.core.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving.engine import ServingEngine
from test_torch_models_moe import _random_tree

torch.set_num_threads(1)

NAME = "phi3.5-moe-42b-a6.6b"
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    """Both packages' reduced f32 models with the same parameters: numpy
    normal values (seeded) in the JAX tree's shapes, scaled by the fan-in."""
    cfg = get_config(NAME).reduced().with_updates(**F32)
    jcfg = j_get_config(NAME).reduced().with_updates(**F32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = j_build_model(jcfg)
    tree = _random_tree(jmodel.init, seed=0)
    model = build_model(cfg, "cpu")
    return cfg, model, params_from_jax(cfg, tree, "cpu"), jmodel, jax.tree.map(jax.numpy.asarray,
                                                                              tree)


def _reference_generate(model, params, prompt, n_new):
    """Sequential greedy decode, batch 1, dedicated cache."""
    cache = model.init_cache(1, 64)
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt], dtype=torch.long)},
                                  cache)
    out = [int(logits[0, -1].argmax())]
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(params, torch.tensor([[out[-1]]]), cache)
        out.append(int(logits[0, 0].argmax()))
    return out


def _serve(engine, prompts, n_new):
    uids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    out = engine.run()
    return [out[u] for u in uids]


def test_batched_continuous_matches_sequential(setup):
    cfg, model, params, _, _ = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 8, 3, 6, 7)]
    engine = ServingEngine(model, params, max_slots=2, max_len=64)
    assert engine._prefill_bucket(5) is None  # exact-length prefill
    results = _serve(engine, prompts, 5)
    for got, prompt in zip(results, prompts):
        assert got == _reference_generate(model, params, prompt, 5)
    assert engine.stats.prefills == len(prompts)
    assert engine.stats.plan_inits == len({len(p) for p in prompts}) + 1


def test_engine_tokens_equal_jax_engine_f32(setup):
    """The same prompts through the JAX engine and the port's give the same
    tokens and the same counts: one plan per distinct prompt length plus
    one decode plan."""
    cfg, model, params, jmodel, jparams = setup
    rng = np.random.default_rng(5)
    lengths = (4, 11, 6, 11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]
    engines = (JServingEngine(jmodel, jparams, max_slots=2, max_len=64),
               ServingEngine(model, params, max_slots=2, max_len=64))
    results = [_serve(engine, prompts, 5) for engine in engines]
    assert results[1] == results[0]
    assert dataclasses.asdict(engines[1].stats) == dataclasses.asdict(engines[0].stats)
    assert engines[1].stats.plan_inits == len(set(lengths)) + 1


def test_expert_parallel_engine(setup):
    """Under ``moe_mode="ep"`` on a (1, 4) mesh (one slot a rank, messages,
    n_parts 2) the reduced config's capacity_factor of 8 drops nothing, so
    the tokens are the local engine's; a 5-token prompt does not split over
    the 4 ranks and is refused."""
    cfg, model, params, _, _ = setup
    ctx = ParallelContext(mesh=make_mesh((1, 4), ("data", "model"), device="cpu"),
                          moe_mode="ep", moe_comm="messages", n_parts=2)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (8, 12, 4)]
    ep = ServingEngine(model, params, max_slots=2, max_len=64, ctx=ctx)
    local = ServingEngine(model, params, max_slots=2, max_len=64)
    assert _serve(ep, prompts, 4) == _serve(local, prompts, 4)
    refused = ServingEngine(model, params, max_slots=1, max_len=64, ctx=ctx)
    refused.submit(rng.integers(0, cfg.vocab_size, size=5).tolist(), max_new_tokens=2)
    with pytest.raises(ValueError, match="not evenly divisible"):
        refused.run()
