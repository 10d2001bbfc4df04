"""The serving engine and launcher of the port with the hybrid (reduced
zamba2-1.2b, 5 layers) and the VLM (reduced llama-3.2-vision-11b), on the
CPU: exact-length prefill (the hybrid's recurrent states would run on
through padding; the VLM prefill has no bucketed form), the VLM request's
zero patch embeddings, the JAX engine's tokens and plan counts for the
same prompts and parameters in f32, batched + continuous decoding equal to
a sequential greedy decode, the lengths JAX's SSD scan refuses refused
with ``ValueError``, and ``python -m repro_torch.launch.serve`` with the
new ``--arch`` values (an encoder-only config exits, as JAX's launcher).

Tokens are compared exactly: each is an argmax of f32 logits.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ServingEngine
from test_torch_models_hybrid import random_tree

torch.set_num_threads(1)

HYBRID, VLM = "zamba2-1.2b", "llama-3.2-vision-11b"
UPD = {HYBRID: dict(dtype="float32", param_dtype="float32", n_layers=5),
       VLM: dict(dtype="float32", param_dtype="float32")}
#: prompt lengths the SSD scan takes (at most 32, or a multiple of 32)
LENGTHS = (5, 12, 32, 12)
SLOTS, MAX_LEN, NEW = 2, 64, 4


@pytest.fixture(scope="module", params=[HYBRID, VLM])
def setup(request):
    name = request.param
    cfg = get_config(name).reduced().with_updates(**UPD[name])
    jmodel = j_build_model(j_get_config(name).reduced().with_updates(**UPD[name]))
    tree = random_tree(jmodel.init, seed=0)
    model = build_model(cfg, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in LENGTHS]
    return cfg, model, params_from_jax(cfg, tree, "cpu"), jmodel, \
        jax.tree.map(jax.numpy.asarray, tree), prompts


def _serve(engine, prompts, n_new=NEW):
    uids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    out = engine.run()
    return [out[u] for u in uids]


def _reference_generate(cfg, model, params, prompt, n_new=NEW):
    """Sequential greedy decode, batch 1, dedicated cache, the engine's
    zero image for the VLM."""
    batch = {"tokens": torch.tensor([prompt], dtype=torch.long)}
    if cfg.family == "vlm":
        batch["vision_emb"] = torch.zeros((1, cfg.vision_tokens, cfg.d_vision),
                                          dtype=torch.bfloat16)
    logits, cache = model.prefill(params, batch, model.init_cache(1, MAX_LEN))
    out = [int(logits[0, -1].argmax())]
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(params, torch.tensor([[out[-1]]]), cache)
        out.append(int(logits[0, 0].argmax()))
    return out


def test_engine_tokens_and_plans_equal_jax(setup):
    cfg, model, params, jmodel, jparams, prompts = setup
    engine = ServingEngine(model, params, max_slots=SLOTS, max_len=MAX_LEN)
    assert engine._prefill_bucket(12) is None  # exact-length prefill
    got = _serve(engine, prompts)
    jengine = JServingEngine(jmodel, jparams, max_slots=SLOTS, max_len=MAX_LEN)
    assert got == _serve(jengine, prompts)
    assert engine.stats.prefills == len(prompts)
    assert engine.stats.plan_inits == jengine.stats.plan_inits == len(set(LENGTHS)) + 1
    assert engine.stats.plan_hits == jengine.stats.plan_hits
    for tokens, prompt in zip(got, prompts):
        assert tokens == _reference_generate(cfg, model, params, prompt)


def test_engine_refuses_the_lengths_the_ssd_scan_refuses():
    cfg = get_config(HYBRID).reduced().with_updates(**UPD[HYBRID])
    model = build_model(cfg, "cpu")
    engine = ServingEngine(model, model.init(0), max_slots=SLOTS, max_len=MAX_LEN)
    engine.submit(list(range(40)), max_new_tokens=2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        engine.run()


@pytest.mark.parametrize("arch", [HYBRID, VLM])
def test_serve_launcher_runs_the_new_archs_on_the_cpu(arch, capsys):
    t_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                  "--slots", "2", "--max-new", "3", "--max-len", "32"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "3 prefills" in out


def test_serve_launcher_refuses_an_encoder_only_arch():
    with pytest.raises(SystemExit, match="encoder-only"):
        t_serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])
