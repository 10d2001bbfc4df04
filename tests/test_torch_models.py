"""Dense transformer of the port against the JAX package, on the CPU.

The same parameters (drawn with numpy in the shapes and dtypes of the JAX
package's ``init``, at its statistics, by ``test_torch_models_hybrid.
random_tree``, and carried over by ``repro_torch.models.convert``) and the same tokens (numpy, seeded) go
through ``repro.models.build_model(cfg)`` and the port's ``build_model(cfg,
"cpu")``; both take their plain attention on the CPU.

Tolerances, stated: f32 ``rtol=atol=1e-4`` (two layers of width 64; XLA and
PyTorch sum the products and the softmax in other orders, which moves a
logit by a few f32 ulps of the running sums, far inside 1e-4).  bf16
``rtol=atol=2e-2`` (the flash kernel's own bf16 tolerance): activations are
rounded to bf16 (relative step 2^-8 = 3.9e-3) after every product, norm and
residual add, and the two frameworks round at slightly different places
(XLA may keep an elementwise chain in f32), so a logit below 1 can move by
a few bf16 steps over two layers (about 7e-3 seen).

The JAX model's logits, prefill and decode run jitted.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from test_torch_models_hybrid import random_tree
from repro_torch.configs import get_config, ModelConfig
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_numpy

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

DENSE = ["llama3-8b", "stablelm-1.6b", "qwen2.5-14b", "granite-8b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CASES = {
    "llama3-8b-f32": ("llama3-8b", "float32"),
    "stablelm-1.6b-f32": ("stablelm-1.6b", "float32"),
    "llama3-8b-bf16": ("llama3-8b", "bfloat16"),
}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", DENSE + ["zamba2-1.2b", "llama-3.2-vision-11b", "hubert-xlarge"])
def test_config_field_equal_to_jax(name, reduced):
    mine, theirs = get_config(name), j_get_config(name)
    if reduced:
        mine, theirs = mine.reduced(), theirs.reduced()
    assert isinstance(mine, ModelConfig)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()


def test_other_families_raise():
    """Every family of the JAX package builds (``ssm`` is the hybrid, as in
    JAX); an unknown family raises."""
    from repro_torch.configs.base import ModelConfig as Cfg
    from repro_torch.models import hybrid

    ssm = Cfg(name="m", family="ssm", n_layers=1, d_model=8, d_ff=8, vocab_size=8)
    assert build_model(ssm, "cpu").module is hybrid
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(ssm, family="diffusion"), "cpu")


def _cfgs(name: str, dtype: str):
    upd = dict(dtype=dtype, param_dtype=dtype)
    return (get_config(name).reduced().with_updates(**upd),
            j_get_config(name).reduced().with_updates(**upd))


@functools.cache
def _jax_tree(name: str, dtype: str, seed: int) -> dict:
    """A numpy tree of the JAX model's parameters (:func:`random_tree`,
    nothing compiled), each leaf in the dtype JAX's ``init`` gives it."""
    init = j_build_model(_cfgs(name, dtype)[1]).init
    return jax.tree.map(lambda a, s: a.astype(s.dtype), random_tree(init, seed),
                        jax.eval_shape(init, jax.random.key(0)))


@pytest.mark.parametrize("name,dtype", [("llama3-8b", "bfloat16"), ("stablelm-1.6b", "float32"),
                                        ("qwen2.5-14b", "float32"), ("granite-8b", "bfloat16")])
def test_params_round_trip(name, dtype):
    cfg, _ = _cfgs(name, dtype)
    tree = _jax_tree(name, dtype, 1)
    params = params_from_jax(cfg, tree, "cpu")
    assert len(params["layers"]) == cfg.n_layers
    wq = params["layers"][1]["attn"]["wq"]
    assert tuple(wq.shape) == (cfg.n_heads * cfg.resolved_head_dim, cfg.d_model)
    assert wq.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    np.testing.assert_array_equal(wq.float().numpy(),
                                  np.asarray(tree["layers"]["attn"]["wq"][1], np.float32).T)
    back = params_to_numpy(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name, dtype = CASES[request.param]
    cfg, jcfg = _cfgs(name, dtype)
    jm = j_build_model(jcfg)
    tree = _jax_tree(name, dtype, 0)
    jp = jax.tree.map(jax.numpy.asarray, tree)
    tm = build_model(cfg, "cpu")
    tp = params_from_jax(cfg, tree, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    return dict(cfg=cfg, jm=jm, jp=jp, tm=tm, tp=tp, tokens=tokens, tol=TOL[dtype],
                jlogits=_jitr(lambda p, t: jm.logits(p, {"tokens": t})),
                jprefill=_jitr(lambda p, t, c, n=None: jm.prefill(p, {"tokens": t}, c,
                                                                    true_len=n)),
                jdecode=_jitr(jm.decode_step))


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def test_logits_match_jax(case):
    want = case["jlogits"](case["jp"], case["tokens"])
    got = case["tm"].logits(case["tp"], {"tokens": torch.from_numpy(case["tokens"])})
    assert tuple(got.shape) == want.shape
    _close(got, want, case["tol"])


def test_prefill_exact_matches_jax(case):
    toks = case["tokens"]
    want, wcache = case["jprefill"](case["jp"], toks, case["jm"].init_cache(2, 16))
    got, gcache = case["tm"].prefill(case["tp"], {"tokens": torch.from_numpy(toks)},
                                     case["tm"].init_cache(2, 16))
    _close(got, want, case["tol"])
    for name in ("k", "v"):
        _close(gcache[name], wcache[name], case["tol"])
    np.testing.assert_array_equal(gcache["pos"].numpy(), np.asarray(wcache["pos"]))


def test_prefill_bucketed_matches_jax_and_exact(case):
    toks = case["tokens"][:1]
    padded = np.pad(toks, ((0, 0), (0, 4)))
    true_len = np.full((1,), toks.shape[1], np.int32)
    want, wcache = case["jprefill"](case["jp"], padded, case["jm"].init_cache(1, 16), true_len)
    tm, tp = case["tm"], case["tp"]
    got, gcache = tm.prefill(tp, {"tokens": torch.from_numpy(padded)}, tm.init_cache(1, 16),
                             true_len=torch.from_numpy(true_len))
    _close(got, want, case["tol"])
    _close(gcache["k"], wcache["k"], case["tol"])
    assert gcache["pos"].tolist() == [toks.shape[1]]
    exact, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tm.init_cache(1, 16))
    torch.testing.assert_close(got.float(), exact.float(), **case["tol"])


def test_decode_steps_match_jax(case):
    toks = case["tokens"]
    jm, tm = case["jm"], case["tm"]
    _, wcache = case["jprefill"](case["jp"], toks, jm.init_cache(2, 16))
    _, gcache = tm.prefill(case["tp"], {"tokens": torch.from_numpy(toks)}, tm.init_cache(2, 16))
    nxt = np.array([[3], [7]], np.int32)
    for _ in range(2):
        want, wcache = case["jdecode"](case["jp"], nxt, wcache)
        got, gcache = tm.decode_step(case["tp"], torch.from_numpy(nxt), gcache)
        assert tuple(got.shape) == want.shape == (2, 1, case["cfg"].vocab_size)
        _close(got, want, case["tol"])
        for name in ("k", "v"):
            _close(gcache[name], wcache[name], case["tol"])
        np.testing.assert_array_equal(gcache["pos"].numpy(), np.asarray(wcache["pos"]))
        nxt = np.asarray(want, np.float32)[:, 0].argmax(-1).astype(np.int32)[:, None]


def test_decode_past_the_cache_writes_nothing():
    cfg, _ = _cfgs("llama3-8b", "float32")
    tm = build_model(cfg, "cpu")
    params = tm.init(0)
    cache = tm.init_cache(2, 4)
    cache["pos"] = torch.tensor([1, 4], dtype=torch.int32)  # row 1 is past the end
    _, out = tm.decode_step(params, torch.tensor([[5], [6]]), cache)
    assert out["pos"].tolist() == [2, 5]
    assert cache["k"][:, 0, 1].abs().sum() > 0
    assert cache["k"][:, 1].abs().sum() == 0 and cache["v"][:, 1].abs().sum() == 0


def test_ring_context_raises():
    """The ring paths run on a one-process mesh (tests/test_torch_models_
    seqpar.py); on a mesh over several processes they are refused."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.parallel.context import ParallelContext

    cfg, _ = _cfgs("llama3-8b", "float32")
    tm = build_model(cfg, "cpu")
    params = tm.init(0)
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    grid = make_mesh((1, 2), ("data", "model"), device="cpu", processes=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.prefill(params, toks, tm.init_cache(1, 8),
                   ctx=ParallelContext(mesh=grid, seq_parallel=True))
    for ctx in (ParallelContext(mesh=grid, seq_parallel=True),
                ParallelContext(mesh=grid, tp_mode="ring")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm.logits(params, toks, ctx=ctx)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "granite-8b"])
def test_nonzero_qkv_biases_match_jax(name):
    """Reduced qwen2.5-14b with nonzero QKV biases (its ``init`` makes
    zeros, which no other test moves) and reduced granite-8b (tied
    embeddings; its published config has no QKV bias, so its params must
    hold none): logits, a prefill and one decode step against the JAX model
    in f32, at the f32 tolerance ``rtol=atol=1e-4`` (module docstring)."""
    cfg, jcfg = _cfgs(name, "float32")
    jm, tm = j_build_model(jcfg), build_model(cfg, "cpu")
    tree = dict(_jax_tree(name, "float32", 3))
    tree["layers"] = dict(tree["layers"], attn=dict(tree["layers"]["attn"]))  # a copy to edit
    rng = np.random.default_rng(4)
    attn = tree["layers"]["attn"]
    biases = ("bq", "bk", "bv")
    if cfg.qkv_bias:
        for b in biases:
            attn[b] = rng.normal(0.0, 0.5, size=attn[b].shape).astype(np.float32)
    else:
        assert not set(biases) & set(attn)
    jp = jax.tree.map(jax.numpy.asarray, tree)
    tp = params_from_jax(cfg, tree, "cpu")
    if cfg.qkv_bias:
        assert all(float(tp["layers"][i]["attn"][b].abs().min()) > 0
                   for i in range(cfg.n_layers) for b in biases)
    tol = TOL["float32"]
    toks = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    _close(tm.logits(tp, {"tokens": torch.from_numpy(toks)}),
           _jitr(lambda p, t: jm.logits(p, {"tokens": t}))(jp, toks), tol)
    want, wcache = _jitr(lambda p, t, c: jm.prefill(p, {"tokens": t}, c))(
        jp, toks, jm.init_cache(2, 16))
    got, gcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tm.init_cache(2, 16))
    _close(got, want, tol)
    for k in ("k", "v"):
        _close(gcache[k], wcache[k], tol)
    nxt = np.asarray(want, np.float32)[:, 0].argmax(-1).astype(np.int32)[:, None]
    want, wcache = _jitr(jm.decode_step)(jp, nxt, wcache)
    got, gcache = tm.decode_step(tp, torch.from_numpy(nxt), gcache)
    _close(got, want, tol)
    for k in ("k", "v"):
        _close(gcache[k], wcache[k], tol)
