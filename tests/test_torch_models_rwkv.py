"""RWKV-6 model of the port against the JAX package, on the CPU.

The same parameters (drawn with numpy in the shapes and dtypes of the JAX
package's ``init`` and at its statistics, so nothing compiles for them,
with ``w_lora_b`` nonzero so that the decay LoRA path counts; carried over
by ``repro_torch.models.convert``) and the same tokens (numpy, seeded)
go through ``repro.models.build_model(cfg)`` and the port's
``build_model(cfg, "cpu")``, whose scan takes the plain WKV on the CPU.
Prompt lengths 12, 64 and 128 with the config's chunk of 64: one short
chunk, one whole chunk, and the state carried from one chunk to the next.

Tolerances, stated: f32 ``rtol=atol=1e-4`` (two layers of width 64; the
cumulative sums and products of the scan are summed in other orders, a few
f32 ulps), for the logits and every cache entry.  bf16 ``rtol=atol=2e-2``
(the dense model's bf16 tolerance) for the logits: activations are rounded
to bf16 after every product, mix and residual add, at slightly different
places in the two frameworks; the scan itself runs in f32 in both.  In bf16
the cache is compared at that tolerance for the first layer only, whose
carries agree to a bf16 step: the second layer's carries are normed
activations of magnitude 2-7, where one bf16 step is 0.016-0.03, and after
the first layer's residual stream they differ by 1-3 steps (the f32 case
holds every layer's carries to 1e-4).

The JAX model's logits, prefill and decode run jitted (once per config and
shape; eagerly, its layer scan compiles again on every call).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro_torch.configs import ModelConfig, get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

NAME = "rwkv6-1.6b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
CACHE = ("tm_shift", "cm_shift", "wkv")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_field_equal_to_jax(reduced):
    mine, theirs = get_config(NAME), j_get_config(NAME)
    if reduced:
        mine, theirs = mine.reduced(), theirs.reduced()
    assert isinstance(mine, ModelConfig)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()


def _cfgs(dtype: str):
    upd = dict(dtype=dtype, param_dtype=dtype)
    return (get_config(NAME).reduced().with_updates(**upd),
            j_get_config(NAME).reduced().with_updates(**upd))


def _jit(fn):
    """``jax.jit`` with XLA's backend optimisation off, which about halves
    a compile here."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


@functools.cache
def random_rwkv_tree(jcfg, seed: int) -> dict:
    """A numpy tree of the JAX model's parameters at the statistics of its
    ``init`` (``models/rwkv.py`` ``layer_params``: mixes uniform in [0.25,
    0.75], ``w_base`` normal 0.5 about -1, ``u`` normal 0.1, matrices normal
    over the root of their fan-in, embeddings normal 0.02, norms one and
    zero), with ``w_lora_b`` normal 0.5 instead of zeros; each leaf in the
    shape and dtype ``init`` gives it (``eval_shape``, nothing compiled)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path[-1:])[2:-2]
        if name in ("scale", "bias"):
            x = np.full(a.shape, 1.0 if name == "scale" else 0.0)
        elif name in ("mu", "mu_c"):
            x = rng.uniform(size=a.shape) * 0.5 + 0.25
        elif name == "w_base":
            x = rng.normal(size=a.shape) * 0.5 - 1.0
        elif name in ("u", "w_lora_b"):
            x = rng.normal(size=a.shape) * (0.1 if name == "u" else 0.5)
        elif name in ("embed", "lm_head"):
            x = rng.normal(size=a.shape) * 0.02
        else:  # an (in, out) matrix, stacked over the layers
            x = rng.normal(size=a.shape) / np.sqrt(a.shape[-2])
        return x.astype(np.float32).astype(a.dtype)

    init = j_build_model(jcfg).init
    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.key(0)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_round_trip(dtype):
    cfg, jcfg = _cfgs(dtype)
    tree = random_rwkv_tree(jcfg, 0)  # the tree the model cases below share
    params = params_from_jax(cfg, tree, "cpu")
    assert len(params["layers"]) == cfg.n_layers
    lp, d = params["layers"][1], cfg.d_model
    assert tuple(lp["ck"].shape) == (cfg.d_ff, d) and tuple(lp["cv"].shape) == (d, cfg.d_ff)
    assert tuple(lp["w_lora_a"].shape) == (32, d) and tuple(lp["w_lora_b"].shape) == (d, 32)
    assert tuple(lp["w_base"].shape) == (d,) and tuple(lp["mu"].shape) == (5, d)
    assert tuple(lp["u"].shape) == (d // cfg.rwkv_head_size, cfg.rwkv_head_size)
    assert set(lp["ln1"]) == {"scale", "bias"} and set(params["ln_in"]) == {"scale", "bias"}
    np.testing.assert_array_equal(lp["ck"].float().numpy(),
                                  np.asarray(tree["layers"]["ck"][1], np.float32).T)
    back = params_to_numpy(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    dtype = request.param
    cfg, jcfg = _cfgs(dtype)
    tree = random_rwkv_tree(jcfg, 0)
    jm = j_build_model(jcfg)
    return dict(cfg=cfg, jm=jm, jp=jax.tree.map(jnp.asarray, tree),
                jlogits=_jit(lambda p, t: jm.logits(p, {"tokens": t})),
                jprefill=_jit(lambda p, t, c: jm.prefill(p, {"tokens": t}, c)),
                jdecode=_jit(jm.decode_step),
                tm=build_model(cfg, "cpu"), tp=params_from_jax(cfg, tree, "cpu"),
                tol=TOL[dtype])


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def _close_cache(got: dict, want: dict, dtype: torch.dtype, tol) -> None:
    """Every layer's carries in f32; the first layer's in bf16 (see above)."""
    layers = slice(None) if dtype == torch.float32 else slice(0, 1)
    for name in CACHE:
        _close(got[name][layers], np.asarray(want[name], np.float32)[layers], tol)


def _tokens(cfg, length: int) -> np.ndarray:
    return np.random.default_rng(length).integers(0, cfg.vocab_size, size=(2, length)).astype(np.int32)


@pytest.mark.parametrize("length", [12, 64, 128])
def test_logits_match_jax(case, length):
    toks = _tokens(case["cfg"], length)
    want = case["jlogits"](case["jp"], toks)
    got = case["tm"].logits(case["tp"], {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape == (2, length, case["cfg"].vocab_size)
    _close(got, want, case["tol"])


@pytest.mark.parametrize("length", [12, 64, 128])
def test_prefill_and_decode_steps_match_jax(case, length):
    """Prefill (last-position logits, every cache entry, ``pos`` = length),
    then three decode steps fed the JAX model's own greedy tokens."""
    toks = _tokens(case["cfg"], length)
    jm, tm = case["jm"], case["tm"]
    want, wcache = case["jprefill"](case["jp"], toks, jm.init_cache(2, 16))
    cache0 = tm.init_cache(2, 16)
    got, gcache = tm.prefill(case["tp"], {"tokens": torch.from_numpy(toks)}, cache0)
    assert tuple(got.shape) == want.shape == (2, 1, case["cfg"].vocab_size)
    assert all(cache0[n].abs().sum() == 0 for n in CACHE)  # the given cache is left as it is
    _close(got, want, case["tol"])
    dtype = got.dtype
    for name in CACHE:
        assert gcache[name].dtype == (torch.float32 if name == "wkv" else dtype)
    _close_cache(gcache, wcache, dtype, case["tol"])
    assert gcache["pos"].tolist() == np.asarray(wcache["pos"]).tolist() == [length, length]
    nxt = np.asarray(want, np.float32)[:, 0].argmax(-1).astype(np.int32)[:, None]
    for _ in range(3):
        want, wcache = case["jdecode"](case["jp"], nxt, wcache)
        got, gcache = tm.decode_step(case["tp"], torch.from_numpy(nxt), gcache)
        assert tuple(got.shape) == want.shape == (2, 1, case["cfg"].vocab_size)
        _close(got, want, case["tol"])
        _close_cache(gcache, wcache, dtype, case["tol"])
        np.testing.assert_array_equal(gcache["pos"].numpy(), np.asarray(wcache["pos"]))
        nxt = np.asarray(want, np.float32)[:, 0].argmax(-1).astype(np.int32)[:, None]


def test_prefill_then_decode_equals_longer_prefill():
    """The recurrent state carries exactly: prefill of 12 tokens plus one
    decode step gives the logits of a prefill of the 13 tokens."""
    cfg, _ = _cfgs("float32")
    tm = build_model(cfg, "cpu")
    params = tm.init(torch.Generator("cpu").manual_seed(3))
    toks = torch.from_numpy(_tokens(cfg, 13)).long()
    _, cache = tm.prefill(params, {"tokens": toks[:, :12]}, tm.init_cache(2, 16))
    got, _ = tm.decode_step(params, toks[:, 12:], cache)
    want, _ = tm.prefill(params, {"tokens": toks}, tm.init_cache(2, 16))
    torch.testing.assert_close(got, want, **TOL["float32"])


def test_length_100_raises_in_both_packages():
    """The reference's quirk: with a chunk of 64, a prompt above 64 tokens
    that is not a multiple of 64 is refused by the JAX scan, and the port
    refuses the same prompt."""
    cfg, jcfg = _cfgs("float32")
    toks = _tokens(cfg, 100)
    jm = j_build_model(jcfg)
    with pytest.raises(AssertionError):
        jm.prefill(jax.tree.map(jnp.asarray, random_rwkv_tree(jcfg, 0)), {"tokens": toks},
                   jm.init_cache(2, 16))
    tm = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.prefill(tm.init(0), {"tokens": torch.from_numpy(toks)}, tm.init_cache(2, 16))


def test_sequence_parallel_context_raises():
    """The sequence-parallel time mix runs on a one-process mesh
    (tests/test_torch_models_seqpar.py); on a mesh over several processes it
    is refused."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.parallel.context import ParallelContext

    cfg, _ = _cfgs("float32")
    tm = build_model(cfg, "cpu")
    toks = {"tokens": torch.zeros((1, 8), dtype=torch.long)}
    grid = make_mesh((1, 2), ("data", "model"), device="cpu", processes=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.logits(tm.init(0), toks, ctx=ParallelContext(mesh=grid, seq_parallel=True))


def test_injected_wkv_is_used():
    """``build_model(..., wkv=...)`` routes every scan of the model through
    the given function (prefill, decode and logits)."""
    from repro_torch.kernels.wkv import wkv_plain

    calls = []

    def counting(*args, **kw):
        calls.append(args[0].shape[1])
        return wkv_plain(*args, **kw)

    cfg, _ = _cfgs("float32")
    tm = build_model(cfg, "cpu", wkv=counting)
    params = tm.init(0)
    toks = torch.zeros((1, 8), dtype=torch.long)
    _, cache = tm.prefill(params, {"tokens": toks}, tm.init_cache(1, 8))
    tm.decode_step(params, toks[:, :1], cache)
    tm.logits(params, {"tokens": toks})
    assert calls == [8] * cfg.n_layers + [1] * cfg.n_layers + [8] * cfg.n_layers
