"""The port's AdamW, LR schedule, clipping and gradient compression against
the JAX package's (``repro.train.optimizer``), on the CPU.

AdamW runs 3 steps from the same reduced stablelm-1.6b parameters (the JAX
package's ``init``, carried over by ``repro_torch.models.convert``) with
the same numpy gradients, f32 and bf16 moments.  Tolerances, stated:
parameters and f32 moments within 1e-5 relative L2 per leaf (the same f32
operations; ``b ** step`` and the global norm's sum may round apart by an
ulp); bf16 moments within 1e-2 (an ulp-level difference before the bf16
rounding can move a value by one bf16 step, 2^-8).  The schedule within
1e-6 relative; clipping of integer-valued trees (exact sums) and the bf16
cast bitwise.  ``int8_stochastic`` draws its noise from a
``torch.Generator``, whose bits are not ``jax.random``'s, so it is held by
its properties: an error of at most one scale step, unbiased in the mean
over seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.models import build_model as j_build_model
from repro.train import optimizer as J
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.train import optimizer as O

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

CFG = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0)
ARCH = "stablelm-1.6b"
STEPS = 3


def _cfgs():
    upd = dict(dtype="float32", param_dtype="float32")
    return (get_config(ARCH).reduced().with_updates(**upd),
            j_get_config(ARCH).reduced().with_updates(**upd))


@pytest.fixture(scope="module")
def tree_and_grads():
    """JAX-layout params of reduced stablelm (layernorm: per-layer scales
    and biases stacked ``(L, d)``) and 3 steps of numpy gradients."""
    tree = jax.tree.map(np.asarray, j_build_model(_cfgs()[1]).init(jax.random.key(2)))
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32), tree)
             for _ in range(STEPS)]
    return tree, grads


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_three_steps(tree_and_grads, state_dtype):
    cfg, _ = _cfgs()
    tree, grads = tree_and_grads
    jcfg, ocfg = JOptimizerConfig(**CFG), OptimizerConfig(**CFG)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = J.init_opt_state(jparams, jcfg, state_dtype)
    params = params_from_jax(cfg, tree, "cpu")
    opt = O.init_opt_state(params, ocfg, state_dtype)
    update = _jitr(lambda p, g, o: J.adamw_update(p, g, o, jcfg))
    for g in grads:
        jparams, jopt, jmet = update(jparams, jax.tree.map(jnp.asarray, g), jopt)
        params, opt, met = O.adamw_update(params, params_from_jax(cfg, g, "cpu"), opt, ocfg)
        np.testing.assert_allclose(met["lr"].item(), float(jmet["lr"]), rtol=1e-6)
        np.testing.assert_allclose(met["grad_norm"].item(), float(jmet["grad_norm"]), rtol=1e-5)
    assert int(opt["step"]) == int(jopt["step"]) == STEPS
    moment_tol = 1e-5 if state_dtype == "float32" else 1e-2
    for name, got, want, tol in (("params", params, jparams, 1e-5), ("m", opt["m"], jopt["m"],
                                                                      moment_tol),
                                 ("v", opt["v"], jopt["v"], moment_tol)):
        got = params_to_numpy(cfg, got)
        for (path, w), gl in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree.leaves(got)):
            assert str(gl.dtype) == str(w.dtype), path
            assert _rel(np.asarray(gl, np.float32), np.asarray(w, np.float32)) <= tol, (
                name, jax.tree_util.keystr(path))


def test_per_layer_norm_scales_are_decayed_as_jax_stacks_them():
    """JAX decays leaves with ``ndim >= 2`` of its stacked tree, so each
    layer's ``(L, d)`` norm scale is decayed and the final ``(d,)`` norm is
    not; the port's per-layer scales are ``(d,)`` and must be decayed too.
    With zero gradients AdamW moves a parameter by weight decay alone."""
    cfg, _ = _cfgs()
    params = params_from_jax(cfg, jax.tree.map(
        np.asarray, j_build_model(_cfgs()[1]).init(jax.random.key(0))), "cpu")
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=0, total_steps=10, min_lr_ratio=1.0)
    before = O.tree_map(lambda p: p.clone(), params)
    zeros = O.tree_map(torch.zeros_like, params)
    O.adamw_update(params, zeros, O.init_opt_state(params, ocfg), ocfg)
    layer_scale = params["layers"][0]["norm_attn"]["scale"]
    assert torch.allclose(layer_scale, before["layers"][0]["norm_attn"]["scale"] * (1 - 1e-3))
    assert torch.equal(params["norm_f"]["scale"], before["norm_f"]["scale"])
    assert O.stacked_ndim(("layers", 0, "norm_attn", "scale"), layer_scale) == 2
    assert O.stacked_ndim(("norm_f", "scale"), params["norm_f"]["scale"]) == 1


@pytest.mark.parametrize("step", [0, 1, 5, 10, 60, 100, 250])
def test_lr_schedule_matches_jax(step):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = O.lr_schedule(OptimizerConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = J.lr_schedule(JOptimizerConfig(**kw), jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_is_exact(max_norm):
    rng = np.random.default_rng(1)
    tree = {"a": rng.integers(-4, 5, (10,)).astype(np.float32),
            "b": {"c": rng.integers(-4, 5, (3, 2)).astype(np.float32)}}
    got, gnorm = O.clip_by_global_norm(jax.tree.map(torch.from_numpy, tree), max_norm)
    want, wnorm = J.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    assert gnorm.item() == float(wnorm)
    for g, w in zip(jax.tree.leaves(O.tree_map(lambda t: t.numpy(), got)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_compress_none_and_bf16_are_exact():
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(5, 7)).astype(np.float32), "b": rng.normal(size=(3,)).astype(
        np.float32)}
    ttree = jax.tree.map(torch.from_numpy, tree)
    assert O.compress_grads(ttree, "none") is ttree
    got = O.compress_grads(ttree, "bf16")
    want = J.compress_grads(jax.tree.map(jnp.asarray, tree), "bf16")
    for k in tree:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k].astype(jnp.float32)))
    with pytest.raises(ValueError):
        O.compress_grads(ttree, "fp4")


def test_compress_int8_stochastic_bounded_and_unbiased():
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    scale = g.abs().max().item() / 127.0
    outs = torch.stack([O.compress_grads({"g": g}, "int8_stochastic",
                                         torch.Generator().manual_seed(s))["g"]
                        for s in range(400)])
    assert (outs - g).abs().max().item() <= scale * (1 + 1e-6)
    # the mean error over 400 seeds: about scale * 0.3 / 20 one sigma
    assert (outs.mean(0) - g).abs().max().item() <= 0.1 * scale
    # the quantized values sit on the scale grid
    steps = outs / scale
    assert torch.allclose(steps, steps.round(), atol=1e-3)
    # one seed, one answer
    a = O.compress_grads({"g": g}, "int8_stochastic")["g"]
    assert torch.equal(a, O.compress_grads({"g": g}, "int8_stochastic")["g"])
