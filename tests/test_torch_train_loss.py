"""The port's training loss and its gradients against the JAX package, on
the CPU.

The same parameters (the JAX package's ``init``, carried over by
``repro_torch.models.convert``) and the same batch (numpy, seeded) go
through JAX's ``jax.value_and_grad`` of ``Model.loss`` (its plain
attention, ``use_flash=False``) and the port's ``Model.loss`` with
``torch.autograd.grad`` (its plain attention on the CPU).  Reduced configs
in f32, 2 layers, S = 16, with and without ``logits_chunk`` (4) and a mask.

Tolerances, stated: the loss within 1e-5 relative, every gradient leaf
within 1e-4 relative L2 (XLA and PyTorch sum the products, the softmax and
the log-softmax in other orders, a few f32 ulps of each running sum).  The
remat policies change no value: equal bitwise on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro_torch.configs import get_config
from repro_torch.configs.base import all_configs
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.train.optimizer import tree_leaves, tree_unflatten

torch.set_num_threads(1)

ARCHS = ("stablelm-1.6b", "llama3-8b")
B, S, CHUNK = 2, 16, 4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _cfgs(name: str, **upd):
    upd = dict(dtype="float32", param_dtype="float32", **upd)
    return (get_config(name).reduced().with_updates(**upd),
            j_get_config(name).reduced().with_updates(**upd))


def _batch(vocab: int, masked: bool, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if masked:
        out["mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's parameters of each reduced config, as numpy."""
    return {name: jax.tree.map(np.asarray,
                               j_build_model(_cfgs(name)[1]).init(jax.random.key(7)))
            for name in ARCHS}


def _port_loss_and_grads(cfg, tree, batch):
    model = build_model(cfg, "cpu")
    params = params_from_jax(cfg, tree, "cpu")
    leaves = [p.requires_grad_() for _, p in tree_leaves(params)]
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), params_to_numpy(cfg, tree_unflatten(params, list(grads)))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("chunk,masked", [(0, False), (CHUNK, True)],
                         ids=["whole", "chunk4-masked"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(jax_params, name, chunk, masked):
    cfg, jcfg = _cfgs(name, logits_chunk=chunk)
    tree = jax_params[name]
    batch = _batch(cfg.vocab_size, masked)
    jmodel = j_build_model(jcfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b)))(jax.tree.map(jnp.asarray, tree),
                                         jax.tree.map(jnp.asarray, batch))
    got_loss, got_grads = _port_loss_and_grads(cfg, tree, batch)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=LOSS_RTOL)
    flat_want = jax.tree_util.tree_leaves_with_path(want_grads)
    flat_got = jax.tree.leaves(got_grads)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        assert g.shape == w.shape, path
        assert _rel(g, w) <= GRAD_RTOL, (jax.tree_util.keystr(path), _rel(g, w))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_chunked_loss_equals_whole(jax_params, masked):
    """``logits_chunk`` changes the order of the sums alone: the chunked
    loss and gradients within f32 rounding of the whole-sequence ones (each
    held against JAX above)."""
    batch = _batch(128, masked)
    whole = _port_loss_and_grads(_cfgs("stablelm-1.6b")[0], jax_params["stablelm-1.6b"], batch)
    chunked = _port_loss_and_grads(_cfgs("stablelm-1.6b", logits_chunk=CHUNK)[0],
                                   jax_params["stablelm-1.6b"], batch)
    np.testing.assert_allclose(chunked[0], whole[0], rtol=LOSS_RTOL)
    for g, w in zip(jax.tree.leaves(chunked[1]), jax.tree.leaves(whole[1])):
        assert _rel(g, w) <= GRAD_RTOL


def test_remat_policies_change_no_value(jax_params):
    """``remat`` none, full and dots: the same loss and gradients, bitwise."""
    out = {}
    batch = _batch(128, masked=True)
    for remat in ("none", "full", "dots"):
        cfg, _ = _cfgs("llama3-8b", remat=remat, logits_chunk=CHUNK)
        out[remat] = _port_loss_and_grads(cfg, jax_params["llama3-8b"], batch)
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for g, w in zip(jax.tree.leaves(out[remat][1]), jax.tree.leaves(out["none"][1])):
            np.testing.assert_array_equal(g, w)


def test_cross_entropy_masks_and_guards_an_empty_mask():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.5).astype(np.float32)
    from repro.models import layers as JL

    for m in (None, mask, np.zeros_like(mask)):
        got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


def test_loss_of_other_families_raises():
    """Only the dense family's loss is ported: the others name the ROADMAP
    item they wait for instead of returning a loss."""
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32),
             "labels": torch.zeros((1, 4), dtype=torch.int32)}
    for name, item in (("rwkv6-1.6b", "item 19"), ("phi3.5-moe-42b-a6.6b", "item 18"),
                       ("zamba2-1.2b", "item 18"), ("hubert-xlarge", "item 18"),
                       ("llama-3.2-vision-11b", "item 18")):
        model = build_model(get_config(name).reduced(), "cpu")
        with pytest.raises(NotImplementedError, match=item):
            model.loss(model.init("meta"), batch)


@pytest.mark.parametrize("name", sorted(j_all_configs()))
def test_config_methods_equal_jax(name):
    """The methods the port's config gained with training: equal to JAX's
    for every registered config."""
    mine, theirs = get_config(name), j_get_config(name)
    assert sorted(all_configs()) == sorted(j_all_configs())
    assert mine.active_param_count() == theirs.active_param_count()
    for seq in (1, 4096, 32768):
        for kind in ("train", "prefill", "decode"):
            assert mine.model_flops_per_token(seq, kind) == theirs.model_flops_per_token(seq, kind)
    assert mine.supports_long_context == theirs.supports_long_context
    assert ([dataclasses.asdict(s) for s in mine.shapes()]
            == [dataclasses.asdict(s) for s in theirs.shapes()])
    assert mine.skipped_shapes() == theirs.skipped_shapes()
