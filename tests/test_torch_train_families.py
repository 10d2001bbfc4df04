"""The training loss of every family the dense one's test
(``tests/test_torch_train_loss.py``) does not cover, and its gradients,
against the JAX package's, on the CPU: rwkv (the WKV scan, whose backward
on the card is the hand-written ``wkv_chunked_bwd``), moe (with the
router's load-balance loss), hybrid (mamba blocks, the shared attention
block and a tail), vlm (gated cross attention over ``vision_emb``) and
audio (masked cluster prediction over ``frames``).

The same parameters (numpy, in the shapes of the JAX package's ``init``
at its statistics: ``random_tree``, ``random_rwkv_tree``; nothing
compiles for them) and the same batch go through ``jax.value_and_grad``
of JAX's ``Model.loss`` (jitted once a case) and the port's
``Model.loss`` with ``torch.autograd.grad``.  Reduced configs in f32,
B = 2, S = 32, the WKV and SSD scans in two chunks of 16, the hybrid's
group of two mamba layers and the shared block followed by a tail layer;
each family without a mask and with one (and a ``logits_chunk`` of 8).
Without a mask the encoder's ``mask_emb`` is not used: its gradient is
zeros, as JAX's.

Tolerances, stated, as ``tests/test_torch_train_loss.py``: the loss within
1e-5 relative, every gradient leaf within 1e-4 relative L2.  Remat changes
no value: equal bitwise on the CPU.

With a mask the case also takes one AdamW step from the same parameters
(zero moments) on the same batch (a mask is what the pipeline gives the
encoder: without one its ``mask_emb`` takes no part in the loss, and the
port's step, which takes every leaf's gradient without ``allow_unused``,
raises where JAX's steps it by a zero gradient): the port's
``make_train_step`` against JAX's step at one microbatch, which is
``value_and_grad`` of the loss, ``compress_grads`` and ``adamw_update``
(``src/repro/train/train_loop.py``): the case's compiled ``value_and_grad``
with JAX's ``adamw_update`` jitted on its own (a JAX compile of the whole
step would double the file's time).  Tolerances as
``tests/test_torch_train_step.py``: the parameters after the step within
1e-4 relative L2 over the tree, moved by more than 1e-3.
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
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import compress_grads as j_compress_grads
from test_torch_models_hybrid import random_tree
from test_torch_models_rwkv import random_rwkv_tree
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.models import build_model
from repro_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.train.optimizer import tree_leaves, tree_unflatten
from repro_torch.train.train_loop import make_train_step

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

#: family -> (config, its reduced config's updates beside f32)
FAMILIES = {
    "rwkv": ("rwkv6-1.6b", dict(scan_chunk=16)),
    "moe": ("phi3.5-moe-42b-a6.6b", {}),
    "hybrid": ("zamba2-1.2b", dict(n_layers=3, scan_chunk=16)),
    "vlm": ("llama-3.2-vision-11b", {}),
    "audio": ("hubert-xlarge", {}),
}
B, S, CHUNK = 2, 32, 8
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=20)


def cfgs(family: str, **upd):
    """(port config, JAX config): the family's reduced config in f32."""
    name, own = FAMILIES[family]
    upd = dict(dtype="float32", param_dtype="float32", **own, **upd)
    return (get_config(name).reduced().with_updates(**upd),
            j_get_config(name).reduced().with_updates(**upd))


@functools.cache
def jax_tree(family: str) -> dict:
    """The family's parameters in the JAX package's tree, numpy."""
    _, jcfg = cfgs(family)
    if family == "rwkv":
        return random_rwkv_tree(jcfg, 7)
    return random_tree(j_build_model(jcfg).init, 7)


def jax_state(family: str) -> dict:
    """The JAX train state (numpy) of the family's parameters: zero f32
    moments, step 0."""
    params = jax_tree(family)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params)
    return {"params": params,
            "opt": {"m": zeros, "v": jax.tree.map(np.copy, zeros),
                    "step": np.zeros((), np.int32)}}


def batch_of(cfg, masked: bool, seed: int = 3) -> dict:
    """A numpy batch of the family's keys (audio: ``frames``, vlm:
    ``vision_emb`` beside the tokens), with a mask of 60 % when ``masked``."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, S, cfg.d_vision)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        out["vision_emb"] = rng.normal(size=(B, cfg.vision_tokens, cfg.d_vision)).astype(
            np.float32)
    if masked:
        out["mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return out


def port_loss_and_grads(cfg, tree, batch):
    """The port's loss and its gradients, as a JAX-layout numpy tree."""
    model = build_model(cfg, "cpu")
    params = params_from_jax(cfg, tree, "cpu")
    leaves = [p.requires_grad_() for _, p in tree_leaves(params)]
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    # zeros for a leaf the loss does not use (mask_emb without a mask), as JAX
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss.item(), params_to_numpy(cfg, tree_unflatten(params, list(grads)))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree.leaves(tree)])


def _step_matches_jax(cfg, family, batch, want_grads):
    """One AdamW step of the port against JAX's at one microbatch, from the
    gradients JAX's ``value_and_grad`` gave (see the module docstring)."""
    state = jax_state(family)
    jopt = JOptimizerConfig(**OPT)
    grads = j_compress_grads(want_grads, jopt.grad_compression)
    want_p, _, _ = _jitr(lambda p, g, o: j_adamw_update(p, g, o, jopt))(
        *(jax.tree.map(jnp.asarray, t) for t in (state["params"], grads, state["opt"])))
    step = make_train_step(build_model(cfg, "cpu"), OptimizerConfig(**OPT))
    got, _ = step(train_state_from_jax(cfg, state, "cpu"),
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    got = train_state_to_numpy(cfg, got)
    assert int(got["opt"]["step"]) == 1
    want_p, got_p, start = _flat(want_p), _flat(got["params"]), _flat(state["params"])
    assert np.linalg.norm(got_p - want_p) / np.linalg.norm(want_p) <= 1e-4
    assert np.linalg.norm(want_p - start) / np.linalg.norm(want_p) > 1e-3


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked-chunk8-step"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_jax(family, masked):
    cfg, jcfg = cfgs(family, logits_chunk=CHUNK if masked else 0)
    tree = jax_tree(family)
    batch = batch_of(cfg, masked)
    jmodel = j_build_model(jcfg)
    want_loss, want_grads = _jitr(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b)))(jax.tree.map(jnp.asarray, tree),
                                         jax.tree.map(jnp.asarray, batch))
    got_loss, got_grads = port_loss_and_grads(cfg, tree, batch)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=LOSS_RTOL)
    flat_want = jax.tree_util.tree_leaves_with_path(want_grads)
    flat_got = jax.tree.leaves(got_grads)
    assert len(flat_got) == len(flat_want)
    for (path, w), g in zip(flat_want, flat_got):
        assert g.shape == w.shape, path
        assert rel(g, w) <= GRAD_RTOL, (jax.tree_util.keystr(path), rel(g, w))
        unused = family == "audio" and not masked and "mask_emb" in jax.tree_util.keystr(path)
        assert unused or np.linalg.norm(g) > 0, jax.tree_util.keystr(path)  # leaf reached
    if masked:
        _step_matches_jax(cfg, family, batch, want_grads)


def test_remat_changes_no_value():
    """Each family's remat (rwkv and the hybrid's mamba blocks: the whole
    block; moe, vlm, audio: ``"dots"``, selective) gives the loss and the
    gradients of ``remat="none"``, bitwise."""
    for family in sorted(FAMILIES):
        out = {}
        for remat in ("none", "full", "dots"):
            cfg, _ = cfgs(family, remat=remat)
            out[remat] = port_loss_and_grads(cfg, jax_tree(family), batch_of(cfg, True))
        for remat in ("full", "dots"):
            assert out[remat][0] == out["none"][0], (family, remat)
            for g, w in zip(jax.tree.leaves(out[remat][1]), jax.tree.leaves(out["none"][1])):
                np.testing.assert_array_equal(g, w, err_msg=f"{family} {remat}")
