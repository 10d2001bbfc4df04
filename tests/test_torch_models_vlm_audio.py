"""llama-3.2-vision's decoder, hubert's encoder and the local attention's
blockwise form of the port against the JAX package, on the CPU.

Reduced llama-3.2-vision-11b (2 layers: one self and one cross layer,
width 64, 4 heads on 2 kv heads of 16, 8 vision tokens of width 32) and
reduced hubert-xlarge (2 layers, width 64, 4 heads of 16, non-causal,
layernorm, gelu, frames of width 32), in f32.  Parameters are drawn with
numpy (``tests/test_torch_models_hybrid.py``'s ``random_tree``), the VLM's
tanh gates moved off JAX's zero, so the cross layers count (at zero the
model is the text decoder), with a random ``vision_emb``; they are carried
over by ``repro_torch.models.convert``.  Every JAX call is jitted.

Tolerances, stated: the model's logits and caches ``rtol=atol=1e-4``, the
port's model tolerance against JAX (``tests/test_torch_models.py``); one
cross-attention call and ``blockwise_attention`` ``rtol=atol=1e-5`` (f32,
the same products summed in other orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import layers as j_layers
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import params_from_jax, params_to_numpy
from test_torch_models_hybrid import random_tree

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

VLM, AUDIO = "llama-3.2-vision-11b", "hubert-xlarge"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _models(name: str, seed: int):
    cfg = get_config(name).reduced().with_updates(**F32)
    jm = j_build_model(j_get_config(name).reduced().with_updates(**F32))
    tree = random_tree(jm.init, seed)
    return cfg, jm, jax.tree.map(jnp.asarray, tree), build_model(cfg, "cpu"), \
        params_from_jax(cfg, tree, "cpu"), tree


@pytest.fixture(scope="module")
def vlm():
    return _models(VLM, 0)


@pytest.fixture(scope="module")
def audio():
    return _models(AUDIO, 1)


def _batch(cfg, b: int, s: int, seed: int) -> tuple[dict, dict]:
    """The same batch for JAX (numpy) and the port (tensors)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        frames = rng.normal(size=(b, s, cfg.d_vision)).astype(np.float32)
        return {"frames": frames}, {"frames": torch.from_numpy(frames)}
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    vis = rng.normal(size=(b, cfg.vision_tokens, cfg.d_vision)).astype(np.float32)
    return ({"tokens": tokens, "vision_emb": vis},
            {"tokens": torch.from_numpy(tokens).long(), "vision_emb": torch.from_numpy(vis)})


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_params_round_trip_and_layout(vlm, audio, name):
    cfg, jm, jp, tm, tp, tree = vlm if name == VLM else audio
    if name == VLM:
        assert len(tp["self_groups"]) == 1 and len(tp["self_groups"][0]) == 1
        np.testing.assert_array_equal(tp["vision_proj"].numpy(), tree["vision_proj"].T)
        xa = tp["cross"][0]["xattn"]
        np.testing.assert_array_equal(xa["wq"].numpy(), tree["cross"]["xattn"]["wq"][0].T)
        np.testing.assert_array_equal(xa["gate_attn"].numpy(), tree["cross"]["xattn"]["gate_attn"][0])
    else:
        np.testing.assert_array_equal(tp["head"].numpy(), tree["head"].T)  # (V, d) here
        np.testing.assert_array_equal(tp["frame_proj"].numpy(), tree["frame_proj"].T)
        np.testing.assert_array_equal(tp["mask_emb"].numpy(), tree["mask_emb"])
    back = params_to_numpy(cfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_bf16_trees_round_trip_exactly(vlm):
    cfg, jm, jp, tm, tp, tree = vlm
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    back = params_to_numpy(cfg, params_from_jax(cfg, bf, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(bf)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint16), b.view(np.uint16))


def test_vlm_logits_match_jax_and_the_cross_layers_count(vlm):
    cfg, jm, jp, tm, tp, tree = vlm
    jb, tb = _batch(cfg, 2, 12, seed=2)
    want = np.asarray(_jitr(lambda p, b: jm.logits(p, b))(jp, jb))
    got = tm.logits(tp, tb)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    # another image moves the logits: the cross layers are not the identity
    other = dict(tb, vision_emb=torch.flip(tb["vision_emb"], dims=[1]) * 2)
    assert (tm.logits(tp, other) - got).abs().max() > 1e-2


def test_vlm_prefill_then_decode_match_jax(vlm):
    cfg, jm, jp, tm, tp, tree = vlm
    jb, tb = _batch(cfg, 2, 12, seed=3)
    steps = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 3)).astype(np.int32)
    want, jcache = _jitr(lambda p, b, c: jm.prefill(p, b, c))(jp, jb, jm.init_cache(2, 32))
    got, cache = tm.prefill(tp, tb, tm.init_cache(2, 32))
    jdecode = _jitr(jm.decode_step)
    for i in range(steps.shape[1] + 1):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        for key in jcache:
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                       err_msg=key, **MODEL_TOL)
        if i < steps.shape[1]:
            want, jcache = jdecode(jp, steps[:, i:i + 1], jcache)
            got, cache = tm.decode_step(tp, torch.from_numpy(steps[:, i:i + 1]).long(), cache)


def test_vlm_prefill_has_no_bucketed_form(vlm):
    cfg, jm, jp, tm, tp, tree = vlm
    _, tb = _batch(cfg, 1, 4, seed=0)
    with pytest.raises(ValueError, match="bucketed"):
        tm.prefill(tp, tb, tm.init_cache(1, 8), true_len=torch.tensor([3]))


def test_cross_attention_matches_jax(vlm):
    cfg, jm, jp, tm, tp, tree = vlm
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    feats = rng.normal(size=(2, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    jcfg = jm.cfg
    want = _jitr(lambda p, a, f: j_layers.cross_attention(jcfg, p, a, f))(
        jax.tree.map(lambda a: a[0], jp["cross"]["xattn"]), x, feats)
    got = t_layers.cross_attention(cfg, tp["cross"][0]["xattn"], torch.from_numpy(x),
                                   torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_jax(audio):
    cfg, jm, jp, tm, tp, tree = audio
    jb, tb = _batch(cfg, 2, 24, seed=5)
    want = _jitr(lambda p, b: jm.logits(p, b))(jp, jb)
    got = tm.logits(tp, tb)
    assert got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_masked_frames_take_the_mask_embedding(audio):
    cfg, jm, jp, tm, tp, tree = audio
    from repro.models import encoder as j_encoder
    from repro_torch.models import encoder as t_encoder

    jb, tb = _batch(cfg, 2, 16, seed=7)
    mask = (np.random.default_rng(8).uniform(size=(2, 16)) < 0.3).astype(np.float32)
    want = _jitr(lambda p, f, m: j_encoder.hidden_states(jm.cfg, p, f, m))(
        jp, jb["frames"], mask)
    got = t_encoder.hidden_states(cfg, tp, tb["frames"], torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_encoder_has_no_decode(audio):
    assert not audio[3].has_decode


# ---------------------------------------------------------------------------
# blockwise attention and the CPU switch above 8192 tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax_with_small_blocks(causal):
    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 256, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 384, 2, 16)).astype(np.float32) for _ in range(2))
    want = _jitr(lambda a, b, c: j_layers.blockwise_attention(
        a, b, c, causal=causal, q_block=128, kv_block=128))(q, k, v)
    got = t_layers.blockwise_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal,
                                       q_block=128, kv_block=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,target", [(40, 16), (256, 128), (1601, 1024), (8192, 1024),
                                      (10000, 1024), (16411, 1024)])
def test_pick_block_equals_jax(n, target):
    assert t_layers._pick_block(n, target) == j_layers._pick_block(n, target)


def test_cpu_switches_to_blockwise_above_8192_tokens(monkeypatch):
    """At JAX's threshold the plain path still runs, one token above it the
    blockwise form; an injected attention runs at every length."""
    assert t_layers._BLOCKWISE_THRESHOLD == j_layers._BLOCKWISE_THRESHOLD == 8192
    calls = []
    monkeypatch.setattr(t_layers, "blockwise_attention",
                        lambda q, k, v, **kw: calls.append("blockwise") or q)
    monkeypatch.setattr(t_layers.flash_ops, "attention",
                        lambda q, k, v, **kw: calls.append("plain") or q)
    for s in (8192, 8193):
        q = torch.zeros((1, s, 1, 8))
        t_layers._local_attention(q, q, q, causal=True, ctx=t_layers.LOCAL)
        t_layers._local_attention(q, q, q, causal=True, ctx=t_layers.LOCAL,
                                  attention=lambda *a, **kw: calls.append("injected") or q)
    assert calls == ["plain", "injected", "blockwise", "injected"]
