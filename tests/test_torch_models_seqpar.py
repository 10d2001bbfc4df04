"""Sequence-parallel and ring-TP model paths of the port against the JAX
package's, on the CPU.

Reduced llama3-8b (2 layers, width 64, GQA 4/2 heads) and reduced
rwkv6-1.6b (2 layers, width 64, heads of 16), in f32, with parameters
carried over by ``repro_torch.models.convert``, drawn with numpy at the
JAX init's statistics so that nothing compiles for them
(``test_torch_models_hybrid.random_tree`` for the dense model,
``test_torch_models_rwkv.random_rwkv_tree`` for RWKV, its decay LoRA
nonzero).  Both packages run under the same context
on a ``(1, 4)`` mesh over ``("data", "model")``: JAX's ``shard_map`` on 4
virtual CPU devices (jitted), the port's ``VirtualMesh`` of 4 stacked
ranks.  Cells: the dense logits with ``seq_parallel`` (ring attention,
``n_parts`` 1 and 2, packers ``slice`` and ``cuda``, coalesced or not),
with ``tp_mode="ring"`` (the ring collective-matmul MLP), the bucketed
dense prefill under ``seq_parallel``; the RWKV logits with
``seq_parallel`` and ``state_method`` ``ring`` and ``tree``
(``wkv_segment_operator`` and ``state_passing``).

The RWKV quirk is pinned as JAX has it: the sequence-parallel time mix
returns no final state (``S_fin = None``), and prefill calls the time mix
without the context, so a sequence-parallel RWKV prefill is the local one.
The serving engine runs the dense ring prefill, with the same tokens as
without the context, and refuses a bucket the ring does not divide with
``ValueError``, as the JAX engine does.

Tolerances, stated: f32 ``rtol=atol=1e-4``, the port's model tolerance
against JAX (``tests/test_torch_models.py``): the ring's online softmax and
the ring matmuls sum in another order than XLA, a few f32 ulps.  The
``cuda`` test holds ``wkv_segment_operator`` on the card (the
``wkv_chunked`` kernel) against the plain version at the kernel's f32
tolerance, ``3e-4``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import compat as j_compat
from repro.models import build_model as j_build_model
from repro.models import rwkv as j_rwkv
from repro.parallel.context import ParallelContext as JCtx
from repro.serving.engine import ServingEngine as JEngine
from test_torch_models_hybrid import random_tree
from test_torch_models_rwkv import random_rwkv_tree
from repro_torch.configs import get_config
from repro_torch.core.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving.engine import ServingEngine

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)


TOL = dict(rtol=1e-4, atol=1e-4)
RING = 4
F32 = dict(dtype="float32", param_dtype="float32")


def _contexts(**kw):
    """The same context in both packages; skips where JAX has fewer than
    ``RING`` devices (the conftest makes 8 virtual CPU devices)."""
    if len(jax.devices()) < RING:
        pytest.skip(f"needs {RING} virtual devices (conftest)")
    jmesh = j_compat.make_mesh((1, RING), ("data", "model"), devices=jax.devices()[:RING])
    tmesh = make_mesh((1, RING), ("data", "model"), device="cpu")
    jkw = {k: v for k, v in kw.items() if k != "comm_packer"}  # the port's kernel packer
    return JCtx(mesh=jmesh, **jkw), ParallelContext(mesh=tmesh, **kw)


def _models(name: str, seed: int):
    cfg = get_config(name).reduced().with_updates(**F32)
    jcfg = j_get_config(name).reduced().with_updates(**F32)
    jm = j_build_model(jcfg)
    tree = random_rwkv_tree(jcfg, seed) if cfg.family == "rwkv" else random_tree(jm.init, seed)
    tm = build_model(cfg, "cpu")
    return cfg, jm, jax.tree.map(jnp.asarray, tree), tm, params_from_jax(cfg, tree, "cpu")


@pytest.fixture(scope="module")
def dense():
    return _models("llama3-8b", 0)


@pytest.fixture(scope="module")
def rwkv():
    return _models("rwkv6-1.6b", 1)


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _logits_both(models, tokens, **ctx_kw):
    cfg, jm, jp, tm, tp = models
    jctx, tctx = _contexts(**ctx_kw)
    want = _jitr(lambda p, t: jm.logits(p, {"tokens": t}, ctx=jctx))(jp, jnp.asarray(tokens))
    got = tm.logits(tp, {"tokens": torch.from_numpy(tokens).long()}, ctx=tctx)
    return got, np.asarray(want)


DENSE_CELLS = {
    "seq-ring": dict(seq_parallel=True),
    "seq-ring-p2-cuda-uncoalesced": dict(seq_parallel=True, n_parts=2, comm_packer="cuda",
                                         comm_coalesce=False),
    "tp-ring": dict(tp_mode="ring"),
}


@pytest.mark.parametrize("cell", sorted(DENSE_CELLS))
def test_dense_logits_match_jax_under_the_same_context(dense, cell):
    got, want = _logits_both(dense, _tokens(dense[0]), **DENSE_CELLS[cell])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cell", sorted(DENSE_CELLS))
def test_dense_context_matches_local_logits(dense, cell):
    """The same model without the context: ring and local agree."""
    cfg, _, _, tm, tp = dense
    toks = torch.from_numpy(_tokens(cfg, seed=1)).long()
    _, tctx = _contexts(**DENSE_CELLS[cell])
    torch.testing.assert_close(tm.logits(tp, {"tokens": toks}, ctx=tctx),
                               tm.logits(tp, {"tokens": toks}), **TOL)


def test_dense_bucketed_prefill_matches_jax(dense):
    cfg, jm, jp, tm, tp = dense
    jctx, tctx = _contexts(seq_parallel=True, n_parts=3)
    toks = _tokens(cfg, b=1, s=16, seed=2)
    true_len = np.array([11], np.int32)
    want, wcache = _jitr(lambda p, t, c, n: jm.prefill(p, {"tokens": t}, c, ctx=jctx,
                                                         true_len=n))(
        jp, jnp.asarray(toks), jm.init_cache(1, 32), jnp.asarray(true_len))
    got, gcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tm.init_cache(1, 32),
                             ctx=tctx, true_len=torch.from_numpy(true_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gcache["k"].numpy(), np.asarray(wcache["k"]), **TOL)
    assert gcache["pos"].tolist() == [11]


@pytest.mark.parametrize("method", ["ring", "tree"])
def test_rwkv_logits_match_jax_under_the_same_context(rwkv, method):
    got, want = _logits_both(rwkv, _tokens(rwkv[0], seed=3), seq_parallel=True,
                             state_method=method)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rwkv_sequence_parallel_matches_local_logits(rwkv):
    cfg, _, _, tm, tp = rwkv
    toks = torch.from_numpy(_tokens(cfg, seed=4)).long()
    _, tctx = _contexts(seq_parallel=True, state_method="tree")
    torch.testing.assert_close(tm.logits(tp, {"tokens": toks}, ctx=tctx),
                               tm.logits(tp, {"tokens": toks}), **TOL)


def test_wkv_segment_operator_matches_jax():
    rng = np.random.default_rng(5)
    k, v = (rng.normal(size=(2, 8, 2, 16)).astype(np.float32) for _ in range(2))
    lw = -np.exp(rng.uniform(-3, 0.5, size=(2, 8, 2, 16))).astype(np.float32)
    want_c, want_d = j_rwkv.wkv_segment_operator(*(jnp.asarray(t) for t in (k, v, lw)), chunk=4)
    got_c, got_d = t_rwkv.wkv_segment_operator(*(torch.from_numpy(t) for t in (k, v, lw)),
                                               chunk=4)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)


def test_rwkv_quirk_sequence_parallel_time_mix_returns_no_state(rwkv):
    """JAX's sequence-parallel branch sets ``S_fin = None``; so does the
    port's (the token-shift carry is still returned)."""
    cfg, jm, jp, tm, tp = rwkv
    jctx, tctx = _contexts(seq_parallel=True)
    x = np.random.default_rng(6).normal(size=(1, 8, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    jout = _jitr(lambda lp, h: j_rwkv.time_mix(jm.cfg, lp, h, ctx=jctx, return_state=True))(
        jlp, jnp.asarray(x))
    tout = t_rwkv.time_mix(cfg, tp["layers"][0], torch.from_numpy(x), ctx=tctx,
                           return_state=True)
    assert jout[2] is None and tout[2] is None
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), **TOL)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))


def test_rwkv_quirk_sequence_parallel_prefill_is_the_local_prefill(rwkv):
    """JAX's RWKV prefill calls the time mix without the context, so a
    sequence-parallel prefill scans locally and keeps its final states; the
    port does the same, and both agree."""
    cfg, jm, jp, tm, tp = rwkv
    jctx, tctx = _contexts(seq_parallel=True)
    toks = _tokens(cfg, b=1, s=16, seed=7)
    jseq = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 16), ctx=jctx)
    jloc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_cache(1, 16))
    tt = {"tokens": torch.from_numpy(toks).long()}
    tseq = tm.prefill(tp, tt, tm.init_cache(1, 16), ctx=tctx)
    tloc = tm.prefill(tp, tt, tm.init_cache(1, 16))
    for a, b in zip(jax.tree.leaves(jseq), jax.tree.leaves(jloc)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert torch.equal(tseq[0], tloc[0])
    for name in tloc[1]:
        assert torch.equal(tseq[1][name], tloc[1][name]), name
    np.testing.assert_allclose(tseq[0].numpy(), np.asarray(jseq[0]), **TOL)
    np.testing.assert_allclose(tseq[1]["wkv"].numpy(), np.asarray(jseq[1]["wkv"]), **TOL)


def test_engine_ring_prefill_serves_the_local_tokens(dense):
    """A dense engine under a sequence-parallel context (every prompt in a
    ring-divisible bucket) gives the tokens of the engine without it."""
    cfg, _, _, tm, tp = dense
    _, tctx = _contexts(seq_parallel=True, n_parts=2)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 9, 16, 30)]

    def serve(ctx):
        engine = ServingEngine(tm, tp, max_slots=2, max_len=64, **ctx)
        uids = [engine.submit(p, max_new_tokens=4) for p in prompts]
        out = engine.run()
        return [out[u] for u in uids], engine.stats

    ring_tokens, stats = serve({"ctx": tctx})
    local_tokens, _ = serve({})
    assert ring_tokens == local_tokens
    assert stats.prefills == len(prompts) and stats.plan_inits == 3 + 1  # buckets 8, 16, 32


def test_engine_refuses_a_bucket_the_ring_does_not_divide(dense):
    """max_len 18 clips a 17-token prompt's bucket to 18, which 4 ranks do
    not divide: both engines raise ValueError at its prefill."""
    cfg, jm, jp, tm, tp = dense
    jctx, tctx = _contexts(seq_parallel=True)
    prompt = list(range(17))
    jeng = JEngine(jm, jp, max_slots=1, max_len=18, ctx=jctx)
    jeng.submit(prompt, max_new_tokens=2)
    with pytest.raises(ValueError):
        jeng.run()
    teng = ServingEngine(tm, tp, max_slots=1, max_len=18, ctx=tctx)
    teng.submit(prompt, max_new_tokens=2)
    with pytest.raises(ValueError, match="not evenly divisible"):
        teng.run()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk", [(64, 16), (256, 64)])
def test_wkv_segment_operator_kernel_matches_plain_on_the_card(cuda, T, chunk):
    """``wkv_segment_operator`` through ``wkv_chunked`` (r = 0, u = 0, no
    starting state) against the plain WKV, 8 ranks folded into the batch."""
    from repro_torch.kernels.wkv import wkv_plain

    g = torch.Generator(cuda).manual_seed(9)
    k, v = (torch.randn((8, T, 4, 64), generator=g, device=cuda) for _ in range(2))
    lw = -torch.exp(torch.rand((8, T, 4, 64), generator=g, device=cuda) * 3.5 - 3.0)
    got_c, got_d = t_rwkv.wkv_segment_operator(k, v, lw, chunk=chunk)
    want_c, want_d = t_rwkv.wkv_segment_operator(k, v, lw, chunk=chunk, wkv=wkv_plain)
    torch.testing.assert_close(got_c, want_c, rtol=3e-4, atol=3e-4)
    assert torch.equal(got_d, want_d)
