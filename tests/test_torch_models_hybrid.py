"""The zamba2 hybrid of the port against the JAX package, on the CPU:
``seq_left_halo``, the SSD scan, the causal conv, the mamba block (local
and sequence-parallel) and the hybrid model.

Reduced zamba2-1.2b in f32 (width 64, 4 ssm heads of 32, state 16, conv
kernel 4, attention every 2 layers) at 5 layers, so that the model has two
groups and a tail layer.  Parameters are drawn with numpy in the shapes of
``jax.eval_shape(init)`` (no JAX init compiles) at the statistics of JAX's
init, the leaves JAX starts at a constant (conv biases, skips, dt biases)
moved off it (:func:`random_tree`), and carried over by
``repro_torch.models.convert``.  (With O(1) normal values in those leaves
the model's SSD states reach 25, and JAX's f32 states then sit 3.4e-4 from
a float64 run of the port where the port's f32 states sit 4e-5: the
tolerance would measure JAX's rounding, not the port.)
Every JAX call is jitted (eager ``shard_map`` costs seconds a call).  The
sequence-parallel cells run both packages under the same context on a
``(1, 4)`` mesh over ``("data", "model")``: JAX's ``shard_map`` on 4
virtual CPU devices, the port's ``VirtualMesh`` of 4 stacked ranks.

JAX's quirks, pinned as JAX has them: its ``ssd_scan`` asserts ``T %
min(32, T) == 0`` (the port raises ``ValueError`` for exactly those
lengths), and its hybrid ``prefill`` runs the mamba layers without the
context (local scans), so a sequence-parallel prefill differs from the
local one only by the shared attention's ring.

Tolerances, stated: ``seq_left_halo`` bitwise (it moves data; the ``bf16``
wire rounds the same way in both); the SSD scan, the conv and one mamba
block ``rtol=atol=1e-5`` (f32; the port computes every chunk at once and
the state entering each chunk as a decay-weighted sum, JAX scans the
chunks, so sums run in other orders: a few ulps); the model's logits and
caches ``rtol=atol=1e-4``, the port's model tolerance against JAX
(``tests/test_torch_models.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.core import compat as j_compat
from repro.core import halo as j_halo
from repro.models import build_model as j_build_model
from repro.models import ssm as j_ssm
from repro.parallel.context import ParallelContext as JCtx
from repro_torch.core.halo import seq_left_halo
from repro_torch.core.mesh import make_mesh
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.parallel.context import ParallelContext

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

NAME = "zamba2-1.2b"
F32 = dict(dtype="float32", param_dtype="float32", n_layers=5)
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
RING = 4


def _cfgs(**upd):
    upd = {**F32, **upd}
    return (get_config(NAME).reduced().with_updates(**upd),
            j_get_config(NAME).reduced().with_updates(**upd))


def random_tree(init, seed: int) -> dict:
    """A parameter tree of the structure and shapes a JAX ``init(key)``
    gives (by ``eval_shape``), drawn with numpy at the statistics of JAX's
    init (norm scales one, norm biases zero, matrices normal over the root
    of their fan-in, embeddings and ``mask_emb`` normal times 0.02,
    ``conv_w`` normal times 0.2, ``A_log`` the log of a rate in [1, 8]),
    with the leaves JAX starts at a constant moved off it by 0.1 normal:
    ``D`` (one), ``dt_bias``, ``conv_b`` and the VLM's gates (zero), the
    q/k norm scales (one)."""
    rng = np.random.default_rng(seed)
    moved = {"D": 1.0, "dt_bias": 0.0, "conv_b": 0.0, "gate_attn": 0.0, "gate_ffn": 0.0,
             "q_norm": 1.0, "k_norm": 1.0}

    def leaf(path, a):
        name = jax.tree_util.keystr(path[-1:])[2:-2]
        if name == "scale":
            return np.ones(a.shape, np.float32)
        if name == "bias":
            return np.zeros(a.shape, np.float32)
        if name == "A_log":
            return np.log(rng.uniform(1.0, 8.0, size=a.shape)).astype(np.float32)
        if name in moved:
            return (moved[name] + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name in ("embed", "lm_head", "mask_emb"):
            scale = 0.02
        elif name == "conv_w":
            scale = 0.2
        else:  # an (in, out) matrix, stacked or not
            scale = 1 / np.sqrt(a.shape[-2])
        return (scale * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.key(0)))


def jax_devices(n: int) -> list:
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices (conftest)")
    return jax.devices()[:n]


def contexts(**kw):
    """The same context in both packages on a ``(1, RING)`` mesh."""
    jmesh = j_compat.make_mesh((1, RING), ("data", "model"), devices=jax_devices(RING))
    tmesh = make_mesh((1, RING), ("data", "model"), device="cpu")
    return JCtx(mesh=jmesh, **kw), ParallelContext(mesh=tmesh, **kw)


@pytest.fixture(scope="module")
def hybrid():
    cfg, jcfg = _cfgs()
    jm = j_build_model(jcfg)
    tree = random_tree(jm.init, seed=0)
    return cfg, jm, jax.tree.map(jnp.asarray, tree), build_model(cfg, "cpu"), \
        params_from_jax(cfg, tree, "cpu"), tree


# ---------------------------------------------------------------------------
# seq_left_halo
# ---------------------------------------------------------------------------

HALO_WIDTH = 3
HALO_CELLS = [(n, p) for n in (1, 3) for p in ("slice", "cuda", "bf16")]
#: the JAX packer each port packer is held against (``cuda`` is the
#: port's kernel packer, its plain version on the CPU: data movement only)
JAX_PACKER = {"slice": "slice", "cuda": "slice", "bf16": "bf16"}


@pytest.fixture(scope="module")
def jax_halos():
    x = np.random.default_rng(3).normal(size=(5, RING * 6, 7)).astype(np.float32)
    mesh = j_compat.make_mesh((RING,), ("model",), devices=jax_devices(RING))
    spec = P(None, "model", None)

    def inner(xl):
        return {f"{n}-{p}": j_halo.seq_left_halo(xl, "model", HALO_WIDTH, seq_axis=1,
                                                  n_parts=n, packer=p)
                for n in (1, 3) for p in ("slice", "bf16")}

    out = _jitr(j_compat.shard_map(inner, mesh=mesh, in_specs=spec, out_specs=spec))(
        jnp.asarray(x))
    return x, {k: np.asarray(v) for k, v in out.items()}


def _stacked(x: np.ndarray) -> torch.Tensor:
    """(B, R*L, ...) -> the (R, B, L, ...) stacked ranks of a 1-D ring."""
    b, t = x.shape[:2]
    return torch.from_numpy(x.reshape(b, RING, t // RING, *x.shape[2:])).transpose(0, 1)


def _global(y: torch.Tensor) -> np.ndarray:
    return y.transpose(0, 1).reshape(y.shape[1], -1, *y.shape[3:]).numpy()


@pytest.mark.parametrize("n_parts,packer", HALO_CELLS)
def test_seq_left_halo_bitwise_equals_jax(jax_halos, n_parts, packer):
    x, want = jax_halos
    mesh = make_mesh((RING,), ("model",), device="cpu")
    got = seq_left_halo(_stacked(x), mesh, "model", HALO_WIDTH, n_parts=n_parts, packer=packer)
    assert got.shape == (RING, 5, 6 + HALO_WIDTH, 7)
    np.testing.assert_array_equal(_global(got), want[f"{n_parts}-{JAX_PACKER[packer]}"])
    assert not got[0, :, :HALO_WIDTH].any()  # rank 0: zeros


def test_seq_left_halo_refuses_a_mesh_over_processes():
    mesh = make_mesh((1, RING), ("data", "model"), device="cpu", processes=2)
    with pytest.raises(NotImplementedError, match="item 17"):
        seq_left_halo(torch.zeros((RING, 1, 4, 2)), mesh, "model", HALO_WIDTH)


# ---------------------------------------------------------------------------
# the SSD scan and the causal conv
# ---------------------------------------------------------------------------


def _ssd_inputs(T: int, seed: int, bsz: int = 2, nh: int = 4, hd: int = 8, ns: int = 16):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(bsz, T, nh, hd)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(bsz, T, ns)).astype(np.float32) for _ in range(2))
    dt = np.log1p(np.exp(rng.normal(size=(bsz, T, nh)))).astype(np.float32)
    la = (-dt * rng.uniform(0.05, 0.5, size=nh)).astype(np.float32)  # slow decays carry far
    h0 = rng.normal(size=(bsz, nh, hd, ns)).astype(np.float32)
    return xh, Bm, Cm, dt, la, h0


@pytest.mark.parametrize("T,with_state", [(96, True), (96, False), (20, True), (1, True)])
def test_ssd_scan_matches_jax(T, with_state):
    xh, Bm, Cm, dt, la, h0 = _ssd_inputs(T, seed=T)
    h0 = h0 if with_state else None
    want_y, want_h = _jitr(j_ssm.ssd_scan)(xh, Bm, Cm, dt, la, h0)
    got_y, got_h = t_ssm.ssd_scan(*(torch.from_numpy(a) for a in (xh, Bm, Cm, dt, la)),
                                  None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def test_ssd_scan_refuses_the_lengths_jax_rejects():
    args = _ssd_inputs(40, seed=1)[:5]
    with pytest.raises(AssertionError):
        j_ssm.ssd_scan(*args)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_ssm.ssd_scan(*(torch.from_numpy(a) for a in args))


@pytest.mark.parametrize("with_left", [False, True])
def test_causal_conv_matches_jax(with_left):
    cfg, jcfg = _cfgs()
    ch = t_ssm.conv_channels(cfg)
    rng = np.random.default_rng(5)
    lp = {"conv_w": rng.normal(size=(cfg.conv_kernel, ch)).astype(np.float32),
          "conv_b": rng.normal(size=(ch,)).astype(np.float32)}
    x = rng.normal(size=(2, 10, ch)).astype(np.float32)
    left = rng.normal(size=(2, cfg.conv_kernel - 1, ch)).astype(np.float32) if with_left else None
    want = _jitr(lambda p, a, b: j_ssm.causal_conv(jcfg, p, a, b))(lp, x, left)
    got = t_ssm.causal_conv(cfg, {k: torch.from_numpy(v) for k, v in lp.items()},
                            torch.from_numpy(x), None if left is None else torch.from_numpy(left))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the mamba block, local and sequence-parallel
# ---------------------------------------------------------------------------

BLOCK_CELLS = {"local": None, "seq-ring": dict(seq_parallel=True, state_method="ring"),
               "seq-tree-p3": dict(seq_parallel=True, state_method="tree", n_parts=3)}


@pytest.fixture(scope="module")
def jax_blocks(hybrid):
    cfg, jm, jp, tm, tp, tree = hybrid
    x = np.random.default_rng(7).normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0, 1], jp["groups"])
    jcfg = jm.cfg
    out = {}
    for name, kw in BLOCK_CELLS.items():
        jctx = JCtx() if kw is None else contexts(**kw)[0]
        out[name] = np.asarray(_jitr(
            lambda p, a, c=jctx: j_ssm.mamba_block(jcfg, p, a, ctx=c))(lp, x))
    return x, out


@pytest.mark.parametrize("cell", sorted(BLOCK_CELLS))
def test_mamba_block_matches_jax_under_the_same_context(hybrid, jax_blocks, cell):
    cfg, jm, jp, tm, tp, tree = hybrid
    x, want = jax_blocks
    kw = BLOCK_CELLS[cell]
    ctx = ParallelContext() if kw is None else contexts(**kw)[1]
    got = t_ssm.mamba_block(cfg, tp["groups"][0][1], torch.from_numpy(x), ctx=ctx)
    np.testing.assert_allclose(got.numpy(), want[cell], **TOL)


def test_sequence_parallel_block_needs_the_ghost_cells_and_the_state(hybrid, jax_blocks):
    """The local block against the sequence-parallel one: equal within the
    tolerance, and both a zeroed halo and a dropped incoming state move it
    far outside, so the cells above see both."""
    cfg, jm, jp, tm, tp, tree = hybrid
    x, want = jax_blocks
    lp = tp["groups"][0][1]
    ctx = contexts(seq_parallel=True)[1]
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(t_ssm.mamba_block(cfg, lp, xt, ctx=ctx).numpy(), want["local"],
                               **TOL)
    import repro_torch.models.ssm as mod

    def no_halo(xs, mesh, axis, width, **kw):
        return torch.cat([torch.zeros_like(xs[:, :, :width]), xs], dim=2)

    def no_state(C, D, mesh, axis, **kw):
        return torch.zeros_like(C)

    for fault, name in ((no_halo, "seq_left_halo"), (no_state, "state_passing")):
        orig = getattr(mod, name)
        setattr(mod, name, fault)
        try:
            bad = t_ssm.mamba_block(cfg, lp, xt, ctx=ctx).numpy()
        finally:
            setattr(mod, name, orig)
        assert np.abs(bad - want["local"]).max() > 1e-3, name


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_layout_and_params_round_trip(hybrid):
    cfg, jm, jp, tm, tp, tree = hybrid
    assert len(tp["groups"]) == 2 and len(tp["groups"][0]) == 2 and len(tp["tail"]) == 1
    lp = tp["groups"][1][0]
    np.testing.assert_array_equal(lp["in_proj"].numpy(), tree["groups"]["in_proj"][1, 0].T)
    np.testing.assert_array_equal(lp["conv_w"].numpy(), tree["groups"]["conv_w"][1, 0])
    np.testing.assert_array_equal(tp["shared"]["pre_proj"].numpy(), tree["shared"]["pre_proj"].T)
    back = params_to_numpy(cfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_logits_match_jax(hybrid):
    cfg, jm, jp, tm, tp, tree = hybrid
    tokens = _tokens(cfg, 2, 64, seed=1)
    want = _jitr(lambda p, t: jm.logits(p, {"tokens": t}))(jp, tokens)
    got = tm.logits(tp, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_prefill_then_decode_match_jax(hybrid):
    """A prompt of two SSD chunks, then three decode steps (prompts within
    one chunk: ``tests/test_torch_serving_families.py``)."""
    cfg, jm, jp, tm, tp, tree = hybrid
    s = 64
    tokens = _tokens(cfg, 2, s, seed=s)
    steps = _tokens(cfg, 2, 3, seed=s + 1)
    jprefill = _jitr(lambda p, t, c: jm.prefill(p, {"tokens": t}, c))
    jdecode = _jitr(jm.decode_step)
    want, jcache = jprefill(jp, tokens, jm.init_cache(2, 96))
    got, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()}, tm.init_cache(2, 96))
    for i in range(steps.shape[1] + 1):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        for key in jcache:
            np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]),
                                       err_msg=key, **MODEL_TOL)
        if i < steps.shape[1]:
            want, jcache = jdecode(jp, steps[:, i:i + 1], jcache)
            got, cache = tm.decode_step(tp, torch.from_numpy(steps[:, i:i + 1]).long(), cache)


def test_sequence_parallel_logits_and_prefill_match_jax(hybrid):
    """Under ``seq_parallel`` (ring ``n_parts`` 2, tree state passing):
    ``logits`` runs the conv halo, the state passing and ring attention,
    ``prefill`` only the ring attention (its mamba layers scan locally and
    keep their states), in both packages."""
    cfg, jm, jp, tm, tp, tree = hybrid
    jctx, ctx = contexts(seq_parallel=True, state_method="tree", n_parts=2)
    tokens = _tokens(cfg, 2, 64, seed=9)

    def both(p, t, c):
        return jm.logits(p, {"tokens": t}, ctx=jctx), jm.prefill(p, {"tokens": t}, c, ctx=jctx)

    want_logits, (want_last, jcache) = _jitr(both)(jp, tokens, jm.init_cache(2, 64))
    tt = torch.from_numpy(tokens).long()
    np.testing.assert_allclose(tm.logits(tp, {"tokens": tt}, ctx=ctx).numpy(),
                               np.asarray(want_logits), **MODEL_TOL)
    last, cache = tm.prefill(tp, {"tokens": tt}, tm.init_cache(2, 64), ctx=ctx)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), **MODEL_TOL)
    for key in ("g_ssd", "t_ssd", "g_conv", "shared_k"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(jcache[key]), err_msg=key,
                                   **MODEL_TOL)
    # the first group's mamba layers ran locally, on the embeddings
    _, local_cache = tm.prefill(tp, {"tokens": tt}, tm.init_cache(2, 64))
    assert torch.equal(cache["g_ssd"][0], local_cache["g_ssd"][0])
