"""MoE decoder of the port against the JAX package, on the CPU.

Reduced phi3.5-moe (4 experts top-2, width 64, 2 layers) and a grok-style
hidden split (2 experts top-1 stored as 4 slots of half width, geglu), in
f32, with the JAX package's parameters carried over by
``repro_torch.models.convert``.  The routing functions, the capacity path
with and without drops, the dropless decode path, ``moe_seq_chunk``, the
model's ``logits``/``prefill``/``decode_step``, and the expert-parallel layer
on a ``(2, 4)`` mesh over ``("data", "model")``: JAX's ``shard_map`` on 8
virtual CPU devices (jitted, compiled once a cell), the port's
``VirtualMesh`` of 8 stacked ranks, ``moe_comm`` ``native`` and
``messages`` at ``n_parts`` 1 and 2, with drops (``capacity_factor``
1.25), and grok-style with the grouped psum.

Routes are compared first and exactly (experts, ranks, keep mask): one ulp
in a router logit can flip an expert and move an output by O(1), so the
inputs are checked to have a top-k margin far above f32 rounding before the
values are compared.

Tolerances, stated: layer outputs ``rtol=atol=1e-5`` (f32, width 64: XLA
and PyTorch sum the products in other orders, a few ulps; seen 1e-6),
logits ``rtol=atol=1e-4`` (two layers, the dense model's tolerance in
``tests/test_torch_models.py``), the aux loss ``rtol=1e-6``.  The port's EP
variants (comm, packer, coalescing) are held bitwise among themselves at
equal ``n_parts``: the exchange moves data only.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.core import compat as j_compat
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.parallel.context import ParallelContext as JCtx
from repro_torch.configs import get_config
from repro_torch.core.mesh import make_mesh
from repro_torch.core.partitioned import partitioned_psum
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.parallel.context import ParallelContext

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

PHI = "phi3.5-moe-42b-a6.6b"
GROK = "grok-1-314b"
F32 = dict(dtype="float32", param_dtype="float32")
#: the grok-style hidden split at the reduced size (tests/models/test_moe.py's)
GROK_SPLIT = dict(n_experts=2, top_k=1, ep_slots=4, d_ff=64)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
#: smallest gap between the k-th and (k+1)-th routing probability a test's
#: tokens must have (f32 rounding moves a probability by about 1e-7)
MIN_MARGIN = 1e-5
MESH = (2, 4)


def _cfgs(name: str, **upd):
    upd = {**F32, **(GROK_SPLIT if name == GROK else {}), **upd}
    return get_config(name).reduced().with_updates(**upd), j_get_config(name).reduced().with_updates(**upd)


@pytest.fixture(scope="module", params=[PHI, GROK])
def ffn(request):
    """(port cfg, JAX cfg, numpy FFN params of layer 0) for one layout."""
    cfg, jcfg = _cfgs(request.param)
    p = _random_tree(lambda k: j_moe.moe_ffn_params(jcfg, k), seed=0)
    return cfg, jcfg, p


def _jit(fn, *args):
    """``fn(*args)`` compiled once (eager JAX compiles every op)."""
    return _jitr(fn)(*args)


def _random_tree(init, seed: int) -> dict:
    """A parameter tree of the structure and shapes a JAX ``init(key)``
    gives (by ``eval_shape``, nothing compiled), normal values scaled by the fan-in
    (numpy, seeded); norms at one."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path[-1:])
        if "scale" in name:
            return np.ones(a.shape, np.float32)
        if "bias" in name:
            return np.zeros(a.shape, np.float32)
        fan_in = a.shape[-2] if len(a.shape) >= 3 else 50.0
        return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.key(0)))


def _torch(p: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).normal(size=(*shape, cfg.d_model)).astype(np.float32)


def _assert_margin(cfg, p, x2d):
    logits = x2d.astype(np.float64) @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    top = np.sort(probs / probs.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    assert (top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min() > MIN_MARGIN


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", [PHI, GROK])
def test_config_field_equal_to_jax(name, reduced):
    mine, theirs = get_config(name), j_get_config(name)
    if reduced:
        mine, theirs = mine.reduced(), theirs.reduced()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()


@pytest.mark.parametrize("name", [PHI, GROK])
def test_params_round_trip_and_layout(name):
    """The JAX tree carries over and back exactly; the MoE leaves keep the
    JAX layout (slots first, ``(in, out)``), attention is transposed."""
    cfg, jcfg = _cfgs(name)
    tree = _random_tree(j_build_model(jcfg).init, seed=1)
    params = params_from_jax(cfg, tree, "cpu")
    lp = params["layers"][1]
    fs = cfg.d_ff // (t_moe._slots(cfg) // cfg.n_experts)
    assert lp["moe"]["router"].shape == (cfg.d_model, cfg.n_experts)
    assert lp["moe"]["w_up"].shape == (t_moe._slots(cfg), cfg.d_model, fs)
    assert lp["moe"]["w_down"].shape == (t_moe._slots(cfg), fs, cfg.d_model)
    np.testing.assert_array_equal(lp["moe"]["w_gate"].numpy(), tree["layers"]["moe"]["w_gate"][1])
    np.testing.assert_array_equal(lp["attn"]["wq"].numpy(), tree["layers"]["attn"]["wq"][1].T)
    back = params_to_numpy(cfg, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    # the port's own init has the same shapes
    mine = t_moe.init(cfg, torch.Generator().manual_seed(0))
    jax.tree.map(lambda a, b: np.testing.assert_equal(a.shape, b.shape),
                 params_to_numpy(cfg, mine), tree)


def test_build_model_takes_the_moe_configs():
    for name in (PHI, GROK):
        model = build_model(get_config(name), "cpu")
        assert model.module is t_moe
        cache = model.init_cache(2, 16, device="meta")
        cfg = model.cfg
        assert cache["k"].shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# routing and the local paths
# ---------------------------------------------------------------------------


def test_route_and_dispatch_match_jax(ffn):
    cfg, jcfg, p = ffn
    x = _x(cfg, (48,), seed=2)
    _assert_margin(cfg, p, x)
    wj, idxj, auxj = _jit(lambda r, xx: j_moe._route(jcfg, r, xx), p["router"], x)
    w, idx, aux = t_moe._route(cfg, torch.from_numpy(np.array(p["router"])), torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idxj))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-6)
    for capacity in (3, 48):  # drops, none
        want = _jit(lambda i, c=capacity: j_moe._dispatch_indices(jcfg, i, 48, c), idxj)
        got = t_moe._dispatch_indices(cfg, idx, 48, capacity)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_top_k_ties_pick_the_lower_expert_first_as_jax(top_k):
    """Planted equal probabilities: each token's router logits are a row of
    ``rows`` (exactly representable), so ties are exact; the port picks the
    same experts in the same order as ``jax.lax.top_k``."""
    cfg, jcfg = _cfgs(PHI, top_k=top_k)
    rows = np.array([[0, 0, 0, 0], [1, 3, 3, 2], [2, 2, 1, 2], [5, 1, 5, 5], [0, 4, 4, 4],
                     [-1, -1, 2, -1]], np.float32)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:len(rows)] = rows
    x = np.eye(len(rows), cfg.d_model, dtype=np.float32)
    _, idxj, _ = _jit(lambda r, xx: j_moe._route(jcfg, r, xx), router, x)
    _, idx, _ = t_moe._route(cfg, torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idxj))
    assert idx[0].tolist() == list(range(top_k))


@pytest.mark.parametrize("capacity_factor", [16.0, 0.5], ids=["no-drops", "drops"])
def test_moe_dense_matches_jax(ffn, capacity_factor):
    cfg, jcfg, p = ffn
    cfg, jcfg = (c.with_updates(capacity_factor=capacity_factor) for c in (cfg, jcfg))
    x = _x(cfg, (40,), seed=3)
    _assert_margin(cfg, p, x)
    yj, auxj = _jit(lambda pp, xx: j_moe._moe_dense(jcfg, pp, xx), p, x)
    y, aux = t_moe._moe_dense(cfg, _torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-6)
    dropped = (np.abs(np.asarray(yj)).sum(-1) == 0).sum()
    if capacity_factor < 1:  # top-1 grok drops whole tokens, phi only choices
        idx = t_moe._route(cfg, torch.from_numpy(np.array(p["router"])), torch.from_numpy(x))[1].numpy()
        cap = t_moe._capacity(cfg, 40)
        assert (np.bincount(idx.ravel(), minlength=cfg.n_experts) > cap).any()
        assert dropped > 0 or cfg.top_k > 1


def test_moe_dropless_matches_jax(ffn):
    cfg, jcfg, p = ffn
    x = _x(cfg, (6,), seed=4)
    _assert_margin(cfg, p, x)
    yj, auxj = _jit(lambda pp, xx: j_moe._moe_dropless(jcfg, pp, xx), p, x)
    y, aux = t_moe._moe_dropless(cfg, _torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-6)
    # without drops the capacity path is the dropless one
    yd, _ = t_moe._moe_dense(cfg.with_updates(capacity_factor=16.0), _torch(p),
                             torch.from_numpy(x))
    torch.testing.assert_close(yd, y, **LAYER_TOL)


def test_hidden_split_slots_equal_full_width_experts():
    """grok-style: 2 experts as 4 half-width slots; the output equals the
    full-width experts assembled from the slot shards, token by token."""
    cfg, jcfg = _cfgs(GROK, capacity_factor=16.0)
    p = _torch(_random_tree(lambda k: j_moe.moe_ffn_params(jcfg, k), seed=6))
    assert p["w_up"].shape == (4, cfg.d_model, 32)
    x = torch.from_numpy(_x(cfg, (8,), seed=7))
    y, _ = t_moe._moe_dense(cfg, p, x)
    full = {n: torch.cat([p[n][0::2], p[n][1::2]], dim=1 if n == "w_down" else -1)
            for n in ("w_gate", "w_up", "w_down")}
    w, idx, _ = t_moe._route(cfg, p["router"], x)
    want = torch.stack([
        w[t, 0] * t_moe._ffn(cfg, x[t][None, None], *(full[n][idx[t, 0]][None]
                                                      for n in ("w_gate", "w_up", "w_down")))[0, 0]
        for t in range(8)])
    torch.testing.assert_close(y, want, **LAYER_TOL)


def test_moe_seq_chunk_matches_jax(ffn):
    cfg, jcfg, p = ffn
    cfg, jcfg = (c.with_updates(moe_seq_chunk=8, capacity_factor=1.0) for c in (cfg, jcfg))
    x = _x(cfg, (2, 32), seed=8)
    yj, auxj = _jit(lambda pp, xx: j_moe.apply_moe_ffn(jcfg, pp, xx, JCtx()), p, x)
    y, aux = t_moe.apply_moe_ffn(cfg, _torch(p), torch.from_numpy(x), ParallelContext())
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-6)
    # chunking changes the capacity, so it is not the unchunked layer
    y1, _ = t_moe.apply_moe_ffn(cfg.with_updates(moe_seq_chunk=0), _torch(p),
                                torch.from_numpy(x), ParallelContext())
    assert not torch.equal(y, y1)


# ---------------------------------------------------------------------------
# expert parallelism on (2, 4)
# ---------------------------------------------------------------------------


def _jmesh(shape=MESH):
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices (conftest)")
    return j_compat.make_mesh(shape, ("data", "model"), devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def ep_jax(ffn):
    """JAX's EP layer at every (moe_comm, n_parts) cell on ``x`` (4, 32, d),
    each cell jitted once."""
    cfg, jcfg, p = ffn
    cfg, jcfg = (c.with_updates(capacity_factor=1.25) for c in (cfg, jcfg))
    mesh = _jmesh()
    x = _x(cfg, (4, 32), seed=9)
    out = {}
    for comm in ("native", "messages"):
        for n_parts in (1, 2):
            ctx = JCtx(mesh=mesh, moe_mode="ep", n_parts=n_parts, moe_comm=comm)
            with j_compat.set_mesh(mesh):
                y, aux = _jitr(lambda pp, xx, c=ctx: j_moe.apply_moe_ffn(jcfg, pp, xx, c))(
                    jax.tree.map(jnp.asarray, p), jnp.asarray(x))
            out[comm, n_parts] = (np.asarray(y), float(aux))
    return cfg, p, x, out


EP_CELLS = {
    "native": dict(moe_comm="native"),
    "messages-slice": dict(moe_comm="messages", comm_packer="slice"),
    "messages-cuda-uncoalesced": dict(moe_comm="messages", comm_packer="cuda",
                                      comm_coalesce=False),
}


@pytest.mark.parametrize("n_parts", [1, 2])
def test_ep_layer_matches_jax_and_its_variants_bitwise(ep_jax, n_parts):
    cfg, p, x, jout = ep_jax
    mesh = make_mesh(MESH, ("data", "model"), device="cpu")
    got = {}
    for cell, kw in EP_CELLS.items():
        ctx = ParallelContext(mesh=mesh, moe_mode="ep", n_parts=n_parts, **kw)
        got[cell] = t_moe.apply_moe_ffn(cfg, _torch(p), torch.from_numpy(x), ctx)
    y, aux = got["native"]
    for comm in ("native", "messages"):
        np.testing.assert_allclose(y.numpy(), jout[comm, n_parts][0], **LAYER_TOL)
        np.testing.assert_allclose(float(aux), jout[comm, n_parts][1], rtol=1e-6)
    for cell, (yc, auxc) in got.items():
        assert torch.equal(yc, y) and torch.equal(auxc, aux), cell


def test_ep_without_drops_equals_the_local_layer(ffn):
    """At no-drop capacity the expert-parallel layer is the local one."""
    cfg, _, p = ffn
    cfg = cfg.with_updates(capacity_factor=float(cfg.n_experts / cfg.top_k))
    x = torch.from_numpy(_x(cfg, (4, 32), seed=10))
    ctx = ParallelContext(mesh=make_mesh(MESH, ("data", "model"), device="cpu"), moe_mode="ep",
                          n_parts=2, moe_comm="messages")
    y, _ = t_moe.apply_moe_ffn(cfg, _torch(p), x, ctx)
    y_local, _ = t_moe.apply_moe_ffn(cfg, _torch(p), x, ParallelContext())
    torch.testing.assert_close(y, y_local, **LAYER_TOL)


@pytest.mark.parametrize("groups", [[[0, 1], [2, 3]], [[0, 2], [1, 3]], [[0, 1, 2, 3]]],
                         ids=["pairs", "strided", "whole"])
def test_grouped_psum_matches_jax(groups):
    """``partitioned_psum(axis_index_groups=)`` on the stacked ranks equals
    ``jax.lax.psum(axis_index_groups=)`` over the model axis of (2, 4);
    integer-valued f32, so every summation order is exact."""
    mesh = _jmesh()
    x = np.random.default_rng(11).integers(-50, 50, size=(8, 3, 5)).astype(np.float32)
    with j_compat.set_mesh(mesh):
        want = _jitr(j_compat.shard_map(
            lambda xl: jax.lax.psum(xl, "model", axis_index_groups=groups), mesh=mesh,
            in_specs=P(("data", "model")), out_specs=P(("data", "model"))))(jnp.asarray(x))
    got = partitioned_psum(torch.from_numpy(x).reshape(8, 1, 3, 5),
                           make_mesh(MESH, ("data", "model"), device="cpu"), "model",
                           axis_index_groups=groups)
    np.testing.assert_array_equal(got.reshape(8, 3, 5).numpy(), np.asarray(want))


def test_grouped_psum_refuses_uneven_groups():
    mesh = make_mesh(MESH, ("data", "model"), device="cpu")
    for groups in ([[0, 1, 2], [3]], [[0, 1], [1, 2]]):
        with pytest.raises(ValueError, match="groups"):
            partitioned_psum(torch.zeros(8, 2), mesh, "model", axis_index_groups=groups)


def test_ep_refuses_a_length_the_mesh_does_not_divide(ffn):
    cfg, _, p = ffn
    ctx = ParallelContext(mesh=make_mesh(MESH, ("data", "model"), device="cpu"), moe_mode="ep")
    with pytest.raises(ValueError, match="not evenly divisible"):
        t_moe.apply_moe_ffn(cfg, _torch(p), torch.zeros(2, 10, cfg.d_model), ctx)


def test_ep_refuses_a_model_axis_that_is_not_the_slot_count():
    """JAX's EP layer takes slot [0] of each rank's shard, so on (4, 2) (2
    ranks for 4 slots) it runs and is wrong: here it is held far from
    JAX's own local layer at no-drop capacity.  The port refuses that mesh,
    naming both numbers."""
    cfg, jcfg = _cfgs(PHI)  # reduced: 4 slots, capacity_factor 8 (no drops)
    p = _random_tree(lambda k: j_moe.moe_ffn_params(jcfg, k), seed=12)
    x = jnp.asarray(_x(cfg, (4, 32), seed=13))
    mesh = _jmesh((4, 2))
    with j_compat.set_mesh(mesh):
        y_ep, _ = _jitr(lambda pp, xx: j_moe.apply_moe_ffn(
            jcfg, pp, xx, JCtx(mesh=mesh, moe_mode="ep")))(p, x)
    y_local, _ = _jit(lambda pp, xx: j_moe.apply_moe_ffn(jcfg, pp, xx, JCtx()), p, x)
    rel = np.linalg.norm(np.asarray(y_ep) - np.asarray(y_local)) / np.linalg.norm(y_local)
    assert rel > 0.1, rel
    ctx = ParallelContext(mesh=make_mesh((4, 2), ("data", "model"), device="cpu"),
                          moe_mode="ep")
    with pytest.raises(ValueError, match="2 ranks, the model 4 slots"):
        t_moe.apply_moe_ffn(cfg, _torch(jax.tree.map(np.asarray, p)),
                            torch.from_numpy(np.asarray(x)), ctx)


# ---------------------------------------------------------------------------
# the model: logits, prefill, decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def phi_model():
    cfg, jcfg = _cfgs(PHI)
    jm = j_build_model(jcfg)
    tree = _random_tree(jm.init, seed=14)
    tm = build_model(cfg, "cpu")
    return cfg, jm, jax.tree.map(jnp.asarray, tree), tm, params_from_jax(cfg, tree, "cpu")


def test_logits_match_jax(phi_model):
    cfg, jm, jp, tm, tp = phi_model
    toks = np.random.default_rng(15).integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    want, aux_j = _jit(lambda p, t: (jm.logits(p, {"tokens": t}),
                                     j_moe.hidden_states(jm.cfg, p, t)[1]), jp, toks)
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # the aux loss through the layers
    _, aux = t_moe.hidden_states(cfg, tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)


def test_prefill_and_decode_steps_match_jax(phi_model):
    cfg, jm, jp, tm, tp = phi_model
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, size=(1, 12)).astype(np.int32)
    j_prefill = _jitr(lambda p, t, c: jm.prefill(p, {"tokens": t}, c))
    j_decode = _jitr(jm.decode_step)
    wl, wc = j_prefill(jp, jnp.asarray(toks), jm.init_cache(1, 32))
    gl, gc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tm.init_cache(1, 32))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGIT_TOL)
    np.testing.assert_allclose(gc["k"].numpy(), np.asarray(wc["k"]), **LOGIT_TOL)
    assert gc["pos"].tolist() == [12]
    tok = int(np.asarray(wl)[0, -1].argmax())
    for _ in range(4):
        wl, wc = j_decode(jp, jnp.full((1, 1), tok, jnp.int32), wc)
        gl, gc = tm.decode_step(tp, torch.full((1, 1), tok, dtype=torch.long), gc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGIT_TOL)
        tok = int(np.asarray(wl)[0, -1].argmax())
    np.testing.assert_allclose(gc["v"].numpy(), np.asarray(wc["v"]), **LOGIT_TOL)
    assert gc["pos"].tolist() == [16]


def test_ep_logits_equal_local_logits_without_drops(phi_model):
    """The whole model under EP (messages, n_parts 2) on a (1, 4) mesh:
    the reduced config's capacity_factor of 8 drops nothing, so the logits
    are the local ones."""
    cfg, _, _, tm, tp = phi_model
    toks = torch.from_numpy(np.random.default_rng(17).integers(0, cfg.vocab_size, size=(2, 16)))
    ctx = ParallelContext(mesh=make_mesh((1, 4), ("data", "model"), device="cpu"),
                          moe_mode="ep", moe_comm="messages", n_parts=2)
    torch.testing.assert_close(tm.logits(tp, {"tokens": toks}, ctx=ctx),
                               tm.logits(tp, {"tokens": toks}), **LOGIT_TOL)
