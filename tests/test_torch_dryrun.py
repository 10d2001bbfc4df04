"""The port's dry-run (``repro_torch.launch.dryrun``) and its cost count
(``repro_torch.core.comm_analysis.count_cost``) against the JAX package's
(``repro.launch.dryrun``, ``repro.core.hlo_analysis.analyze_hlo``), on the
CPU, on meta tensors.

* Every cell of JAX's ``all_cells()`` on a ``(2, 4)`` ``("data", "model")``
  and a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh (the 8 virtual
  devices): microbatches, donated argnums and the per-device bytes of the
  parameters, the moments, the batch and the cache equal to what JAX's
  ``build_cell`` arguments' ``sharding.shard_shape`` give.  Parametrised by
  family.  For the MoE family also the collectives of phi3.5-moe's
  ``train_4k`` (expert parallel, 8 microbatches) under ``count_cost``,
  where the meta step runs one pass for all, equal to the same step run
  pass by pass on meta.
* ``count_cost``'s FLOPs equal ``analyze_hlo``'s on programs JAX compiles
  on the CPU; its bytes equal a hand count of the port's ops.
* The four kernels' meta routes give the plain versions' shapes and
  dtypes, launch nothing, and record ``kernels/costs.py``'s figures
  (``PERF.md``'s bound column at the training path's shapes).
* FLOPs are linear in depth; stablelm-1.6b's useful-FLOP ratio is the
  closed form below; ``main`` writes JAX's record keys and marks a refused
  cell ``FAIL``.

Importing ``repro.launch.dryrun`` rewrites ``XLA_FLAGS`` to 512 host
devices: the value is saved before and restored right after.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

_saved_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as J  # noqa: E402  (sets XLA_FLAGS on import)

if _saved_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved_flags

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.compat import make_mesh as j_make_mesh  # noqa: E402
from repro.core.hlo_analysis import analyze_hlo  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core.comm_analysis import count_collectives, count_cost  # noqa: E402
from repro_torch.core.mesh import VirtualMesh  # noqa: E402
from repro_torch.kernels import _build, costs  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention, attention_plain  # noqa: E402
from repro_torch.kernels.wkv.ops import wkv, wkv_plain  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

MESHES = (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")))
FAMILIES = ("dense", "moe", "rwkv", "hybrid", "vlm", "audio")


def _j_tree_bytes(tree) -> int:
    return sum(int(np.prod(s.sharding.shard_shape(s.shape))) * np.dtype(s.dtype).itemsize
               for s in jax.tree.leaves(tree))


def _named(args, kind: str, encoder: bool):
    """The argument trees the test compares, by name."""
    if kind == "train":
        state, batch = args
        return {"params": state["params"], "opt.m": state["opt"]["m"],
                "opt.v": state["opt"]["v"], "batch": batch}
    if encoder:
        return {"params": args[0], "batch": args[1]}
    return {"params": args[0], "batch": args[1], "cache": args[2]}


@pytest.mark.parametrize("family", FAMILIES)
def test_cells_match_jax_build_cell(family):
    cells = [(a, s) for a, s in J.all_cells() if j_get_config(a).family == family]
    assert cells
    for shape_axes, names in MESHES:
        jmesh = j_make_mesh(shape_axes, names)
        mesh = VirtualMesh(shape_axes, names, torch.device("meta"))
        for arch, shape_name in cells:
            jcfg, cfg = j_get_config(arch), get_config(arch)
            jshape, shape = J_SHAPES[shape_name], SHAPES[shape_name]
            label = f"{arch} x {shape_name} on {shape_axes}"
            assert D._microbatches(cfg, shape, mesh) == J._microbatches(jcfg, jshape, jmesh), label
            _, jargs, jdonate = J.build_cell(jcfg, jshape, jmesh)
            _, args, donate, specs = D.build_cell(cfg, shape, mesh)
            assert tuple(donate) == tuple(jdonate), label
            enc = cfg.is_encoder_only
            want = {k: _j_tree_bytes(v) for k, v in _named(jargs, shape.kind, enc).items()}
            spec_trees = _named(specs, shape.kind, enc)
            got = {k: D.tree_bytes(v, spec_trees[k], mesh)
                   for k, v in _named(args, shape.kind, enc).items()}
            assert got == want, label
            assert all(t.device.type == "meta" for t in jax.tree.leaves(args)), label
    if family == "moe":
        # every microbatch's all-to-alls, and one data rank's, a device
        cfg = D.reduced_depth(get_config("phi3.5-moe-42b-a6.6b"), 1)[0]
        mesh = VirtualMesh((2, 16), ("data", "model"), torch.device("meta"))
        assert D._microbatches(cfg, SHAPES["train_4k"], mesh) == 8
        got = _count(cfg, SHAPES["train_4k"], mesh)
        step, args, _, _ = D.build_cell(cfg, SHAPES["train_4k"], mesh)
        want = count_collectives(step, *args)  # no count_cost: every pass runs
        assert got.by_op_counts == want.by_op_counts and got.by_op_counts["all-to-all"] > 0
        assert got.by_op_counts["all-to-all"] % 8 == 0
        assert got.by_op_bytes == want.by_op_bytes and got.wire_bytes == want.wire_bytes


def _mlp(x, w1, w2):
    return torch.nn.functional.gelu(x @ w1, approximate="tanh").reshape(x.shape[0], -1) @ w2


def test_count_cost_flops_match_analyze_hlo_and_bytes_a_hand_count():
    import jax.numpy as jnp

    b, d, f, g, i, j, k = 32, 64, 128, 4, 16, 24, 8
    rng = np.random.default_rng(0)
    x, w1, w2 = (rng.standard_normal(s).astype(np.float32) for s in ((b, d), (d, f), (f, d)))
    p, q = (rng.standard_normal(s).astype(np.float32) for s in ((g, i, j), (g, j, k)))

    def j_mlp(x, w1, w2):
        return jax.nn.gelu(x @ w1, approximate=True) @ w2

    def hlo_flops(fn, *a):
        return analyze_hlo(jax.jit(fn).lower(*map(jnp.asarray, a)).compile().as_text()).flops

    st = count_cost(_mlp, *map(torch.from_numpy, (x, w1, w2)))
    assert st.flops == hlo_flops(j_mlp, x, w1, w2) == 2 * (2 * b * d * f)
    np.testing.assert_allclose(st.result.numpy(), np.asarray(j_mlp(x, w1, w2)), rtol=2e-5,
                               atol=2e-5)
    # mm: result + both operands; gelu: result + operand; the reshape is a
    # view (nothing); mm again; f32
    assert st.bytes == 4 * ((b * f + b * d + d * f) + 2 * b * f + (b * d + b * f + f * d))
    # mm, gelu, view, mm; at most the first product and gelu's result live
    assert st.ops == 4 and st.peak_bytes == 4 * 2 * b * f

    def einsum(p, q):
        return torch.einsum("gij,gjk->gik", p, q)

    st = count_cost(einsum, torch.from_numpy(p).to("meta"), torch.from_numpy(q).to("meta"))
    assert st.flops == hlo_flops(lambda p, q: jnp.einsum("gij,gjk->gik", p, q), p, q)
    assert st.flops == 2 * g * i * j * k
    # the einsum's reshapes are views; one bmm: result + operands
    assert st.bytes == 4 * (g * i * k + g * i * j + g * j * k)
    assert st.result.device.type == "meta"


def test_meta_routes_match_plain_outputs_and_record_the_kernels_costs():
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    _build.reset_launches()
    # flash forward and backward, GQA, bf16 (the dtype the route keeps)
    q, kk, vv = rand(2, 40, 8, 64), rand(2, 40, 2, 64), rand(2, 40, 2, 64)
    leaves = [t.bfloat16().requires_grad_() for t in (q, kk, vv)]
    out = attention_plain(*leaves, causal=True)
    want = [out] + list(torch.autograd.grad(out.float().sum(), leaves))
    metas = [torch.empty_like(t, device="meta").requires_grad_() for t in leaves]
    with torch.no_grad():
        st_fwd = count_cost(attention, *[t.detach() for t in metas], causal=True)

    def fwd_bwd():
        o = attention(*metas, causal=True)
        assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
        return [o] + list(torch.autograd.grad(o.float().sum(), metas))

    st = count_cost(fwd_bwd)
    for g_, w in zip(st.result, want):
        assert (g_.shape, g_.dtype, g_.device.type) == (w.shape, w.dtype, "meta")
    assert st_fwd.result.shape == out.shape and st_fwd.result.dtype == out.dtype
    fwd = costs.flash_cost(2, 40, 8, 40, 2, 64, causal=True, itemsize=2)
    assert st_fwd.kernels == {"flash_attention": {"calls": 1, "flops": fwd[0],
                                                  "bytes": fwd[1]}}
    bwd = costs.flash_bwd_cost(2, 40, 8, 40, 2, 64, causal=True, itemsize=2)
    assert st.kernels["flash_attention_bwd"] == {"calls": 1, "flops": bwd[0], "bytes": bwd[1]}
    assert st.kernels["flash_attention"]["bytes"] == fwd[1] + 4 * 2 * 8 * 40  # + the lse

    # WKV forward and backward (f32, a per-head u, a state in and out)
    B, T, H, hd, c = 2, 32, 2, 16, 16
    r, k, v = rand(B, T, H, hd), rand(B, T, H, hd), rand(B, T, H, hd)
    lw, u, S0 = -torch.exp(rand(B, T, H, hd)), rand(H, hd), rand(B, H, hd, hd)
    plain = [t.clone().requires_grad_() for t in (r, k, v, lw, u, S0)]
    y, S = wkv_plain(*plain[:5], chunk=c, S0=plain[5])
    want = [y, S] + list(torch.autograd.grad(y.sum() + S.sum(), plain))
    metas = [torch.empty_like(t, device="meta").requires_grad_() for t in plain]

    def wkv_fwd_bwd():
        ym, Sm = wkv(*metas[:5], chunk=c, S0=metas[5])
        assert "WkvChunked" in type(ym.grad_fn).__name__
        return [ym, Sm] + list(torch.autograd.grad(ym.sum() + Sm.sum(), metas))

    st = count_cost(wkv_fwd_bwd)
    for g_, w in zip(st.result, want):
        assert (g_.shape, g_.dtype, g_.device.type) == (w.shape, w.dtype, "meta")
    fwd = costs.wkv_cost(B, T, H, hd, c, itemsize=4, u_numel=H * hd, S0=True, states=True)
    bwd = costs.wkv_bwd_cost(B, T, H, hd, c, itemsize=4, u_numel=H * hd, dS_fin=True, dS0=True)
    assert st.kernels == {"wkv_chunked": {"calls": 1, "flops": fwd[0], "bytes": fwd[1]},
                          "wkv_chunked_bwd": {"calls": 1, "flops": bwd[0], "bytes": bwd[1]}}
    assert not _build.LAUNCHES  # a meta route launches nothing

    # the bound column's figures at the training paths' shapes (PERF.md §2, §6)
    assert costs.flash_bwd_cost(1, 4096, 32, 4096, 32, 64, causal=True,
                                itemsize=2)[0] == 171_798_691_840
    assert round(costs.wkv_bwd_cost(1, 4096, 32, 64, 64, itemsize=4,
                                    u_numel=32 * 64)[0] / 1e9, 2) == 7.34
    assert costs.flash_cost(1, 4096, 32, 4096, 32, 64, causal=True,
                            itemsize=2)[0] == 2 * 32 * 4096 * 4096 * 64


@pytest.fixture(scope="module")
def meta_mesh():
    return VirtualMesh((2, 4), ("data", "model"), torch.device("meta"))


def _count(cfg, shape, mesh):
    """One cell's count: the stacked step's totals (exact ints)."""
    step, args, _, _ = D.build_cell(cfg, shape, mesh)
    return count_cost(step, *args)


@pytest.fixture(scope="module")
def stablelm_train(meta_mesh):
    """stablelm-1.6b's train_4k cell at full width and depth on the meta
    ``(2, 4)`` mesh."""
    return _count(get_config("stablelm-1.6b"), SHAPES["train_4k"], meta_mesh)


@pytest.mark.parametrize("arch", ("stablelm-1.6b", "rwkv6-1.6b"))
def test_flops_are_linear_in_depth(arch, meta_mesh, stablelm_train):
    """Full depth = depth 1 + (L - 1)(depth 2 - depth 1), exactly: every
    layer costs the same, counted from what runs."""
    cfg, shape = get_config(arch), SHAPES["train_4k"]
    f1, f2 = (_count(D.reduced_depth(cfg, u)[0], shape, meta_mesh).flops for u in (1, 2))
    full = (stablelm_train if arch == "stablelm-1.6b" else _count(cfg, shape, meta_mesh)).flops
    assert full == f1 + (cfg.n_layers - 1) * (f2 - f1)
    assert f2 > f1 > 0


def test_useful_flop_ratio_of_stablelm(stablelm_train, meta_mesh):
    """``model_flops_per_token(4096)`` x tokens over the counted FLOPs, per
    device.  stablelm-1.6b trains without remat, so nothing is recomputed:
    the count is 6 FLOPs a token for each matrix weight (forward, and the
    backward's two products; the embedding is a gather, not a product) and
    the flash kernels' 2 (forward) + 5 (backward) x d_attn x S/2 x 2 a
    token and layer; the model's is 6 N (the embedding included) and 6 x
    d_attn x S/2 x 2.  So the ratio is (6 N + 6 a) / (6 (N - V d - norms)
    + 7 a), a = L d_attn S: 1.1029 here, in the band 1.05-1.15 (a remat
    config's recomputed forward would bring it under 1)."""
    cfg, shape = get_config("stablelm-1.6b"), SHAPES["train_4k"]
    n, v, d, L, s = cfg.active_param_count(), cfg.vocab_size, cfg.d_model, cfg.n_layers, 4096
    norms = (2 * L + 1) * 2 * d  # layernorm scale and bias
    a = L * cfg.n_heads * cfg.resolved_head_dim * s
    tokens = shape.global_batch * shape.seq_len
    counted = stablelm_train.flops
    assert counted == tokens * (6 * (n - v * d - norms) + 7 * a)
    ratio = cfg.model_flops_per_token(s) * tokens / counted
    assert ratio == pytest.approx((6 * n + 6 * a) / (6 * (n - v * d - norms) + 7 * a), rel=1e-12)
    assert 1.05 < ratio < 1.15
    # one pass of each kernel a layer and microbatch of each data rank
    calls = L * D._microbatches(cfg, shape, meta_mesh) * meta_mesh.shape["data"]
    assert stablelm_train.kernels["flash_attention_bwd"]["calls"] == calls
    assert stablelm_train.kernels["flash_attention"]["calls"] == calls


def test_main_writes_jax_record_keys_and_fails_a_refused_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    D.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--mesh", "single"])
    rec = json.loads((tmp_path / "stablelm-1.6b.decode_32k.single.json").read_text())
    jax_keys = {"flops", "bytes", "wire_bytes", "wire_by_op", "coll_counts", "n_loops",
                "trip_counts", "memory"}
    assert jax_keys <= set(rec["full"]) and "xla_flops" not in rec["full"]
    assert set(rec["full"]["memory"]) == {"argument", "output", "temp", "peak", "alias"}
    assert {"arch", "shape", "mesh", "n_devices", "overrides", "microbatches", "compile_s",
            "fits_16gb", "hbm_fits"} <= set(rec)
    assert rec["n_devices"] == 256 and rec["full"]["n_loops"] == 0
    mem = rec["full"]["memory"]
    assert 0 < mem["alias"] < mem["argument"] and mem["peak"] == mem["argument"] + mem["temp"]
    assert "PASS stablelm-1.6b x decode_32k x single" in capsys.readouterr().out
    assert D.ARCH_IDS == J.ARCH_IDS and D.all_cells() == J.all_cells()
    assert len(D.all_cells()) == 31
    # expert parallelism on a model axis that is not the slot count (16
    # ranks, 32 slots), which the port refuses where JAX computes a wrong
    # result; grok-1's FSDP expert stacks train (tests/test_torch_train_fsdp.py)
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "phi3.5-moe-42b-a6.6b", "--shape", "prefill_32k", "--mesh", "single",
                "--set", "cfg.ep_slots=32"])
    assert e.value.code == 1
    assert ("FAIL phi3.5-moe-42b-a6.6b x prefill_32k x single: ValueError"
            in capsys.readouterr().out)
    assert "one expert slot a rank" in (
        tmp_path / "phi3.5-moe-42b-a6.6b.prefill_32k.single.json.err").read_text()
    with pytest.raises(SystemExit, match="no HLO"):
        D.main(["--reanalyze"])
