"""Training on the card (``cuda``-marked; skipped where there is no CUDA
device): the flash-attention backward kernel against autograd through the
plain attention, the WKV backward kernel ``wkv_chunked_bwd`` against its
plain version ``wkv_bwd_plain`` (bitwise repeatable, and what it refuses),
the refusal of gradients by the kernel wrappers that have no backward, and
reduced stablelm-1.6b and rwkv6-1.6b train steps whose backward runs the
kernels; the ring KV hop's backward through the pack kernels, and the
mesh step on the card against the one-device step.  No JAX here: the parity against the JAX package is the CPU
files' (``tests/test_torch_train_*.py``, ``tests/test_torch_kernels_wkv_bwd.py``).

Tolerances, stated: ``dq``, ``dk``, ``dv`` within relative L2 2e-2 (bf16:
inputs and outputs round to bf16, 2^-8) and 1e-4 (f32: sums in another
order) of autograd through ``attention_plain`` in f32 on the same inputs;
the forward's ``lse`` within 1e-3 of ``logsumexp`` of the plain scores.
The WKV backward's six outputs within relative L2 ``WKV_BWD_TOL`` of
``wkv_bwd_plain`` in float64 on the same inputs (f32: the kernel's
per-pair exponentials by ``ex2.approx`` and f32 sums; bf16: the gradients
rounded to bf16).
"""

import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention, attention_plain
from repro_torch.kernels.flash_attention.flash import FlashAttentionFn, flash_attention
from repro_torch.kernels.pack.pack import copy_convert
from repro_torch.kernels.stencil27.stencil27 import stencil27
from repro_torch.kernels.wkv import wkv, wkv_bwd_plain, wkv_plain
from repro_torch.kernels.wkv.ref import BWD_TOL as WKV_BWD_TOL, bwd_check_inputs
from repro_torch.kernels.wkv.wkv import WkvChunkedFn, wkv_chunked, wkv_chunked_bwd
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import build_model
from repro_torch.train.train_loop import init_state, make_train_step

REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
WKV_NAMES = ("dr", "dk", "dv", "dlw", "du", "dS0")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    den = want.double().norm().item()
    err = (got.double() - want.double()).norm().item()
    return err / den if den else err


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,dtype", [
    (2, 4096, 4096, 32, 32, 64, True, "bfloat16"),   # stablelm-1.6b's training shape
    (1, 2048, 2048, 32, 8, 128, True, "bfloat16"),   # llama3-8b's GQA
    (4, 1000, 1000, 16, 16, 80, False, "bfloat16"),  # hubert-xlarge's encoder
    (2, 300, 200, 8, 4, 64, True, "float32"),        # ragged Sq != Skv
    (1, 77, 130, 4, 1, 128, False, "float32"),
    (2, 300, 200, 8, 4, 64, True, "bfloat16"),       # the same on the tensor cores: ragged
    (1, 77, 130, 4, 1, 128, False, "bfloat16"),      # query and key tiles, GQA
    (1, 70, 0, 4, 2, 64, True, "float32"),           # no key: every row masked
    # the reduced configs' and the examples' head dims, on the 64-wide tile
    (8, 32, 32, 4, 2, 16, True, "bfloat16"),         # quickstart's step, GQA 4/2
    (2, 300, 200, 8, 4, 16, False, "bfloat16"),      # ragged, GQA
    (2, 512, 512, 8, 4, 32, True, "bfloat16"),
    (1, 77, 130, 4, 1, 32, True, "bfloat16"),        # ragged, MQA
    (2, 300, 200, 8, 4, 16, True, "float32"),
    (1, 77, 130, 4, 2, 32, False, "float32"),
])
def test_flash_backward_matches_plain(cuda, b, sq, skv, hq, hkv, d, causal, dtype):
    td = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(td).requires_grad_()
    k = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(td).requires_grad_()
    v = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(td).requires_grad_()
    dout = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(td)
    _build.reset_launches()
    out = attention(q, k, v, causal=causal)  # grad enabled: FlashAttentionFn
    lse = out.grad_fn.saved_tensors[4]
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    # the backward's three launches (f32: delta, dK/dV, dQ; bf16: the
    # pre-pass, the one pass, dQ's rounding); the middle one skipped with no key
    assert dict(_build.LAUNCHES) == {"flash_attention": 1,
                                     "flash_attention_bwd": 2 + (skv > 0)}
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = attention_plain(q32, k32, v32, causal=causal)
    wq, wk, wv = torch.autograd.grad(want, (q32, k32, v32), dout.float())
    for got, ref in ((dq, wq), (dk, wk), (dv, wv)):
        assert got.dtype == td and torch.isfinite(got.float()).all()
        assert _rel(got.float(), ref) <= REL_TOL[dtype]
    if skv == 0:
        assert not dq.any() and bool((lse == float("-inf")).all())
        return
    for i in range(b):
        kf = k32[i].detach().repeat_interleave(hq // hkv, dim=1)
        s = torch.einsum("qhd,khd->hqk", q32[i].detach(), kf) / math.sqrt(d)
        if causal:
            s = s.masked_fill(torch.arange(sq, device=cuda)[:, None]
                              < torch.arange(skv, device=cuda)[None, :], -1e30)
        assert (lse[i] - torch.logsumexp(s, -1)).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_flash_backward_is_bitwise_repeatable(cuda):
    """Three calls give the same bits: dQ's partial sums are added in the
    order of their kv tiles.  At the training path's shape and llama3-8b's
    GQA many kv tiles add into each query tile."""
    for b, s, hq, hkv, d in ((1, 512, 8, 8, 64), (1, 4096, 32, 32, 64), (1, 2048, 32, 8, 128)):
        g = torch.Generator(cuda).manual_seed(1)
        q = torch.randn((b, s, hq, d), generator=g, device=cuda).bfloat16().requires_grad_()
        k, v = (torch.randn((b, s, hkv, d), generator=g, device=cuda).bfloat16()
                .requires_grad_() for _ in range(2))
        dout = torch.randn((b, s, hq, d), generator=g, device=cuda).bfloat16()
        first, *more = (torch.autograd.grad(FlashAttentionFn.apply(q, k, v, True, None),
                                            (q, k, v), dout) for _ in range(3))
        assert all(torch.equal(a, c) for again in more for a, c in zip(first, again)), (s, hq, hkv)


@pytest.mark.cuda
def test_wrappers_without_backward_refuse_grad(cuda):
    """The bare kernel wrappers refuse a gradient; the WKV scan's gradient
    goes through ``WkvChunkedFn`` (``ops.wkv``), whose output carries it."""
    x = torch.randn((1, 8, 2, 16), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="WkvChunkedFn"):
        wkv_chunked(x, x, x, -torch.ones_like(x), torch.zeros((2, 16), device=cuda))
    y, S = wkv(x, x, x, -torch.ones_like(x), torch.zeros((2, 16), device=cuda), chunk=8)
    assert isinstance(y.grad_fn, WkvChunkedFn._backward_cls) and S.grad_fn is y.grad_fn
    assert torch.autograd.grad(y.sum() + S.sum(), x)[0].abs().sum() > 0
    blk = torch.randn((1, 6, 6, 6), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="RingHopFn"):
        copy_convert(blk, torch.empty((1, 6, 6, 6), device=cuda))
    with pytest.raises(NotImplementedError, match="differentiates"):
        stencil27(blk, torch.ones((3, 3, 3), device=cuda), torch.empty((1, 4, 4, 4), device=cuda))
    q = torch.randn((1, 8, 2, 64), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="FlashAttentionFn"):
        flash_attention(q, q, q)
    with torch.no_grad():  # serving: no graph, the forward alone
        assert flash_attention(q, q, q).shape == q.shape


@pytest.mark.cuda
def test_train_step_runs_the_backward_kernel(cuda):
    """A reduced stablelm-1.6b step on the card (bf16, one layer's flash
    forward and backward per layer and microbatch), its loss against the
    same step with the plain attention."""
    cfg = get_config("stablelm-1.6b").reduced().with_updates(head_dim=64)  # a kernel head dim
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in SyntheticLM(cfg, 4, 64, seed=0).batch_at(0).items()}
    losses = {}
    for name, attn in (("kernel", None), ("plain", attention_plain)):
        model = build_model(cfg, cuda, attention=attn)
        state = init_state(model, opt, 0)
        _build.reset_launches()
        state, met = make_train_step(model, opt, microbatches=2)(state, batch)
        losses[name] = met["loss"].item()
        if name == "kernel":
            n = cfg.n_layers * 2
            assert _build.LAUNCHES["flash_attention"] == n
            assert _build.LAUNCHES["flash_attention_bwd"] == 3 * n  # pre-pass, pass, dQ
        else:
            assert not _build.LAUNCHES
    assert math.isfinite(losses["kernel"])
    assert abs(losses["kernel"] - losses["plain"]) <= 2e-2 * abs(losses["plain"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,chunk,dtype,per_row_u,with_state", [
    (1, 1024, 4, 64, 64, "float32", False, False),  # rwkv6-1.6b's head size and chunk
    (2, 256, 4, 8, 16, "float32", False, True),
    (2, 256, 4, 16, 16, "float32", True, True),     # a per-row bonus
    (2, 256, 4, 32, 16, "float32", False, True),
    (3, 40, 2, 64, 64, "float32", False, True),     # T = c = 40: one ragged chunk
    (2, 128, 4, 64, 64, "bfloat16", False, True),
    (2, 4096, 4, 64, 64, "float32", False, True),   # the dS scan across 64 chunks, batch 2
])
def test_wkv_backward_matches_plain(cuda, B, T, H, hd, chunk, dtype, per_row_u, with_state):
    td = getattr(torch, dtype)
    r, k, v, lw, u, S0, dy, dS_fin = bwd_check_inputs(B, T, H, hd, dtype=td, device=cuda,
                                                      per_row_u=per_row_u)
    S0, dS_fin = (S0, dS_fin) if with_state else (None, None)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    s0 = None if S0 is None else S0.clone().requires_grad_()
    _build.reset_launches()
    y, S = wkv(*leaves, chunk=chunk, S0=s0)  # grad enabled: WkvChunkedFn
    obj = (y.float() * dy.float()).sum() + (0 if dS_fin is None else (S * dS_fin).sum())
    got = torch.autograd.grad(obj, leaves + ([] if s0 is None else [s0]))
    assert dict(_build.LAUNCHES) == {"wkv_chunked": 1, "wkv_chunked_bwd": 1}
    want = wkv_bwd_plain(*(t.double() for t in (r, k, v, lw, u, dy)), chunk=chunk,
                         S0=None if S0 is None else S0.double(),
                         dS_fin=None if dS_fin is None else dS_fin.double())
    for name, g, w in zip(WKV_NAMES, got, want):
        assert g.dtype == (torch.float32 if name == "dS0" else td), name
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g.float(), w) <= WKV_BWD_TOL[dtype], (name, _rel(g.float(), w))


@pytest.mark.cuda
def test_wkv_backward_is_bitwise_repeatable(cuda):
    """Three calls on the same inputs give the same bits: every sum in a
    fixed order, du summed over the batch in order."""
    r, k, v, lw, u, S0, dy, dS_fin = bwd_check_inputs(2, 512, 8, 64, seed=2, device=cuda)
    states = torch.empty((2, 8, 8, 64, 64), device=cuda)
    _, S_fin = wkv_chunked(r, k, v, lw, u, chunk=64, S0=S0, states=states)
    first, *more = (wkv_chunked_bwd(r, k, v, lw, u, dy, states, chunk=64, S_fin=S_fin,
                                    dS_fin=dS_fin, want_dS0=True) for _ in range(3))
    assert all(torch.equal(a, b) for again in more for a, b in zip(first, again))


@pytest.mark.cuda
def test_wkv_backward_takes_unaligned_inputs(cuda):
    """Contiguous inputs that are not 16-byte aligned (the kernels read in
    vectors) give the aligned call's gradients bit for bit."""
    r, k, v, lw, u, S0, dy, dS_fin = bwd_check_inputs(1, 128, 2, 16, seed=4, device=cuda)
    states = torch.empty((1, 2, 2, 16, 16), device=cuda)
    _, S_fin = wkv_chunked(r, k, v, lw, u, chunk=64, S0=S0, states=states)

    def shifted(t):  # the same values one element past an aligned base
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    want = wkv_chunked_bwd(r, k, v, lw, u, dy, states, chunk=64, S_fin=S_fin, dS_fin=dS_fin,
                           want_dS0=True)
    got = wkv_chunked_bwd(*map(shifted, (r, k, v, lw)), u, shifted(dy), shifted(states),
                          chunk=64, S_fin=shifted(S_fin), dS_fin=shifted(dS_fin), want_dS0=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_wkv_states_leave_the_forward_unchanged(cuda):
    """The chunk-entry states the training forward writes: S0 first, each
    the plain scan's state at its chunk's start; y and the final state
    bitwise the serving call's (no states), on both routes."""
    r, k, v, lw, u, S0, _, _ = bwd_check_inputs(2, 96, 4, 32, seed=3, device=cuda)
    for chunk in (32, 1):
        n = 96 // chunk
        states = torch.empty((2, 4, n, 32, 32), device=cuda)
        y, S = wkv_chunked(r, k, v, lw, u, chunk=chunk, S0=S0, states=states)
        y0, S_0 = wkv_chunked(r, k, v, lw, u, chunk=chunk, S0=S0)
        assert torch.equal(y, y0) and torch.equal(S, S_0)
        assert torch.equal(states[:, :, 0], S0)
        for i in (1, n - 1):
            _, want = wkv_plain(r[:, :i * chunk].double(), k[:, :i * chunk].double(),
                                v[:, :i * chunk].double(), lw[:, :i * chunk].double(),
                                u.double(), S0=S0.double(), chunk=chunk)
            assert (states[:, :, i].double() - want).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_wkv_backward_refuses_what_it_does_not_take(cuda):
    r, k, v, lw, u, S0, dy, dS_fin = bwd_check_inputs(1, 64, 2, 64, device=cuda)
    states = torch.empty((1, 2, 1, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        wkv_chunked_bwd(*(t[..., :48] for t in (r, k, v, lw, u, dy)), states, chunk=64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv_chunked_bwd(r[:, :48], k[:, :48], v[:, :48], lw[:, :48], u, dy[:, :48],
                        states, chunk=32)
    with pytest.raises(ValueError, match="states"):
        wkv_chunked_bwd(r, k, v, lw, u, dy, states[:, :1, :, :32], chunk=64)
    with pytest.raises(ValueError, match="S_fin"):
        wkv_chunked_bwd(r, k, v, lw, u, dy, states, chunk=64, dS_fin=dS_fin)
    with pytest.raises(TypeError, match="one dtype"):
        wkv_chunked_bwd(r, k, v, lw, u, dy.bfloat16(), states, chunk=64)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_chunked_bwd(r, k, v, lw, u.cpu(), dy, states, chunk=64)


@pytest.mark.cuda
def test_rwkv_train_step_runs_the_wkv_backward(cuda):
    """A reduced rwkv6-1.6b step on the card (bf16, the WKV forward and
    backward kernels; remat, so each layer's forward runs twice), its loss
    against the same step with the plain scan."""
    cfg = get_config("rwkv6-1.6b").reduced().with_updates(remat="full")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in SyntheticLM(cfg, 4, 128, seed=0).batch_at(0).items()}
    losses = {}
    for name, scan in (("kernel", None), ("plain", wkv_plain)):
        model = build_model(cfg, cuda, wkv=scan)
        state = init_state(model, opt, 0)
        _build.reset_launches()
        state, met = make_train_step(model, opt, microbatches=2)(state, batch)
        losses[name] = met["loss"].item()
        if name == "kernel":
            n = cfg.n_layers * 2
            assert _build.LAUNCHES["wkv_chunked_bwd"] == n
            assert _build.LAUNCHES["wkv_chunked"] == 2 * n  # the forward and its recompute
        else:
            assert not _build.LAUNCHES
    assert math.isfinite(losses["kernel"])
    assert abs(losses["kernel"] - losses["plain"]) <= 1e-3 * abs(losses["plain"])


@pytest.mark.cuda
@pytest.mark.parametrize("n_parts", [1, 4])
def test_ring_hop_backward_runs_the_pack_kernels(cuda, n_parts):
    """``RingHopFn`` on the card with the ``cuda`` packer: the output is
    the ring predecessor's block, the gradient the cotangent sent back,
    both bitwise (and equal to the ``slice`` packer's), and the backward
    launches ``gather_pack`` and ``copy_convert``."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.ring import RingHopFn, ring_kv_plan
    from repro_torch.core.transport import resolve_packer, resolve_transport

    mesh = make_mesh((1, 4), ("data", "model"), device=cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    kv = torch.randn((4, 2, 1, 256, 8, 64), generator=gen, device=cuda, dtype=torch.bfloat16)
    cot = torch.randn(kv.shape, generator=gen, device=cuda, dtype=torch.bfloat16)
    src = torch.tensor([3, 0, 1, 2], device=cuda)
    outs = {}
    for packer in ("cuda", "slice"):
        plan = dict(n_parts=n_parts, packer=resolve_packer(packer),
                    transport=resolve_transport("loopback"), coalesce=True)
        hop = ring_kv_plan(mesh, "model", tuple(kv.shape[1:]), kv.dtype, **plan)
        back = ring_kv_plan(mesh, "model", tuple(kv.shape[1:]), kv.dtype, shift=-1, **plan)
        x = kv.clone().requires_grad_(True)
        y = RingHopFn.apply(x, hop, back)
        _build.reset_launches()
        (g,) = torch.autograd.grad(y, x, cot)
        torch.cuda.synchronize()
        if packer == "cuda":
            assert _build.LAUNCHES["gather_pack"] == n_parts
            assert _build.LAUNCHES["copy_convert"] == 2 * n_parts  # K and V each round
        assert torch.equal(y, kv[src]) and torch.equal(g[src], cot)
        outs[packer] = (y, g)
    assert all(torch.equal(a, b) for a, b in zip(outs["cuda"], outs["slice"]))


@pytest.mark.cuda
def test_mesh_step_on_the_card_matches_the_one_device_step(cuda):
    """Reduced stablelm-1.6b (bf16, head dim 64) on a ``(2, 4)`` mesh of
    stacked ranks on the card: the flash kernels run in each data rank's
    loss, and two steps' losses are within 1e-3 relative of the one-device
    ``Trainer``'s on the same weights and data."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core.mesh import make_mesh
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.train.train_loop import Trainer

    cfg = get_config("stablelm-1.6b").reduced().with_updates(head_dim=64)
    model = build_model(cfg, cuda)
    run = RunConfig(model=cfg, shape=ShapeConfig("mesh", 64, 4, "train"),
                    optimizer=OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10),
                    steps=2, log_every=0)
    one = Trainer(model, run).run()
    _build.reset_launches()
    ctx = ParallelContext(mesh=make_mesh((2, 4), ("data", "model"), device=cuda))
    mesh = Trainer(model, run, ctx=ctx).run()
    assert _build.LAUNCHES["flash_attention_bwd"] > 0
    for a, b in zip(mesh.losses, one.losses):
        assert math.isfinite(a) and abs(a - b) <= 1e-3 * abs(b)
