"""Training on the card (``cuda``-marked; skipped where there is no CUDA
device): the flash-attention backward kernel against autograd through the
plain attention, the refusal of gradients by the kernel wrappers that have
no backward, and a reduced stablelm-1.6b train step whose attention
backward is the kernel.  No JAX here: the parity against the JAX package
is the CPU files' (``tests/test_torch_train_*.py``).

Tolerances, stated: ``dq``, ``dk``, ``dv`` within relative L2 2e-2 (bf16:
inputs and outputs round to bf16, 2^-8) and 1e-4 (f32: sums in another
order) of autograd through ``attention_plain`` in f32 on the same inputs;
the forward's ``lse`` within 1e-3 of ``logsumexp`` of the plain scores.
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
from repro_torch.kernels.wkv.wkv import wkv_chunked
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import build_model
from repro_torch.train.train_loop import init_state, make_train_step

REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


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
    (1, 70, 0, 4, 2, 64, True, "float32"),           # no key: every row masked
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
    # the backward's delta pre-pass, dK/dV and dQ; dK/dV skipped with no key
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
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn((1, 512, 8, 64), generator=g, device=cuda).bfloat16()
               .requires_grad_() for _ in range(3))
    dout = torch.randn((1, 512, 8, 64), generator=g, device=cuda).bfloat16()
    first = torch.autograd.grad(FlashAttentionFn.apply(q, k, v, True, None), (q, k, v), dout)
    again = torch.autograd.grad(FlashAttentionFn.apply(q, k, v, True, None), (q, k, v), dout)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_wrappers_without_backward_refuse_grad(cuda):
    x = torch.randn((1, 8, 2, 16), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 19"):
        wkv_chunked(x, x, x, -torch.ones_like(x), torch.zeros((2, 16), device=cuda))
    blk = torch.randn((1, 6, 6, 6), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 21"):
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
            assert _build.LAUNCHES["flash_attention_bwd"] == 3 * n  # delta, dK/dV, dQ
        else:
            assert not _build.LAUNCHES
    assert math.isfinite(losses["kernel"])
    assert abs(losses["kernel"] - losses["plain"]) <= 2e-2 * abs(losses["plain"])
