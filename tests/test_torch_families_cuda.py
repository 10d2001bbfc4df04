"""The last model families on the card (``cuda``-marked; skipped where
there is no CUDA device): the flash kernel at head dim 80 (hubert-xlarge's)
on both routes, ``seq_left_halo`` with packer ``cuda`` (the
``copy_convert`` kernel) bitwise against packer ``slice``, the hybrid's
and the VLM's prefill and decode with the flash kernel against the same
models with the plain attention, the hybrid's sequence-parallel logits
against the local ones, hubert's encoder at head dim 80, and the engine's
captured decode graph against the eager decode for both decoder families.
No JAX here: the parity against the JAX package is the CPU files'
(``tests/test_torch_models_hybrid.py``, ``test_torch_models_vlm_audio.py``,
``test_torch_serving_families.py``).

Tolerances, stated: the flash kernel against its plain version bf16
``rtol=atol=2e-2``, f32 ``rtol=atol=2e-5`` (``tests/test_torch_kernels_
flash.py``'s); f32 model outputs ``rtol=atol=1e-4`` (the kernel's f32 route
is held to 2e-5 a call; a few layers); the sequence-parallel logits
``rtol=atol=1e-4`` (the SSD and ring sums in other orders).
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.halo import seq_left_halo
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention, attention_plain
from repro_torch.models import build_model
from repro_torch.parallel.context import ParallelContext
from repro_torch.serving.engine import ServingEngine

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,hq,hkv", [(4, 1000, 1000, 16, 16), (2, 77, 200, 4, 2),
                                             (1, 300, 100, 4, 1), (1, 5, 5, 2, 2)])
def test_flash_head_dim_80_matches_plain(cuda, dtype, causal, b, sq, skv, hq, hkv):
    td = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((b, hq, sq, 80), generator=g, device=cuda).to(td).transpose(1, 2)  # strided
    k, v = (torch.randn((b, skv, hkv, 80), generator=g, device=cuda).to(td) for _ in range(2))
    _build.reset_launches()
    got = attention(q, k, v, causal=causal)
    assert _build.LAUNCHES["flash_attention"] == 1
    want = attention_plain(q, k, v, causal=causal)
    assert got.shape == (b, sq, hq, 80) and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_parts", [1, 3])
def test_seq_left_halo_cuda_packer_bitwise_equals_slice(cuda, dtype, n_parts):
    mesh = make_mesh((1, 8), ("data", "model"), device=cuda)
    x = torch.randn((8, 5, 256, 48), generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda).to(getattr(torch, dtype))
    want = seq_left_halo(x, mesh, "model", 3, n_parts=n_parts, packer="slice")
    _build.reset_launches()
    got = seq_left_halo(x, mesh, "model", 3, n_parts=n_parts, packer="cuda")
    assert _build.LAUNCHES["copy_convert"] == 2 * n_parts  # a pack and an unpack a part
    assert torch.equal(got, want) and not got[0, :, :3].any()


def _tokens(cfg, dev, b, s, seed):
    return torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator(dev).manual_seed(seed),
                         device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name,upd", [("zamba2-1.2b", dict(n_layers=5, head_dim=64)),
                                      ("llama-3.2-vision-11b", dict(head_dim=64))])
def test_prefill_and_decode_flash_match_plain(cuda, name, upd):
    cfg = get_config(name).reduced().with_updates(**F32, **upd)
    model = build_model(cfg, cuda)
    plain = build_model(cfg, cuda, attention=attention_plain)
    params = model.init(0)
    if cfg.family == "vlm":  # the gates open, so the cross layers count
        for cp in params["cross"]:
            cp["xattn"]["gate_attn"].fill_(0.5)
            cp["xattn"]["gate_ffn"].fill_(0.5)
    batch = {"tokens": _tokens(cfg, cuda, 2, 64, 2)}
    if cfg.family == "vlm":
        batch["vision_emb"] = torch.randn((2, cfg.vision_tokens, cfg.d_vision), device=cuda)
    _build.reset_launches()
    got, cache = model.prefill(params, batch, model.init_cache(2, 96))
    n_attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    assert _build.LAUNCHES["flash_attention"] == n_attn  # self and cross layers alike
    want, pcache = plain.prefill(params, batch, plain.init_cache(2, 96))
    torch.testing.assert_close(got, want, **MODEL_TOL)
    tok = want[:, -1:].argmax(-1)
    got, _ = model.decode_step(params, tok, cache)
    want, _ = plain.decode_step(params, tok, pcache)
    torch.testing.assert_close(got, want, **MODEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ring", "tree"])
def test_hybrid_sequence_parallel_logits_match_local(cuda, method):
    cfg = get_config("zamba2-1.2b").reduced().with_updates(**F32, n_layers=5, head_dim=64)
    model = build_model(cfg, cuda)
    params = model.init(0)
    batch = {"tokens": _tokens(cfg, cuda, 2, 256, 3)}
    want = model.logits(params, batch)
    ctx = ParallelContext(mesh=make_mesh((1, 8), ("data", "model"), device=cuda),
                          seq_parallel=True, state_method=method, comm_packer="cuda", n_parts=2)
    torch.testing.assert_close(model.logits(params, batch, ctx=ctx), want, **MODEL_TOL)


@pytest.mark.cuda
def test_encoder_at_head_dim_80_matches_plain(cuda):
    cfg = get_config("hubert-xlarge").reduced().with_updates(**F32, head_dim=80)
    model = build_model(cfg, cuda)
    plain = build_model(cfg, cuda, attention=attention_plain)
    params = model.init(0)
    frames = torch.randn((2, 100, cfg.d_vision), generator=torch.Generator(cuda).manual_seed(4),
                         device=cuda)
    _build.reset_launches()
    got = model.logits(params, {"frames": frames})
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got, plain.logits(params, {"frames": frames}), **MODEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,upd", [("zamba2-1.2b", dict(n_layers=5, head_dim=64)),
                                      ("llama-3.2-vision-11b", dict(head_dim=64))])
def test_graph_decode_tokens_equal_eager(cuda, name, upd):
    class EagerDecodeEngine(ServingEngine):  # the decode plan without example arguments
        def _plan(self, fn, args, *, example_args=None):
            return super()._plan(fn, args)

    cfg = get_config(name).reduced().with_updates(**F32, **upd)
    model = build_model(cfg, cuda)
    params = model.init(0)
    prompts = [[int(t) for t in _tokens(cfg, cuda, 1, n, n)[0]] for n in (5, 12, 32, 64)]
    runs = []
    for engine_cls in (ServingEngine, EagerDecodeEngine):
        engine = engine_cls(model, params, max_slots=2, max_len=96)
        uids = [engine.submit(p, max_new_tokens=6) for p in prompts]
        done = engine.run()
        runs.append([done[u] for u in uids])
        captured = [p.name for p in engine.plans._plans.values() if p.captured]
        assert captured == (["decode_fn"] if engine_cls is ServingEngine else [])
    assert runs[0] == runs[1]
