"""The MoE model on the card (``cuda``-marked; skipped where there is no
CUDA device): the expert-parallel layer with packer ``cuda`` (every
dispatch and return through ``gather_pack`` and ``copy_convert``) bitwise
against packer ``slice``, and the MoE prefill and decode with the flash
kernel against the same model with the plain attention.  No JAX here: the
parity against the JAX package is ``tests/test_torch_models_moe.py``'s, on
the CPU.

Tolerance, stated: f32 logits ``rtol=atol=1e-4`` (the flash kernel's f32
route is held to 2e-5 a call; two layers).
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.models import build_model
from repro_torch.models import moe as t_moe
from repro_torch.parallel.context import ParallelContext

NAME = "phi3.5-moe-42b-a6.6b"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ep_cuda_packer_bitwise_equals_slice_on_the_card(cuda, dtype):
    cfg = get_config(NAME).reduced().with_updates(dtype=dtype, param_dtype=dtype,
                                                   capacity_factor=1.25)
    p = t_moe.moe_ffn_params(cfg, torch.Generator(cuda).manual_seed(0))
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn((2, 64, cfg.d_model), generator=g, device=cuda).to(p["w_up"].dtype)
    mesh = make_mesh((2, 4), ("data", "model"), device=cuda)
    for n_parts in (1, 3):
        want, aux = t_moe.apply_moe_ffn(cfg, p, x, ParallelContext(
            mesh=mesh, moe_mode="ep", n_parts=n_parts, moe_comm="messages", comm_packer="slice"))
        for coalesce in (True, False):
            _build.reset_launches()
            got, aux_c = t_moe.apply_moe_ffn(cfg, p, x, ParallelContext(
                mesh=mesh, moe_mode="ep", n_parts=n_parts, moe_comm="messages",
                comm_packer="cuda", comm_coalesce=coalesce))
            assert _build.LAUNCHES["copy_convert"] > 0
            assert (_build.LAUNCHES["gather_pack"] > 0) == coalesce
            assert torch.equal(got, want) and torch.equal(aux_c, aux), (n_parts, coalesce)


@pytest.mark.cuda
def test_moe_prefill_and_decode_flash_match_plain_on_the_card(cuda):
    cfg = get_config(NAME).reduced().with_updates(dtype="float32", param_dtype="float32",
                                                   head_dim=64)
    model = build_model(cfg, cuda)
    plain = build_model(cfg, cuda, attention=attention_plain)
    params = model.init(0)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), generator=torch.Generator(cuda).manual_seed(2),
                         device=cuda)
    _build.reset_launches()
    got, cache = model.prefill(params, {"tokens": toks}, model.init_cache(1, 64))
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers
    want, pcache = plain.prefill(params, {"tokens": toks}, plain.init_cache(1, 64))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    tok = want[:, -1:].argmax(-1)
    got, _ = model.decode_step(params, tok, cache)
    want, _ = plain.decode_step(params, tok, pcache)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
