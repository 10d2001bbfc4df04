"""Model API of the PyTorch port (port of ``src/repro/models/api.py``)::

    model  = build_model(get_config("llama3-8b"))          # the card
    params = model.init(torch.Generator(model.device).manual_seed(0))
    cache  = model.init_cache(batch=8, max_len=1024)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    logits, cache = model.decode_step(params, token, cache)
    loss   = model.loss(params, {"tokens": tokens, "labels": labels})

Every family of the JAX package is ported: dense, moe, rwkv, hybrid (and
``ssm``, which maps to hybrid as in JAX), vlm and audio; an unknown family
raises.  The vlm family takes ``batch["vision_emb"]`` beside the tokens,
the audio family ``batch["frames"]`` (``logits`` is its ``encode``; it has
no cache or decode).  A caller may inject the kernel a family runs:
``attention=`` for the local attention of every family but rwkv (its
prefill's, and the VLM's cross attention), ``wkv=`` for the RWKV scan
(e.g. their plain versions for a comparison run on the card).  ``loss``
serves every family: on the card the attention's backward is the
hand-written flash backward kernel, the RWKV scan's the WKV backward
kernel.  ``build_model(cfg, "meta")`` runs every step on meta tensors
(shapes and dtypes only; the kernels' meta routes), and
:func:`batch_spec` gives a cell's inputs there (the dry-run);
:func:`concrete_batch` a random batch of the same keys on a real device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.compat import resolve_device
from repro_torch.models import encoder, hybrid, moe, rwkv, transformer, vision
from repro_torch.models.layers import META, AttentionFn
from repro_torch.models.rwkv import WkvFn
from repro_torch.parallel.context import LOCAL, ParallelContext

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": moe,
    "rwkv": rwkv,
    "ssm": hybrid,  # a pure-ssm arch would be a mamba-only stack; zamba covers it, as in JAX
    "hybrid": hybrid,
    "vlm": vision,
    "audio": encoder,
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    module: Any
    device: torch.device
    #: local attention on (B, S, H, D); None is ``ops.attention`` (the CUDA
    #: flash kernel on the card, the plain version on the CPU)
    attention: AttentionFn | None = None
    #: the RWKV scan on (B, T, H, hd); None is ``kernels.wkv.ops.wkv`` (the
    #: CUDA kernel on the card, the plain version on the CPU)
    wkv: WkvFn | None = None

    # -- params ---------------------------------------------------------------
    def init(self, gen: torch.Generator | int | str = 0) -> dict:
        """Random parameters on ``self.device`` from a generator on that
        device (or a seed for a new one); ``"meta"`` gives every parameter
        as a meta tensor of its shape and dtype (``jax.eval_shape(init)``)."""
        if gen == "meta":
            return self.module.init(self.cfg, META)
        if isinstance(gen, int):
            gen = torch.Generator(self.device).manual_seed(gen)
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        return self.module.init(self.cfg, gen)

    # -- steps ------------------------------------------------------------------
    def _kernels(self) -> dict:
        """The injected kernel function of this family, by keyword."""
        if self.cfg.family == "rwkv":
            return {"wkv": self.wkv}
        return {"attention": self.attention}

    def loss(self, params, batch, *, ctx: ParallelContext = LOCAL):
        """The training loss of ``batch``: ``tokens`` and ``labels`` (audio:
        ``frames`` and ``labels``), ``vision_emb`` for the vlm family, an
        optional ``mask``."""
        return self.module.loss_fn(self.cfg, params, batch, ctx=ctx, **self._kernels())

    def logits(self, params, batch, *, ctx: ParallelContext = LOCAL):
        if self.cfg.family == "vlm":
            return self.module.logits_fn(self.cfg, params, batch["tokens"], batch["vision_emb"],
                                         ctx=ctx, **self._kernels())
        if self.cfg.family == "audio":
            return self.module.encode(self.cfg, params, batch["frames"], ctx=ctx,
                                      **self._kernels())
        return self.module.logits_fn(self.cfg, params, batch["tokens"], ctx=ctx,
                                     **self._kernels())

    @property
    def has_decode(self) -> bool:
        return not self.cfg.is_encoder_only

    def init_cache(self, batch: int, max_len: int, dtype=None, *, device=None) -> dict:
        """``device`` defaults to the model's; ``"meta"`` gives shapes only."""
        return self.module.init_cache(self.cfg, batch, max_len, dtype,
                                      device=self.device if device is None else device)

    def prefill(self, params, batch, cache, *, ctx: ParallelContext = LOCAL, true_len=None):
        # true_len ((B,) int32): bucket-padded prefill, which only the dense
        # decoder has; it is passed on only when given, as in JAX
        kw = {} if true_len is None else {"true_len": true_len}
        if self.cfg.family == "vlm":
            if true_len is not None:
                raise ValueError("the vlm prefill has no bucketed form")
            return self.module.prefill(self.cfg, params, batch["tokens"], batch["vision_emb"],
                                       cache, ctx=ctx, **self._kernels())
        return self.module.prefill(self.cfg, params, batch["tokens"], cache, ctx=ctx, **kw,
                                   **self._kernels())

    def decode_step(self, params, token, cache, *, ctx: ParallelContext = LOCAL):
        kw = {"wkv": self.wkv} if self.cfg.family == "rwkv" else {}
        return self.module.decode_step(self.cfg, params, token, cache, ctx=ctx, **kw)


def batch_spec(cfg: ModelConfig, shape: ShapeConfig, device: str | torch.device = "meta"
               ) -> dict[str, torch.Tensor]:
    """Stand-ins for one workload cell's inputs (JAX's ``batch_spec``: the
    same keys, shapes and dtypes per family), empty tensors on ``device``:
    ``tokens`` and ``labels`` int32 ``(B, S)``; audio ``frames`` bf16 ``(B,
    S, d_vision)``, ``labels`` and an f32 ``mask`` in their place; vlm
    ``vision_emb`` bf16 ``(B, vision_tokens, d_vision)`` beside them."""
    b, s = shape.global_batch, shape.seq_len

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if cfg.family == "audio":
        return {"frames": empty((b, s, cfg.d_vision), torch.bfloat16),
                "labels": empty((b, s), torch.int32),
                "mask": empty((b, s), torch.float32)}
    spec = {"tokens": empty((b, s), torch.int32), "labels": empty((b, s), torch.int32)}
    if cfg.family == "vlm":
        spec["vision_emb"] = empty((b, cfg.vision_tokens, cfg.d_vision), torch.bfloat16)
    return spec


def concrete_batch(cfg: ModelConfig, shape_or_bs: ShapeConfig | int, seq: int | None = None,
                   seed: int = 0, *, device: str | torch.device | None = None
                   ) -> dict[str, torch.Tensor]:
    """A random batch of :func:`batch_spec`'s keys, shapes and dtypes on
    ``device`` (None: the card), for a cell's ``shape`` or a batch size and
    ``seq`` (JAX's ``concrete_batch``): ``tokens`` and ``labels`` uniform
    in ``[0, vocab_size)``; audio ``frames`` standard normal rounded to bf16
    and a ``mask`` of ones at 30 % of the positions; vlm ``vision_emb``
    standard normal in bf16.  Drawn from a ``torch.Generator(seed)`` on the
    device, so the values are not JAX's."""
    if isinstance(shape_or_bs, ShapeConfig):
        b, s = shape_or_bs.global_batch, shape_or_bs.seq_len
    else:
        b, s = shape_or_bs, seq
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)

    def tokens():
        return torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev,
                             dtype=torch.int32)

    def normal(shp):
        return torch.randn(shp, generator=gen, device=dev).to(torch.bfloat16)

    if cfg.family == "audio":
        frames, labels = normal((b, s, cfg.d_vision)), tokens()
        mask = (torch.rand((b, s), generator=gen, device=dev) < 0.3).to(torch.float32)
        return {"frames": frames, "labels": labels, "mask": mask}
    out = {"tokens": tokens(), "labels": tokens()}
    if cfg.family == "vlm":
        out["vision_emb"] = normal((b, cfg.vision_tokens, cfg.d_vision))
    return out


def build_model(cfg: ModelConfig, device: str | torch.device | None = None, *,
                attention: AttentionFn | None = None, wkv: WkvFn | None = None) -> Model:
    """The model of ``cfg`` on ``device`` (None: the card; a missing card
    raises).  ``attention`` replaces the local attention function of every
    family but rwkv, ``wkv`` the RWKV scan, e.g. by ``attention_plain`` or
    ``wkv_plain`` for a comparison run on the card."""
    module = _FAMILY_MODULES.get(cfg.family)
    if module is None:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); the families are "
                         f"{sorted(_FAMILY_MODULES)}")
    return Model(cfg=cfg, module=module, device=resolve_device(device), attention=attention,
                 wkv=wkv)
