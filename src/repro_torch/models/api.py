"""Model API of the PyTorch port (port of ``src/repro/models/api.py``)::

    model  = build_model(get_config("llama3-8b"))          # the card
    params = model.init(torch.Generator(model.device).manual_seed(0))
    cache  = model.init_cache(batch=8, max_len=1024)
    logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    logits, cache = model.decode_step(params, token, cache)

The dense, moe and rwkv families are ported; the others raise.  A caller
may inject the kernel a family runs: ``attention=`` for the dense and MoE
decoders' prefill attention, ``wkv=`` for the RWKV scan (e.g. their plain versions
for a comparison run on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import resolve_device
from repro_torch.models import moe, rwkv, transformer
from repro_torch.models.layers import AttentionFn
from repro_torch.models.rwkv import WkvFn
from repro_torch.parallel.context import LOCAL, ParallelContext

_FAMILY_MODULES = {"dense": transformer, "moe": moe, "rwkv": rwkv}


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
    def init(self, gen: torch.Generator | int = 0) -> dict:
        """Random parameters on ``self.device`` from a generator on that
        device (or a seed for a new one)."""
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

    def logits(self, params, batch, *, ctx: ParallelContext = LOCAL):
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
        return self.module.prefill(self.cfg, params, batch["tokens"], cache, ctx=ctx, **kw,
                                   **self._kernels())

    def decode_step(self, params, token, cache, *, ctx: ParallelContext = LOCAL):
        kw = {"wkv": self.wkv} if self.cfg.family == "rwkv" else {}
        return self.module.decode_step(self.cfg, params, token, cache, ctx=ctx, **kw)


def build_model(cfg: ModelConfig, device: str | torch.device | None = None, *,
                attention: AttentionFn | None = None, wkv: WkvFn | None = None) -> Model:
    """The model of ``cfg`` on ``device`` (None: the card; a missing card
    raises).  ``attention`` replaces the dense and MoE decoders' local
    attention function, ``wkv`` the RWKV scan, e.g. by ``attention_plain`` or
    ``wkv_plain`` for a comparison run on the card."""
    module = _FAMILY_MODULES.get(cfg.family)
    if module is None:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP Queue 1 item 13")
    return Model(cfg=cfg, module=module, device=resolve_device(device), attention=attention,
                 wkv=wkv)
