"""Carry dense-transformer parameters between the JAX package and the port.

The JAX tree (``repro.models.transformer.init``, as numpy arrays) stacks the
layers on a leading axis and stores weights ``(in, out)``::

    {"embed": (V, d), "norm_f": {...}, ["lm_head": (V, d)],
     "layers": {"norm_attn": {"scale": (L, d), ["bias"]},
                "attn": {"wq": (L, d, Hq*hd), "wk", "wv": (L, d, Hkv*hd),
                         "wo": (L, Hq*hd, d), ["bq", "bk", "bv": (L, n)]},
                "norm_mlp": {...},
                "mlp": {"w_gate", "w_up": (L, d, f), "w_down": (L, f, d)}}}

The port keeps one dict per layer and ``nn.Linear`` weights ``(out, in)``.
So :func:`params_from_jax` splits the leading axis and transposes every
weight matrix (a leaf named ``w*``); embeddings, norms and biases keep their
layout.  :func:`params_to_numpy` is the inverse.  bf16 arrays (ml_dtypes
``bfloat16``) cross as their 16-bit patterns, exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import resolve_device


def _is_matrix(name: str) -> bool:
    return name.startswith("w")


def _to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the JAX package's bf16 numpy type

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(cfg: ModelConfig, tree: dict, device: str | torch.device | None = None) -> dict:
    """The port's parameters from the JAX package's parameter tree of numpy
    arrays, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    layers = tree["layers"]
    out = {
        "embed": _to_torch(tree["embed"], dev),
        "norm_f": {k: _to_torch(a, dev) for k, a in tree["norm_f"].items()},
        "layers": [
            {group: {name: _to_torch(a[i].T if _is_matrix(name) else a[i], dev)
                     for name, a in leaves.items()}
             for group, leaves in layers.items()}
            for i in range(cfg.n_layers)
        ],
    }
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], dev)
    return out


def params_to_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The JAX package's parameter tree (numpy arrays) of the port's
    parameters: the inverse of :func:`params_from_jax`."""
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
    tree = {
        "embed": _to_numpy(params["embed"]),
        "norm_f": {k: _to_numpy(t) for k, t in params["norm_f"].items()},
        "layers": {
            group: {name: np.stack([_to_numpy(lp[group][name].T if _is_matrix(name)
                                              else lp[group][name]) for lp in layers])
                    for name in leaves}
            for group, leaves in layers[0].items()
        },
    }
    if "lm_head" in params:
        tree["lm_head"] = _to_numpy(params["lm_head"])
    return tree
