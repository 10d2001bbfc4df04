"""Carry model parameters between the JAX package and the port.

The JAX tree (``repro.models.transformer.init`` or ``repro.models.rwkv.
init``, as numpy arrays) stacks the layers on a leading axis and stores
weights ``(in, out)``.  The dense decoder's tree::

    {"embed": (V, d), "norm_f": {...}, ["lm_head": (V, d)],
     "layers": {"norm_attn": {"scale": (L, d), ["bias"]},
                "attn": {"wq": (L, d, Hq*hd), "wk", "wv": (L, d, Hkv*hd),
                         "wo": (L, Hq*hd, d), ["bq", "bk", "bv": (L, n)]},
                "norm_mlp": {...},
                "mlp": {"w_gate", "w_up": (L, d, f), "w_down": (L, f, d)}}}

The RWKV tree mixes arrays and dicts in ``layers`` and has a top-level
``ln_in``::

    {"embed": (V, d), "ln_in": {...}, "norm_f": {...}, "lm_head": (V, d),
     "layers": {"ln1": {"scale", "bias": (L, d)}, "ln2": {...},
                "mu": (L, 5, d), "mu_c": (L, 2, d), "w_base": (L, d),
                "u": (L, H, hd), "wr", "wk", "wv", "wg", "wo": (L, d, d),
                "w_lora_a": (L, d, r), "w_lora_b": (L, r, d),
                "ck": (L, d, f), "cv": (L, f, d), "cr": (L, d, d)}}

The port keeps one dict per layer and ``nn.Linear`` weights ``(out, in)``.
So :func:`params_from_jax` splits the leading axis of ``layers`` and
transposes each family's weight matrices: in the dense tree every leaf named
``w*``, in the RWKV tree the set :data:`RWKV_MATRICES` (``w_base`` is a
vector, ``ck``/``cv``/``cr`` are matrices).  Embeddings, norms, biases,
mixes and the bonus keep their layout.  :func:`params_to_numpy` is the
inverse.  bf16 arrays (ml_dtypes ``bfloat16``) cross as their 16-bit
patterns, exactly; :func:`params_to_numpy` names that type through numpy
(``np.dtype("bfloat16")``), so a process without ml_dtypes loaded cannot
take bf16 leaves out.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compat import resolve_device


#: the weight matrices of an RWKV layer (stored transposed in the port)
RWKV_MATRICES = frozenset({"wr", "wk", "wv", "wg", "wo", "w_lora_a", "w_lora_b",
                           "ck", "cv", "cr"})


def _is_matrix(cfg: ModelConfig, name: str) -> bool:
    if cfg.family == "rwkv":
        return name in RWKV_MATRICES
    return name.startswith("w")


def _to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # the bf16 numpy type that ml_dtypes registers by name, loaded by
        # any JAX consumer of the tree (the port never imports it)
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def _layer_from_jax(cfg: ModelConfig, tree: dict, i: int, dev: torch.device) -> dict:
    """Layer ``i`` of a stacked subtree, matrices transposed."""
    return {name: (_layer_from_jax(cfg, a, i, dev) if isinstance(a, dict)
                   else _to_torch(a[i].T if _is_matrix(cfg, name) else a[i], dev))
            for name, a in tree.items()}


def _stack_to_numpy(cfg: ModelConfig, name: str, items: list):
    """The stacked JAX subtree of one entry of every layer."""
    if isinstance(items[0], dict):
        return {key: _stack_to_numpy(cfg, key, [it[key] for it in items]) for key in items[0]}
    return np.stack([_to_numpy(t.T if _is_matrix(cfg, name) else t) for t in items])


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def params_from_jax(cfg: ModelConfig, tree: dict, device: str | torch.device | None = None) -> dict:
    """The port's parameters from the JAX package's parameter tree of numpy
    arrays, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    out = {name: _map_tree(lambda a: _to_torch(a, dev), sub)
           for name, sub in tree.items() if name != "layers"}
    out["layers"] = [_layer_from_jax(cfg, tree["layers"], i, dev) for i in range(cfg.n_layers)]
    return out


def params_to_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The JAX package's parameter tree (numpy arrays) of the port's
    parameters: the inverse of :func:`params_from_jax`."""
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer config")
    tree = {name: _map_tree(_to_numpy, sub) for name, sub in params.items() if name != "layers"}
    tree["layers"] = _stack_to_numpy(cfg, "layers", layers)
    return tree
