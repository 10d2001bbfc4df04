"""Carry model parameters between the JAX package and the port.

The JAX tree (the ``init`` of a model of ``repro.models``, as numpy
arrays) stacks the layers on leading axes and stores weights ``(in,
out)``.  The dense decoder's tree::

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

The MoE tree is the dense one with ``moe`` in place of ``mlp``::

     "layers": {..., "moe": {"router": (L, d, E),
                             "w_gate", "w_up": (L, S, d, fs),
                             "w_down": (L, S, fs, d)}}

The zamba2 hybrid stacks its mamba layers twice (groups) and once (the
tail), and keeps one shared block unstacked::

    {"embed": (V, d), "norm_f": {...}, "lm_head": (V, d),
     "groups": {"norm": {"scale": (G, g, d)}, "in_proj": (G, g, d, di+ch+nh),
                "conv_w": (G, g, k, ch), "conv_b": (G, g, ch),
                "A_log", "D", "dt_bias": (G, g, nh), "norm_y": {"scale": (G, g, di)},
                "out_proj": (G, g, di, d)},
     "tail": {... the same, (n_tail, ...)},
     "shared": {"pre_proj": (2d, d), "norm_attn": {...}, "attn": {"wq", ...},
                "norm_mlp": {...}, "mlp": {"w_gate", "w_up", "w_down"}}}

``in_proj``/``out_proj`` are matrices whose names do not start with ``w``;
``conv_w`` is a depthwise kernel, not a product, and keeps its layout.  The
VLM stacks its self layers twice and its cross layers once, beside a
top-level matrix ``vision_proj`` (d_vision, d)::

    {"embed", "norm_f", "lm_head", "vision_proj": (dv, d),
     "self_groups": {... the dense layer, (G, n_self, ...)},
     "cross": {"norm_attn", "norm_mlp": {...}, "mlp": {...},
               "xattn": {"wq", "wk", "wv", "wo": (G, ...), "gate_attn",
                         "gate_ffn": (G, 1), "q_norm", "k_norm": (G, hd)}}}

The encoder is the dense tree without embeddings, with the matrices
``frame_proj`` (d_vision, d) and ``head`` (d, V) (not ``(V, d)`` as
``lm_head``) and the vector ``mask_emb`` (d,).

The port keeps one dict per layer (a list of per-layer dicts for a stack,
a list of such lists for a stack of groups) and ``nn.Linear`` weights
``(out, in)``.  So :func:`params_from_jax` splits the leading axes of the
stacked subtrees (:data:`STACKS`) and transposes each family's weight
matrices: every leaf named ``w*`` or in :data:`NAMED_MATRICES`, in the
RWKV tree the set :data:`RWKV_MATRICES` (``w_base`` is a vector,
``ck``/``cv``/``cr`` are matrices), in the MoE tree the attention's
``w*``.  The MoE leaves keep the JAX layout, ``(in, out)`` (the router
``(d, E)``, the slot stacks ``(S, in, out)``), which ``repro_torch.models.
moe`` applies in batched products.  Embeddings, norms, biases, gates,
mixes, the bonus and the conv kernel keep their layout.
:func:`params_to_numpy` is the inverse.  :func:`train_state_from_jax` and
:func:`train_state_to_numpy` carry a train state (``{"params", "opt": {"m",
"v", "step"}}``): the moments are laid out as the parameters, the step is
an int32 scalar.  bf16 arrays (ml_dtypes
``bfloat16``) cross as their 16-bit patterns, exactly;
:func:`params_to_numpy` names that type through numpy
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
#: weight matrices whose names do not start with ``w`` (the mamba
#: projections, the hybrid's shared down-projection, the VLM's and the
#: encoder's input projections and the encoder's head)
NAMED_MATRICES = frozenset({"in_proj", "out_proj", "pre_proj", "vision_proj", "frame_proj",
                            "head"})
#: the stacked subtrees of the JAX trees and their number of stacked axes
STACKS = {"layers": 1, "groups": 2, "tail": 1, "self_groups": 2, "cross": 1}


def _is_matrix(cfg: ModelConfig, path: tuple[str, ...]) -> bool:
    """Whether the leaf at ``path`` (keys below the stacked subtree, or
    from the root outside one) is stored transposed in the port."""
    if cfg.family == "rwkv":
        return path[-1] in RWKV_MATRICES
    if cfg.family == "moe" and path[0] == "moe":
        return False  # the MoE leaves keep the JAX layout
    return path[-1].startswith("w") or path[-1] in NAMED_MATRICES


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


def _from_jax(cfg: ModelConfig, a, idx: tuple, dev: torch.device, path: tuple[str, ...]):
    """Entry ``idx`` of a stacked subtree or leaf ``a`` (``idx = ()``: an
    unstacked one), matrices transposed."""
    if isinstance(a, dict):
        return {name: _from_jax(cfg, sub, idx, dev, (*path, name)) for name, sub in a.items()}
    a = np.asarray(a)[idx]
    return _to_torch(a.T if _is_matrix(cfg, path) else a, dev)


def _to_jax(cfg: ModelConfig, path: tuple[str, ...], items: list):
    """The stacked JAX subtree or leaf of one entry of every layer."""
    if isinstance(items[0], dict):
        return {key: _to_jax(cfg, (*path, key), [it[key] for it in items]) for key in items[0]}
    return np.stack([_to_numpy(t.T if _is_matrix(cfg, path) else t) for t in items])


def _stacked_shape(tree) -> tuple[int, ...]:
    """The shape of a subtree's first leaf, whose leading axes are the
    stacked ones."""
    return _stacked_shape(next(iter(tree.values()))) if isinstance(tree, dict) else tree.shape


def params_from_jax(cfg: ModelConfig, tree: dict, device: str | torch.device | None = None) -> dict:
    """The port's parameters from the JAX package's parameter tree of numpy
    arrays, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    out = {}
    for name, sub in tree.items():
        depth = STACKS.get(name, 0)
        if depth == 0:
            out[name] = _from_jax(cfg, sub, (), dev, (name,))
        elif depth == 1:
            out[name] = [_from_jax(cfg, sub, (i,), dev, ()) for i in range(_stacked_shape(sub)[0])]
        else:
            n, m = _stacked_shape(sub)[:2]
            out[name] = [[_from_jax(cfg, sub, (i, j), dev, ()) for j in range(m)]
                         for i in range(n)]
    if "layers" in out and len(out["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(out['layers'])} layers for a {cfg.n_layers}-layer config")
    return out


def params_to_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The JAX package's parameter tree (numpy arrays) of the port's
    parameters: the inverse of :func:`params_from_jax`."""
    if "layers" in params and len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params['layers'])} layers for a {cfg.n_layers}-layer config")
    tree = {}
    for name, sub in params.items():
        depth = STACKS.get(name, 0)
        if depth == 0:  # one entry: stacked on a unit axis, then taken off it
            tree[name] = _map_tree(lambda a: a[0], _to_jax(cfg, (name,), [sub]))
        elif depth == 1:
            tree[name] = _to_jax(cfg, (), sub)
        else:  # the groups' layers stacked in order, then split into groups
            n, m = len(sub), len(sub[0])
            tree[name] = _map_tree(lambda a: a.reshape(n, m, *a.shape[1:]),
                                   _to_jax(cfg, (), [lp for g in sub for lp in g]))
    return tree


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def train_state_from_jax(cfg: ModelConfig, state: dict,
                         device: str | torch.device | None = None) -> dict:
    """The port's train state from the JAX package's (numpy arrays): the
    parameters and both AdamW moments through :func:`params_from_jax`, the
    step as an int32 scalar tensor, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    opt = state["opt"]
    return {"params": params_from_jax(cfg, state["params"], dev),
            "opt": {"m": params_from_jax(cfg, opt["m"], dev),
                    "v": params_from_jax(cfg, opt["v"], dev),
                    "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                                         device=dev)}}


def train_state_to_numpy(cfg: ModelConfig, state: dict) -> dict:
    """The JAX package's train state (numpy arrays) of the port's: the
    inverse of :func:`train_state_from_jax`."""
    opt = state["opt"]
    return {"params": params_to_numpy(cfg, state["params"]),
            "opt": {"m": params_to_numpy(cfg, opt["m"]), "v": params_to_numpy(cfg, opt["v"]),
                    "step": np.asarray(int(opt["step"]), dtype=np.int32)}}
