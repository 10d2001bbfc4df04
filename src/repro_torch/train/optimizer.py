"""AdamW with an f32 update, the LR schedule, clipping and gradient
compression (PyTorch port of ``src/repro/train/optimizer.py``).

A tree is a nesting of dicts and lists of tensors, walked as
``jax.tree.leaves`` walks the JAX package's: dict keys in sorted order,
lists in order.  The update math runs in f32 whatever the dtypes of the
parameters (bf16 at full size) and of the moments (``opt_state_dtype``).

Two differences from JAX, neither in a value:

* :func:`adamw_update` writes the new parameters and moments into the
  tensors it is given (under ``torch.no_grad``) and returns those same
  trees: JAX's ``Trainer`` donates the state to its jitted step, the port
  reuses its tensors, which keeps stablelm-1.6b's 19.8 GB of parameters and
  moments from being held twice.
* Weight decay goes to the leaves JAX decays, ``ndim >= 2`` on JAX's
  layout.  JAX stacks each layer's leaves on a leading axis, so a layer's
  norm scale is ``(L, d)`` there and is decayed, while the port keeps one
  dict a layer with a ``(d,)`` scale: a leaf under a stacked subtree
  (``models.convert.STACKS``) counts the stacked axes it lacks.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.plan import tree_map
from repro_torch.models.convert import STACKS

Params = Any


def tree_leaves(tree: Params, path: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """``(path, tensor)`` of every leaf in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], (*path, k))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, t in enumerate(tree) for leaf in tree_leaves(t, (*path, i))]
    return [(path, tree)]


def tree_unflatten(like: Params, leaves: list) -> Params:
    """A tree shaped as ``like`` holding ``leaves`` in :func:`tree_leaves`
    order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    return walk(like)


def stacked_ndim(path: tuple, leaf: torch.Tensor) -> int:
    """The leaf's ndim on JAX's layout: its own plus the stacked axes of its
    subtree (``layers``: 1, ``groups``: 2, ...)."""
    return leaf.dim() + (STACKS.get(path[0], 0) if path else 0)


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree: Params) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for _, x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Params, max_norm: float) -> tuple[Params, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def compress_grads(tree: Params, mode: str, gen: torch.Generator | None = None) -> Params:
    """The wire format of the gradient collectives, applied to the tree.

    ``"bf16"`` casts each leaf to bf16.  ``"int8_stochastic"`` scales each
    leaf by ``max|g| / 127``, adds uniform noise on [-0.5, 0.5), rounds,
    clips to [-127, 127] and scales back, in the leaf's dtype.  The noise
    comes from ``gen`` (a generator seeded 0 on the first leaf's device when
    None, as JAX's ``key(0)``); its bits are not ``jax.random``'s, so only
    the properties hold: an error of at most one scale step, unbiased in the
    mean over seeds."""
    if mode == "none":
        return tree
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), tree)
    if mode == "int8_stochastic":
        leaves = tree_leaves(tree)
        if gen is None and leaves:
            gen = torch.Generator(leaves[0][1].device).manual_seed(0)

        def quantize(g: torch.Tensor) -> torch.Tensor:
            gf = g.float()
            scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
            noise = torch.rand(g.shape, generator=gen, device=g.device) - 0.5
            q = torch.clamp(torch.round(gf / scale + noise), -127, 127)
            return (q * scale).to(g.dtype)

        # leaves in jax.tree order, so the noise stream follows the same walk
        return tree_unflatten(tree, [quantize(g) for _, g in leaves])
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def init_opt_state(params: Params, cfg: OptimizerConfig, state_dtype: str = "float32") -> dict:
    """Zero moments in ``state_dtype`` beside every parameter, and step 0
    (an int32 scalar on the parameters' device)."""
    dt = getattr(torch, state_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0][1].device if leaves else torch.device("cpu")
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(params: Params, grads: Params, opt: dict,
                 cfg: OptimizerConfig) -> tuple[Params, dict, dict]:
    """One AdamW step; returns ``(params, opt_state, metrics)``, the
    parameters and moments updated in place (see the module docstring)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = opt["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    flat_g = [g for _, g in tree_leaves(grads)]
    flat_m = [m for _, m in tree_leaves(opt["m"])]
    flat_v = [v for _, v in tree_leaves(opt["v"])]
    for (path, p), g, m, v in zip(tree_leaves(params), flat_g, flat_m, flat_v, strict=True):
        gf = g.float()
        m32 = m.float() * b1 + gf * (1 - b1)
        v32 = v.float() * b2 + torch.square(gf) * (1 - b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if stacked_ndim(path, p) >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}
