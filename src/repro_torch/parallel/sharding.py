"""Sharding rules: parameter, optimizer, batch and cache partition specs
per family (PyTorch port of ``src/repro/parallel/sharding.py``).

Pure functions over shapes: a leaf is anything with a ``.shape`` (a meta
tensor at full width costs nothing), and a spec is a :class:`P`, a tuple
with one entry per axis (a mesh-axis name, a tuple of names, or ``None``)
over a :class:`~repro_torch.core.mesh.VirtualMesh` (or any mesh whose
``.shape`` maps axis names to sizes).

The rules are JAX's, name-based over the tree paths.  They are computed on
the JAX layout of each leaf and then mapped onto the port's, because the
two layouts differ (:mod:`repro_torch.models.convert`):

* the port keeps one dict a layer where JAX stacks them on leading axes,
  so a spec of a leaf under a stacked subtree (``layers``, ``groups``, ...)
  begins with the entries of the stacked axes JAX has and the port's leaf
  does not (ZeRO-1's "first divisible replicated dim" may be one of them:
  llama3-8b's 32 layers split over 16 data ranks);
* the port stores a weight matrix ``(out, in)`` where JAX stores ``(in,
  out)``, so the entries of its two axes swap: JAX's column-parallel rule
  shards dim ``ndim - 1``, the port's dim 0.

So ``param_pspecs`` of the port's tree, with each leaf's stacked entries
joined over its layers and its matrix entries swapped back, equals JAX's
``param_pspecs`` of the JAX tree, and the same for the others.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import STACKS, _is_matrix

# param-name -> (which dim gets the model axis, counted from the END of the
# JAX layout): col-parallel the last dim, row-parallel the second-to-last
_COL_PARALLEL = {
    "wq", "wk", "wv", "wg", "wr", "w_gate", "w_up", "in_proj", "ck", "cr",
    "head", "w_lora_a",
}
_ROW_PARALLEL = {"wo", "w_down", "out_proj", "cv"}
_VOCAB_SHARDED = {"embed", "lm_head"}
_SLOT_SHARDED = {"moe/w_gate", "moe/w_up", "moe/w_down"}  # slot dim = model


class P(tuple):
    """A ``PartitionSpec`` stand-in: ``P("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _mesh_size(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _walk(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a nesting of dicts and lists (a :class:`P` is
    a leaf); ``path`` holds the dict keys and list indices down to it."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _jax_view(cfg: ModelConfig, path: tuple, leaf) -> tuple[str, str, tuple, int, bool]:
    """The leaf as the JAX tree holds it: ``(path string, leaf name, shape,
    stacked axes, transposed)``; the stacked axes take their sizes from the
    lists the port keeps (``path``'s indices into them are dropped)."""
    depth = STACKS.get(path[0], 0)
    names = tuple(k for k in path if isinstance(k, str))
    below = names[1:] if depth else names
    shape = tuple(leaf.shape)
    swap = len(shape) == 2 and _is_matrix(cfg, below)
    if swap:
        shape = shape[::-1]
    return "/".join(names), names[-1], shape, depth, swap


def _stack_sizes(params: Any, path: tuple, depth: int) -> tuple[int, ...]:
    node, sizes = params[path[0]], []
    for _ in range(depth):
        sizes.append(len(node))
        node = node[0]
    return tuple(sizes)


def _to_port(entries: list, depth: int, swap: bool) -> P:
    """A spec on the JAX layout (stacked axes first) as the port's leaf
    takes it: the stacked entries kept first, a matrix's two swapped."""
    stack, leaf = entries[:depth], entries[depth:]
    return P(*stack, *(leaf[::-1] if swap else leaf))


def _to_jax(spec: P, depth: int, swap: bool) -> list:
    stack, leaf = list(spec[:depth]), list(spec[depth:])
    return stack + (leaf[::-1] if swap else leaf)


def _spec_for(pstr: str, name: str, shape: tuple, model_axis: str, model_size: int,
              fsdp_stacks: tuple | None = None) -> list:
    """JAX's rule for one leaf of the JAX layout."""
    ndim = len(shape)
    spec: list[Any] = [None] * ndim

    def fits(dim_idx: int) -> bool:
        return 0 <= dim_idx < ndim and shape[dim_idx] % model_size == 0

    if any(f"moe/{name}" in s for s in _SLOT_SHARDED) and "moe" in pstr:
        # slot-stacked expert weights: (.., S_slots, d, f), slot dim = model
        dim = ndim - 3
        if fits(dim):
            spec[dim] = model_axis
            # FSDP option (grok): layer-stack dim over the data axes too
            if fsdp_stacks is not None and dim > 0:
                data_axes, data_size = fsdp_stacks
                if shape[0] % data_size == 0 and shape[0] >= data_size:
                    spec[0] = data_axes if len(data_axes) > 1 else data_axes[0]
            return spec
    if name in _VOCAB_SHARDED:
        if fits(ndim - 2):
            spec[ndim - 2] = model_axis
        return spec
    if name in _COL_PARALLEL and ndim >= 2:
        if fits(ndim - 1):
            spec[ndim - 1] = model_axis
        return spec
    if name in _ROW_PARALLEL and ndim >= 2:
        if fits(ndim - 2):
            spec[ndim - 2] = model_axis
        return spec
    return spec  # replicated (norms, biases, small projections)


def param_pspecs(params: Any, *, cfg: ModelConfig, model_axis: str = "model",
                 model_size: int = 1, fsdp_experts: bool = False,
                 data_axes: tuple[str, ...] = ("data",), mesh: Any = None) -> Any:
    """A spec tree matching the port's ``params`` of ``cfg``."""
    fsdp_stacks = None
    if fsdp_experts and mesh is not None:
        fsdp_stacks = (data_axes, _mesh_size(mesh, data_axes))

    def spec(path, leaf):
        pstr, name, shape, depth, swap = _jax_view(cfg, path, leaf)
        shape = _stack_sizes(params, path, depth) + shape
        return _to_port(_spec_for(pstr, name, shape, model_axis, model_size, fsdp_stacks),
                        depth, swap)

    return _walk(spec, params)


def zero1_pspecs(params: Any, pspecs: Any, *, cfg: ModelConfig, data_axes: tuple[str, ...],
                 mesh: Any) -> Any:
    """Optimizer-moment specs: the param spec plus the first divisible
    replicated dim of the JAX layout over the (flattened) data axes."""
    data_size = _mesh_size(mesh, data_axes)
    flat_specs: dict[tuple, P] = {}
    _walk(lambda path, s: flat_specs.__setitem__(path, s), pspecs)

    def upgrade(path, leaf) -> P:
        _, _, shape, depth, swap = _jax_view(cfg, path, leaf)
        shape = _stack_sizes(params, path, depth) + shape
        spec = flat_specs[path]
        entries = _to_jax(spec, depth, swap)
        entries += [None] * (len(shape) - len(entries))
        # already data-sharded (e.g. FSDP expert stacks): nothing to add
        used = {a for e in entries for a in (e if isinstance(e, tuple) else (e,))
                if a is not None}
        if used.intersection(data_axes):
            return _to_port(entries, depth, swap)
        for i in range(len(shape)):
            if entries[i] is None and shape[i] % data_size == 0 and shape[i] >= data_size:
                entries[i] = data_axes if len(data_axes) > 1 else data_axes[0]
                break
        return _to_port(entries, depth, swap)

    return _walk(upgrade, params)


def batch_pspecs(batch: Any, *, data_axes: tuple[str, ...], mesh: Any = None) -> Any:
    """Batch dim over the data axes (when divisible), else replicated."""
    da = data_axes if len(data_axes) > 1 else data_axes[0]
    dsize = _mesh_size(mesh, data_axes) if mesh is not None else 1

    def spec(leaf) -> P:
        ndim = len(leaf.shape)
        if ndim == 0:
            return P()
        if mesh is not None and leaf.shape[0] % dsize != 0:
            return P(*([None] * ndim))  # e.g. batch-1 long-context cells
        return P(da, *([None] * (ndim - 1)))

    return _walk(lambda _, leaf: spec(leaf), batch)


def cache_pspecs(cache: Any, *, data_axes: tuple[str, ...], model_axis: str = "model",
                 model_size: int = 1, mesh: Any = None) -> Any:
    """KV/state caches (the port keeps JAX's layouts: ``(L, B, S, Hkv, hd)``,
    ``(L, B, ...state)``, scalars): the batch dim, right after the leading
    stack dims, over data; the last dim past it that divides over model."""
    da = data_axes if len(data_axes) > 1 else data_axes[0]
    dsize = _mesh_size(mesh, data_axes) if mesh is not None else 1

    def spec(leaf) -> P:
        shape = tuple(leaf.shape)
        if len(shape) <= 1:
            return P()
        entries: list[Any] = [None] * len(shape)
        # (L, B, ...) layouts: dim 1; (G, gs, B, ...): dim 2
        bdim = 2 if len(shape) >= 5 and shape[0] <= 16 and shape[1] <= 16 else 1
        if mesh is None or shape[bdim] % dsize == 0:
            entries[bdim] = da
        # model axis preference: head_dim (last), then heads, then seq
        for i in range(len(shape) - 1, bdim, -1):
            if shape[i] % model_size == 0 and shape[i] >= model_size:
                entries[i] = model_axis
                break
        return P(*entries)

    return _walk(lambda _, leaf: spec(leaf), cache)
