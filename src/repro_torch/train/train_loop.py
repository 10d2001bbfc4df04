"""Training loop: the step factory and the fault-tolerant driver (PyTorch
port of ``src/repro/train/train_loop.py``).

The JAX step is one jitted program; the port's runs eagerly: the loss's
backward through autograd (on the card the attention's backward is the
hand-written ``flash_attention_bwd`` kernel, the RWKV scan's
``wkv_chunked_bwd``), then the f32 AdamW update in place under
``torch.no_grad``.  Every family trains; a batch carries the family's
keys (``SyntheticLM``: audio ``frames`` and ``mask``, vlm ``vision_emb``),
and the microbatch split slices each of them.  Capturing the step as a CUDA graph is
ROADMAP Queue 1 item 22.

On a mesh (``ctx.mesh``, a one-process :class:`~repro_torch.core.mesh.
VirtualMesh` over ``(*ctx.data_axes, ctx.model_axis)``) the state lives in
the stacked layout of :func:`state_pspecs` (:func:`stacked_specs`) and the
step is the data-parallel, ZeRO-1 program that GSPMD makes of JAX's step,
written out: each data rank gathers its parameters over the model axis,
takes its rows' gradients, the gradients are reduce-scattered over the
data axes onto the moments' layout by the stacked-rank collectives of
:mod:`repro_torch.core.partitioned` (``ctx.n_parts`` partitions each),
clipped by the global norm over every rank's shard, AdamW updates each
rank's shards, and the new parameters are all-gathered over the data axes.
Parameters split over the data axes on a stacked layer axis (FSDP, JAX's
``param_pspecs(..., fsdp_experts=True)`` on the slot-stacked expert
weights) live on their layer's data rank, as ZeRO-1's moments of a split
layer axis do: each data rank all-gathers them over the data axes before
its pass, and they are updated where they live and not gathered after.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.core import transport
from repro_torch.core.comm_analysis import counting, repeated
from repro_torch.core.compat import torch_dtype
from repro_torch.core.mesh import VirtualMesh, make_mesh
from repro_torch.core.partitioned import (
    partitioned_psum,
    partitioned_psum_scatter,
    ring_all_gather,
)
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models.api import Model
from repro_torch.models.convert import STACKS
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.context import LOCAL, ParallelContext
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (
    FailureInjector,
    Pinned,
    SimulatedFailure,
    StragglerMonitor,
    _from_stacked,
    _map_specs,
    _names,
    _to_stacked,
    reshard_state,
)
from repro_torch.train.optimizer import (
    adamw_update,
    compress_grads,
    init_opt_state,
    lr_schedule,
    stacked_ndim,
    tree_leaves,
    tree_unflatten,
)

log = logging.getLogger("repro_torch.train")

TrainState = dict  # {"params": ..., "opt": {"m", "v", "step"}}


def make_train_step(model: Model, opt_cfg: OptimizerConfig, ctx: ParallelContext = LOCAL,
                    microbatches: int = 1, *, shardings: Any | None = None) -> Callable:
    """``(state, batch) -> (state, metrics)``; the state's tensors are
    updated in place and returned.

    ``microbatches > 1`` takes each equal batch slice's gradients with
    ``torch.autograd.grad`` and adds them into accumulators of
    ``model.cfg.grad_accum_dtype``, then divides and casts to the parameter
    dtype, as JAX's scan does (``.backward()`` into ``.grad`` would
    accumulate in the parameter dtype instead).  With ``ctx.mesh`` set the
    state is in the mesh's stacked layout and the step is the mesh step
    (the module docstring; :func:`_mesh_step`), ``microbatches`` slices of
    each data rank's rows, the state laid out as ``shardings`` says (a
    spec tree of :func:`state_pspecs`'s form, its result by default; the
    step's ``placed`` attribute is it on each leaf's own axes)."""
    if ctx.mesh is not None:
        return _mesh_step(model, opt_cfg, ctx, microbatches, shardings)
    accum_dtype = torch_dtype(model.cfg.grad_accum_dtype)

    def grad_fn(leaves: list, params, batch) -> tuple[torch.Tensor, tuple]:
        loss = model.loss(params, batch, ctx=ctx)
        grads = torch.autograd.grad(loss, leaves)  # a leaf cut off from the loss raises
        return loss.detach(), grads

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state["params"]
        leaves = [p.requires_grad_(True) for _, p in tree_leaves(params)]
        if microbatches <= 1:
            loss, grads = grad_fn(leaves, params, batch)
        else:
            micro = [{k: v[i * (v.shape[0] // microbatches):(i + 1) * (v.shape[0] // microbatches)]
                      for k, v in batch.items()} for i in range(microbatches)]
            g_sum = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
            l_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for mb in micro:
                l, g = grad_fn(leaves, params, mb)
                for a, b in zip(g_sum, g):
                    a.add_(b)  # b converted to the accumulator's dtype, then added
                l_sum = l_sum + l
                del g
            grads = [(g / microbatches).to(p.dtype) for g, p in zip(g_sum, leaves)]
            del g_sum
            loss = l_sum / microbatches
        grads = compress_grads(tree_unflatten(params, list(grads)), opt_cfg.grad_compression)
        params, opt, metrics = adamw_update(params, grads, state["opt"], opt_cfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return step


def microbatches_of(cfg: ModelConfig, shape: ShapeConfig, data_size: int = 1) -> int:
    """The step's gradient accumulation (JAX's ``launch/dryrun.
    _microbatches``): ``cfg.train_microbatches``, cut until each microbatch
    of the global batch splits evenly over ``data_size`` data ranks.  Where
    none does (a batch the data axes do not divide, which every data rank
    then holds whole), 1: JAX's loop runs on to a division by zero there."""
    if shape.kind != "train" or cfg.train_microbatches <= 1:
        return 1
    gb = shape.global_batch
    mb = min(cfg.train_microbatches, max(1, gb // data_size))
    while mb > 1 and (gb % mb or (gb // mb) % data_size):
        mb -= 1
    return mb


# ---------------------------------------------------------------------------
# the step on a mesh of stacked ranks
# ---------------------------------------------------------------------------


def _spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in :func:`tree_leaves` order (a spec is a
    tuple or a :class:`Pinned`, never walked into)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def _mesh_axes(ctx: ParallelContext) -> tuple[tuple[str, ...], str]:
    """The data axes and the model axis of a training mesh, which must be
    the mesh's axes in that order, all in one process."""
    mesh, data_axes, model_axis = ctx.mesh, tuple(ctx.data_axes), ctx.model_axis
    if model_axis is None or tuple(mesh.axis_names) != (*data_axes, model_axis):
        raise ValueError(f"a training mesh's axes are (*data_axes, model_axis): mesh "
                         f"{mesh.axis_names}, data axes {data_axes}, model axis {model_axis!r}")
    if mesh.processes > 1:
        raise NotImplementedError(f"training on a mesh of {mesh.processes} processes: ROADMAP "
                                  f"Queue 1 item 17 (stacked ranks across processes)")
    return data_axes, model_axis


@dataclasses.dataclass(frozen=True)
class _Group:
    """One leaf of JAX's tree: the port's leaves at one path below a
    stacked subtree, one a layer in stacked row-major order (a leaf outside
    such a subtree alone).  The specs are on ``(*stack, *leaf)``."""

    ids: tuple[int, ...]  # positions in tree_leaves order
    stack: tuple[int, ...]  # the stacked axes' sizes; () outside a stack
    pspec: tuple
    mspec: tuple
    zero: int | None  # the axis of (*stack, *leaf) ZeRO-1 splits over the data axes
    decay: bool
    fsdp: bool = False  # the parameters too are split over the data axes (on ``zero``)


def _groups(params: Any, specs: TrainState, data_axes: tuple[str, ...]) -> list[_Group]:
    """Every JAX leaf of a parameter tree (of any tensors with a shape)
    with its specs from :func:`state_pspecs`, in JAX's leaf order."""
    leaves = tree_leaves(params)
    pspecs, mspecs = _spec_leaves(specs["params"]), _spec_leaves(specs["opt"]["m"])
    found: dict[tuple, list] = {}
    for i, ((path, leaf), ps, ms) in enumerate(zip(leaves, pspecs, mspecs, strict=True)):
        depth = STACKS.get(path[0], 0) if path else 0
        key = (path[:1] + path[1 + depth:]) if depth else path
        found.setdefault(key, []).append((i, path, leaf, tuple(ps), tuple(ms), depth))
    out = []
    for members in found.values():
        i, path, leaf, ps, ms, depth = members[0]
        zero = next((a for a, e in enumerate(ms) if set(_names(e)) & set(data_axes)), None)
        split = [a for a, e in enumerate(ps) if set(_names(e)) & set(data_axes)]
        # FSDP: the data axes on a stacked layer axis, where the moments are
        # split too (ZeRO-1 adds nothing to a leaf already split over them)
        if split and (split[0] >= depth or split != [zero]):
            raise NotImplementedError(f"parameters split over the data axes (FSDP) at {path} "
                                      f"as {ps}: only on a stacked layer axis")
        stack = shd._stack_sizes(params, path, depth) if depth else ()
        out.append(_Group(tuple(m[0] for m in members), stack, ps, ms, zero,
                          stacked_ndim(path, leaf) >= 2, bool(split)))
    return out


def stacked_specs(specs: TrainState, like: TrainState, mesh: VirtualMesh,
                  data_axes: tuple[str, ...]) -> TrainState:
    """:func:`state_pspecs` as :func:`~repro_torch.train.fault_tolerance.
    reshard_state` places the port's tree: each leaf's entries on its own
    axes.  A stacked subtree's leaf has its layer's entries in front, which
    name no mesh axis except where ZeRO-1 split the layer axis over the
    data axes; there the leaf is :class:`Pinned` to the data coordinates
    of the rank that holds its layer."""
    sizes = [mesh.shape[a] for a in data_axes]
    dsize = math.prod(sizes)

    def tree(spec_tree, shapes):
        def one(path, spec):
            depth = STACKS.get(path[0], 0) if path else 0
            spec = tuple(spec)
            if not depth:
                return shd.P(*spec)
            stack = shd._stack_sizes(shapes, path, depth)
            idx = path[1:1 + depth]
            pin = [a for a in range(depth) if spec[a] is not None]
            if not pin:
                return shd.P(*spec[depth:])
            if len(pin) > 1 or set(_names(spec[pin[0]])) != set(data_axes):
                raise NotImplementedError(f"a stacked axis split as {spec} at {path}")
            a = pin[0]
            owner = idx[a] // (stack[a] // dsize)
            return Pinned(shd.P(*spec[depth:]), data_axes,
                          tuple(int(c) for c in np.unravel_index(owner, sizes)))

        return shd._walk(one, spec_tree)

    return {"params": tree(specs["params"], like["params"]),
            "opt": {"m": tree(specs["opt"]["m"], like["params"]),
                    "v": tree(specs["opt"]["v"], like["params"]),
                    "step": shd.P()}}


def gather_state(state: TrainState, mesh: VirtualMesh, placed: TrainState,
                 device: str | torch.device | None = None) -> TrainState:
    """A train state on ``mesh`` (stacked as ``placed``, from
    :func:`stacked_specs`) as global arrays, on ``device`` (the leaf's own
    by default), one leaf at a time: the inverse of ``reshard_state``."""
    def one(leaf, spec):
        t = _from_stacked(leaf, mesh, spec)
        return t.clone() if device is None else t.to(device, copy=True)

    return _map_specs(one, state, placed)


@contextlib.contextmanager
def _logged(on: bool):
    """Collectives issued inside go to ``transport.OP_LOG`` only when
    ``on``."""
    log = transport.OP_LOG
    if not on:
        transport.OP_LOG = None
    try:
        yield
    finally:
        transport.OP_LOG = log


def _mesh_step(model: Model, opt_cfg: OptimizerConfig, ctx: ParallelContext,
               microbatches: int, specs: TrainState | None = None) -> Callable:
    """The step on ``ctx.mesh`` (module docstring), in six stages:

    1. each data rank's parameters, gathered over the model axis from its
       own row of the stacked state (an FSDP leaf also over the data axes,
       from its owner's row);
    2. its loss and gradients on its rows of the batch (``batch_pspecs``:
       a batch the data axes do not divide is every rank's whole), in
       ``microbatches`` slices, in a context on its row of the mesh (the
       ring paths of ``seq_parallel`` and ``tp_mode="ring"`` run over the
       model axis there);
    3. per JAX leaf, the data ranks' gradients on the parameters' layout,
       summed in ``grad_accum_dtype`` by a reduce-scatter over the data
       axes along ZeRO-1's axis (an all-reduce where it has none), divided
       by data ranks x microbatches and cast to the parameter dtype;
    4. ``compress_grads``, the global norm over every distinct shard, the
       clip;
    5. AdamW on each rank's moment shard and its slice of the parameters,
       with JAX's decay mask and schedule;
    6. the new parameter shards all-gathered over the data axes (an FSDP
       leaf written back to its owner, not gathered).

    The loss is the mean of the data ranks' losses.  The collectives of
    stages 1 and 2 are logged for one data rank (the last), as a device
    issues them.  Under a cost count on a meta mesh (the dry-run) every
    data rank's pass, and every microbatch of it, has the same shapes:
    stage 2 runs the last rank's first microbatch and counts it as the
    passes it stands for (:func:`~repro_torch.core.comm_analysis.
    repeated`: the microbatches' collectives too), after allocating the
    earlier ranks' gradients, which the real order holds through the last
    pass."""
    mesh = ctx.mesh
    data_axes, model_axis = _mesh_axes(ctx)
    nd = len(data_axes)
    dsize = math.prod(mesh.shape[a] for a in data_axes)
    k = mesh.shape[model_axis]
    ranks = mesh.size
    like = init_state(model, opt_cfg, "meta")
    specs = specs or state_pspecs(model, like, mesh, ctx)
    groups = _groups(like["params"], specs, data_axes)
    placed = stacked_specs(specs, like, mesh, data_axes)
    pspecs = _spec_leaves(placed["params"])
    row = make_mesh((1,) * nd + (k,), mesh.axis_names, device=mesh.device)
    row_ctx = dataclasses.replace(ctx, mesh=row)
    accum_dtype = torch_dtype(model.cfg.grad_accum_dtype)
    meta = mesh.device.type == "meta"
    like_leaves = [t for _, t in tree_leaves(like["params"])]
    b1, b2, eps = opt_cfg.beta1, opt_cfg.beta2, opt_cfg.eps

    def gathered(p: torch.Tensor, d: int, spec) -> torch.Tensor:
        """Stage 1 for data rank ``d``: its row's shards, whole.  An FSDP
        leaf (:class:`Pinned`) is one row, its layer's owner's, which the
        other data ranks all-gather over the data axes."""
        x = p if isinstance(spec, Pinned) else p.reshape(dsize, k, *p.shape[nd + 1:])[d]
        x = x.reshape(*row.axis_sizes, *p.shape[nd + 1:])
        whole = _from_stacked(x, row, spec)
        if transport.OP_LOG is not None:
            if isinstance(spec, Pinned):
                transport.log_collective("all-gather", x.reshape(k, *p.shape[nd + 1:]), dsize)
            if model_axis in _axes_of_spec(spec):
                transport.log_collective("all-gather", whole[None], k)
        return whole.detach()

    def rank_grads(params, d: int, rows: dict) -> tuple[torch.Tensor, list]:
        """Stage 2: data rank ``d``'s loss and gradients (summed in
        ``accum_dtype`` over its microbatches when there are several)."""
        leaves = [gathered(p, d, s).requires_grad_(True)
                  for (_, p), s in zip(tree_leaves(params), pspecs)]
        tree = tree_unflatten(like["params"], leaves)
        if microbatches <= 1:
            loss = model.loss(tree, rows, ctx=row_ctx)
            return loss.detach(), list(torch.autograd.grad(loss, leaves))
        n = next(iter(rows.values())).shape[0] // microbatches
        g_sum = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in leaves]
        l_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        once = meta and counting()
        with repeated(microbatches if once else 1, collectives=True):
            for i in range(1 if once else microbatches):
                loss = model.loss(tree, {key: v[i * n:(i + 1) * n] for key, v in rows.items()},
                                  ctx=row_ctx)
                for a, b in zip(g_sum, torch.autograd.grad(loss, leaves)):
                    a.add_(b)
                l_sum = l_sum + loss.detach()
        return l_sum / microbatches, g_sum

    def data_rows(batch: dict) -> list[dict]:
        b = next(iter(batch.values())).shape[0]
        if b % dsize:
            return [batch] * dsize
        n = b // dsize
        return [{key: v[d * n:(d + 1) * n] for key, v in batch.items()} for d in range(dsize)]

    def scatter(x: torch.Tensor, axis: str, z: int) -> torch.Tensor:
        """Reduce-scatter over ``axis`` along local axis ``z``: the axis cut
        into (ranks, block) and the block axis partitioned, so a 1-D leaf
        takes ``n_parts`` too."""
        kk = mesh.shape[axis]
        y = x.unflatten(z + 1, (kk, x.shape[z + 1] // kk))
        y = partitioned_psum_scatter(y, mesh, axis, scatter_axis=z, n_parts=ctx.n_parts,
                                     chunk_axis=z + 1)
        return y.squeeze(z + 1)

    def reduce(g: _Group, grads: list[list]) -> torch.Tensor:
        """Stage 3 for one JAX leaf; frees the data ranks' gradients of it."""
        xs = []
        for d in range(dsize):
            parts = [grads[d][i] for i in g.ids]
            for i in g.ids:
                grads[d][i] = None
            whole = torch.stack(parts).unflatten(0, g.stack) if g.stack else parts[0]
            xs.append(_to_stacked(whole.to(accum_dtype), row, g.pspec))
            del parts, whole
        x = torch.stack(xs).reshape(ranks, *xs[0].shape[nd + 1:])
        del xs
        for axis in data_axes:
            x = (partitioned_psum(x, mesh, axis, n_parts=ctx.n_parts) if g.zero is None
                 else scatter(x, axis, g.zero))
        return x

    def join(leaves: list[torch.Tensor], g: _Group, pinned: bool) -> torch.Tensor:
        """A group's leaves (stacked layouts) as one ``(R, *stack, *leaf)``
        tensor; ``pinned``: each leaf lives on its layer's data rank."""
        if not g.stack:
            return leaves[0].reshape(ranks, *leaves[0].shape[nd + 1:])
        if not pinned:
            x = torch.stack([t.reshape(ranks, *t.shape[nd + 1:]) for t in leaves], 1)
            return x.unflatten(1, g.stack)
        depth, z = len(g.stack), g.zero
        x = torch.stack([t.reshape(k, *t.shape[nd + 1:]) for t in leaves]).unflatten(0, g.stack)
        x = x.unflatten(z, (dsize, g.stack[z] // dsize)).movedim(z, 0).movedim(depth + 1, 1)
        return x.reshape(ranks, *x.shape[2:])

    def split(x: torch.Tensor, g: _Group, leaves: list[torch.Tensor], pinned: bool) -> None:
        """Write a joined group back into its leaves (the inverse of
        :func:`join`)."""
        if not g.stack:
            leaves[0].copy_(x.reshape(leaves[0].shape))
            return
        y = x.reshape(dsize, k, *x.shape[1:]) if pinned else x
        for j, t in enumerate(leaves):
            idx = [int(c) for c in np.unravel_index(j, g.stack)]
            if pinned:
                per = g.stack[g.zero] // dsize
                d, idx[g.zero] = divmod(idx[g.zero], per)
                t.copy_(y[(d, slice(None), *idx)].reshape(t.shape))
            else:
                t.copy_(y[(slice(None), *idx)].reshape(t.shape))

    def own_slice(x: torch.Tensor, z: int) -> torch.Tensor:
        """Each rank's block of local axis ``z`` on the moments' layout:
        data rank ``d`` (flattened) takes block ``d`` of ``dsize``."""
        y = x.reshape(dsize, k, *x.shape[1:])
        y = y.unflatten(2 + z, (dsize, y.shape[2 + z] // dsize)).diagonal(dim1=0, dim2=2 + z)
        y = y.movedim(-1, 0)
        return y.reshape(ranks, *y.shape[2:])

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params, opt = state["params"], state["opt"]
        p_leaves = [p for _, p in tree_leaves(params)]
        m_leaves = [t for _, t in tree_leaves(opt["m"])]
        v_leaves = [t for _, t in tree_leaves(opt["v"])]
        losses, grads = [], []
        once = meta and counting()
        g_dtype = accum_dtype if microbatches > 1 else None
        for d, rows in enumerate(data_rows(batch)):
            if once and d < dsize - 1:  # held while the pass that stands for it runs
                grads.append([torch.empty(t.shape, dtype=g_dtype or t.dtype, device=t.device)
                              for t in like_leaves])
                continue
            with repeated(dsize if once else 1), _logged(d == dsize - 1):
                loss, g = rank_grads(params, d, rows)
            losses.append(loss)
            grads.append(g)
            del g
        loss = torch.stack(losses).mean()
        gen = None
        if opt_cfg.grad_compression == "int8_stochastic":
            gen = torch.Generator(mesh.device).manual_seed(0)
        reduced, squares = [], []
        with torch.no_grad():
            for g in groups:
                dtype = p_leaves[g.ids[0]].dtype
                x = (reduce(g, grads) / (dsize * microbatches)).to(dtype)
                if opt_cfg.grad_compression == "int8_stochastic":
                    # the scale and the noise of the whole JAX leaf, so that
                    # replicated shards stay equal
                    st = x.reshape(*mesh.axis_sizes, *x.shape[1:])
                    whole = compress_grads(_from_stacked(st, mesh, g.mspec),
                                           opt_cfg.grad_compression, gen)
                    x = _to_stacked(whole, mesh, g.mspec).reshape(x.shape)
                else:
                    x = compress_grads(x, opt_cfg.grad_compression)
                u = x.reshape(dsize, k, *x.shape[1:])
                if g.zero is None:
                    u = u[:1]
                if model_axis not in _axes_of_spec(g.mspec):
                    u = u[:, :1]
                squares.append(torch.sum(torch.square(u.float())))
                reduced.append(x)
            del grads
            gnorm = torch.sqrt(torch.sum(torch.stack(squares)))
            scale = torch.clamp(opt_cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            count = opt["step"].reshape(-1)[0] + 1
            lr = lr_schedule(opt_cfg, count)
            bc1 = 1.0 - b1 ** count.float()
            bc2 = 1.0 - b2 ** count.float()
            for gi, g in enumerate(groups):
                grad, reduced[gi] = reduced[gi], None
                gf = (grad.float() * scale).to(grad.dtype).float()
                del grad
                pinned = g.zero is not None and g.zero < len(g.stack)
                ps = [p_leaves[i] for i in g.ids]
                ms = [m_leaves[i] for i in g.ids]
                vs = [v_leaves[i] for i in g.ids]
                p = join(ps, g, g.fsdp)  # FSDP: already each rank's layers
                if g.zero is not None and not g.fsdp:
                    p = own_slice(p, g.zero)
                m, v = join(ms, g, pinned), join(vs, g, pinned)
                m32 = m.float() * b1 + gf * (1 - b1)
                v32 = v.float() * b2 + torch.square(gf) * (1 - b2)
                delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
                if g.decay:
                    delta = delta + opt_cfg.weight_decay * p.float()
                new = (p.float() - lr * delta).to(p.dtype)
                del p, m, v, delta, gf
                split(m32, g, ms, pinned)
                split(v32, g, vs, pinned)
                del m32, v32
                if g.zero is not None and not g.fsdp:
                    for axis in reversed(data_axes):
                        new = ring_all_gather(new, mesh, axis, gather_axis=g.zero)
                split(new, g, ps, g.fsdp)
                del new
            opt["step"] = opt["step"] + 1
        return state, {"grad_norm": gnorm, "lr": lr, "loss": loss}

    step.placed = placed
    return step


def _axes_of_spec(spec) -> set[str]:
    spec = spec.spec if isinstance(spec, Pinned) else spec
    return {a for e in spec for a in _names(e)}


def init_state(model: Model, opt_cfg: OptimizerConfig, gen: torch.Generator | int | str = 0
               ) -> TrainState:
    """Fresh parameters from ``gen`` (a generator, a seed, or ``"meta"``
    for shapes alone) and zero moments in ``cfg.opt_state_dtype``."""
    params = model.init(gen)
    return {"params": params,
            "opt": init_opt_state(params, opt_cfg, model.cfg.opt_state_dtype)}


def state_pspecs(model: Model, state_shapes: TrainState, mesh,
                 ctx: ParallelContext) -> TrainState:
    """Sharding specs for a train state (params TP + ZeRO-1 moments) on the
    port's layout (:mod:`repro_torch.parallel.sharding`)."""
    kw = dict(cfg=model.cfg, model_axis=ctx.model_axis or "model", model_size=ctx.model_size)
    pspec = shd.param_pspecs(state_shapes["params"], **kw)
    m = state_shapes["opt"]["m"]
    mspec = shd.zero1_pspecs(m, shd.param_pspecs(m, **kw), cfg=model.cfg,
                             data_axes=ctx.data_axes, mesh=mesh)
    return {"params": pspec, "opt": {"m": mspec, "v": mspec, "step": shd.P()}}


def train_pspecs(cfg: ModelConfig, like: TrainState, mesh: VirtualMesh,
                 data_axes: tuple[str, ...]) -> TrainState:
    """JAX's specs of a train state on ``mesh`` (``like``: its shapes):
    :func:`state_pspecs`'s, with the config's ``fsdp_experts`` too (the
    expert stacks' layer axis over the data axes), which ``state_pspecs``
    leaves off as JAX's ``Trainer`` does.  Hand them to
    :func:`make_train_step` or :class:`Trainer` as ``shardings``."""
    kw = dict(cfg=cfg, model_axis="model", model_size=mesh.shape["model"],
              fsdp_experts=cfg.fsdp_experts, data_axes=data_axes, mesh=mesh)
    m = like["opt"]["m"]
    mspec = shd.zero1_pspecs(m, shd.param_pspecs(m, **kw), cfg=cfg, data_axes=data_axes,
                             mesh=mesh)
    return {"params": shd.param_pspecs(like["params"], **kw),
            "opt": {"m": mspec, "v": mspec, "step": shd.P()}}


@dataclasses.dataclass
class TrainResult:
    steps_done: int
    losses: list
    restarts: int
    straggler_flags: int
    checksum: float
    #: host seconds of each step run, ending with the loss read back (the
    #: port's addition: what the straggler monitor observed)
    step_seconds: list = dataclasses.field(default_factory=list)


class Trainer:
    """Fault-tolerant training driver.

    init -> [restore latest checkpoint] -> prefetch -> loop { step; observe
    straggler; periodic async checkpoint; injected failures trigger
    restart-from-checkpoint }.  The step accumulates gradients over
    :func:`microbatches_of` the model's config, the run's shape and the
    data ranks.

    With ``ctx.mesh`` set the state lives on the mesh: drawn on one
    generator as on one device, then placed by ``reshard_state`` as
    ``shardings`` says (a spec tree of :func:`state_pspecs`'s form, its
    result by default).  A checkpoint holds the gathered global arrays, the
    bytes a one-device run of the same state writes, and restores onto
    whatever mesh the restoring ``Trainer`` is given.
    """

    def __init__(self, model: Model, run_cfg: RunConfig, ctx: ParallelContext = LOCAL,
                 injector: FailureInjector | None = None, shardings: Any | None = None):
        self.model = model
        self.run_cfg = run_cfg
        self.ctx = ctx
        self.injector = injector or FailureInjector(enabled=False)
        self.monitor = StragglerMonitor(ewma=run_cfg.straggler_ewma,
                                        factor=run_cfg.straggler_factor)
        data_size = 1
        if ctx.mesh is not None:
            data_size = math.prod(ctx.mesh.shape[a] for a in _mesh_axes(ctx)[0])
        self.microbatches = microbatches_of(model.cfg, run_cfg.shape, data_size)
        self.step_fn = make_train_step(model, run_cfg.optimizer, ctx, self.microbatches,
                                       shardings=shardings)
        #: the state's specs on each leaf's own axes (None without a mesh)
        self.placed = getattr(self.step_fn, "placed", None)
        self.checkpointer = (
            ckpt.AsyncCheckpointer(run_cfg.checkpoint_dir, keep=run_cfg.keep_checkpoints)
            if run_cfg.checkpoint_dir and run_cfg.async_checkpoint else None)
        self.restarts = 0

    # -- state ----------------------------------------------------------------
    def _load_or_init(self) -> tuple[TrainState, int]:
        d, opt = self.run_cfg.checkpoint_dir, self.run_cfg.optimizer
        if self.checkpointer is not None:
            # a save still being written when a failure landed is finished
            # first, so the restart takes the latest step (JAX's loop reads
            # the directory while its writer may still run: which step it
            # restores depends on timing)
            self.checkpointer.wait()
        mesh = self.ctx.mesh
        if self.run_cfg.resume and d and ckpt.latest_step(d) is not None:
            like = init_state(self.model, opt, "meta")
            if mesh is None:
                state, step = ckpt.restore(d, like=like, device=self.model.device)
            else:  # the global arrays stay on the host until placed
                state, step = ckpt.restore(d, like=like, device="cpu")
                state = reshard_state(state, mesh, self.placed)
            log.info("restored checkpoint at step %d", step)
            return state, step
        state = init_state(self.model, opt, self.run_cfg.seed)
        if mesh is not None:
            state = reshard_state(state, mesh, self.placed)
        return state, 0

    def global_state(self, state: TrainState, device=None) -> TrainState:
        """``state`` as global arrays (itself without a mesh)."""
        if self.ctx.mesh is None:
            return state
        return gather_state(state, self.ctx.mesh, self.placed, device)

    # -- loop -----------------------------------------------------------------
    def run(self) -> TrainResult:
        losses: list[float] = []
        self.step_seconds: list[float] = []
        while True:
            try:
                return self._run_once(losses)
            except SimulatedFailure as e:
                self.restarts += 1
                log.warning("%s -> restart %d", e, self.restarts)
                if self.restarts > 5:
                    raise

    def _run_once(self, losses: list) -> TrainResult:
        cfg = self.run_cfg
        state, start_step = self._load_or_init()
        dataset = SyntheticLM(self.model.cfg, cfg.shape.global_batch, cfg.shape.seq_len,
                              seed=cfg.seed)
        prefetch = Prefetcher(dataset, self.model.device, start_step=start_step)
        try:
            for step, batch in prefetch:
                if step >= cfg.steps:
                    break
                self.injector.check(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self.monitor.observe(step, dt)
                self.step_seconds.append(dt)
                losses.append(loss)
                if cfg.log_every and step % cfg.log_every == 0:
                    log.info("step %d loss %.4f (%.0f ms)", step, loss, dt * 1e3)
                if (cfg.checkpoint_dir and cfg.checkpoint_every
                        and (step + 1) % cfg.checkpoint_every == 0):
                    saved = self.global_state(state, "cpu" if self.ctx.mesh else None)
                    if self.checkpointer is not None:
                        self.checkpointer.save(saved, step + 1)
                    else:
                        ckpt.save(saved, cfg.checkpoint_dir, step + 1,
                                  keep=cfg.keep_checkpoints)
                    del saved
        finally:
            prefetch.stop()
        if self.checkpointer is not None:
            self.checkpointer.wait()
        first = tree_leaves(state["params"])[0][1]  # embed, JAX's first leaf
        if self.ctx.mesh is not None:
            first = _from_stacked(first, self.ctx.mesh, _spec_leaves(self.placed["params"])[0])
        return TrainResult(
            steps_done=cfg.steps,
            losses=losses,
            restarts=self.restarts,
            straggler_flags=len(self.monitor.flagged),
            checksum=float(torch.mean(first.detach().float())),
            step_seconds=self.step_seconds,
        )
