"""The dry-run: every (architecture x shape) cell built from meta tensors on
the production mesh, with its memory, FLOP, byte and collective accounting
(PyTorch port of ``src/repro/launch/dryrun.py``, same names)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--force]

Per cell it builds the port's real step on the production mesh
(:func:`~repro_torch.launch.mesh.make_production_mesh`, a meta
``VirtualMesh``), with its inputs as meta tensors (no storage anywhere):

* ``train_4k`` -> :func:`~repro_torch.train.train_loop.make_train_step` on
  the mesh (forward, backward, AdamW with ZeRO-1 moments, microbatched per
  config), the state in the stacked layout of ``state_pspecs``;
* ``prefill_32k`` -> ``model.prefill`` (the cache built), an encoder's
  ``model.logits``;
* ``decode_32k``/``long_500k`` -> ``model.decode_step`` (one token against
  the cache).

JAX lowers and compiles each cell and reads HLO.  The port compiles
nothing: it runs the step once on the meta tensors under
:func:`~repro_torch.core.comm_analysis.count_cost`, which sees every op it
dispatches, forward and backward; the hand-written kernels' meta routes
record their own FLOPs and bytes (:mod:`repro_torch.kernels.costs`), so the
count is of what the port runs on the card (JAX's dry-run counts its
plain attention).  A record has JAX's keys (``flops``, ``bytes``,
``wire_bytes``, ``wire_by_op``, ``coll_counts``, ``n_loops``,
``trip_counts``, ``memory``, ``microbatches``, ``n_devices``,
``fits_16gb``; ``compile_s`` holds the meta run's seconds) plus
``hbm_fits`` (against :data:`~repro_torch.core.comm_analysis.H100`'s 80
GB), ``kernels`` (each hand-written kernel's calls, FLOPs and bytes) and
``ops`` (the ops the step dispatched, each about one launch on the card).
Every figure is per device:

* ``memory.argument``: the per-device bytes of the arguments from their
  specs and the mesh (a train state in the stacked layout: its bytes over
  the devices; any other leaf: its bytes over the mesh axes its spec
  names); ``memory.output``: the outputs' so (an output that is a donated
  argument by its spec, a new one by the batch rule of ``batch_pspecs``);
  ``memory.alias``: the outputs that are donated arguments, updated in
  place.
* ``flops``, ``bytes``: the stacked step's counted totals divided by the
  devices.  The port has no GSPMD: every data rank's pass runs once (on
  meta, one pass counted for all, ``comm_analysis.repeated``), so work JAX
  replicates over ``model`` is not counted k times.
* ``wire_bytes``, ``wire_by_op``, ``coll_counts``: per device, as
  ``count_collectives`` defines them: every microbatch's collectives, of
  one data rank.
* ``memory.temp``: the most bytes live at once among the storages the
  step made (activations, gradients, outputs), divided by the devices:
  exact on one device (``chip_smoke.py`` phase O3 holds it against the
  card's ``max_memory_allocated``).  On a mesh it is the stacked step's
  own peak over the devices: that step runs the data ranks' passes in
  turn, the last with the others' gradients held (on meta those are
  allocated before the one pass that runs), so it holds every rank's
  gradients but one rank's activations at a time, where a device of the
  real mesh holds its own rank's.
  ``memory.peak`` = argument + temp.
* ``n_loops`` is 0 and ``trip_counts`` empty: an eager step has no loop to
  correct; ``xla_flops``/``xla_bytes`` are absent.

A cell the port refuses is recorded ``FAIL`` with its ``.err`` (expert
parallelism on a model axis that is not the slot count), and the run exits
1, as JAX's does.  Training with ``fsdp_experts`` (grok-1) takes the
config's FSDP expert stacks (``train_loop.train_pspecs``), which the mesh step
holds on their layer's data rank.  Records go to
``results/dryrun_torch/``.  ``--reanalyze`` refuses: no HLO is stored to
read again.  Unlike the JAX module this one sets no ``XLA_FLAGS``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, OptimizerConfig, ShapeConfig
from repro_torch.core.comm_analysis import H100, count_cost
from repro_torch.core.mesh import VirtualMesh
from repro_torch.launch.mesh import data_axes_of, make_production_mesh
from repro_torch.models.api import batch_spec, build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.context import ParallelContext
from repro_torch.train.fault_tolerance import Pinned, _map_specs, _names, reshard_state
from repro_torch.train.train_loop import (
    init_state,
    make_train_step,
    microbatches_of,
    stacked_specs,
    train_pspecs,
)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")

#: the JAX package's architectures, in its order (``repro.configs.ARCH_IDS``)
ARCH_IDS = [
    "rwkv6-1.6b",
    "llama-3.2-vision-11b",
    "qwen2.5-14b",
    "llama3-8b",
    "granite-8b",
    "stablelm-1.6b",
    "phi3.5-moe-42b-a6.6b",
    "grok-1-314b",
    "hubert-xlarge",
    "zamba2-1.2b",
]


# ---------------------------------------------------------------------------
# cell construction
# ---------------------------------------------------------------------------


def make_context(cfg: ModelConfig, shape: ShapeConfig, mesh: VirtualMesh,
                 overrides: dict | None = None) -> ParallelContext:
    o = overrides or {}
    return ParallelContext(
        mesh=mesh,
        data_axes=data_axes_of(mesh),
        model_axis="model",
        seq_parallel=o.get(
            "seq_parallel",
            shape.kind == "prefill" and cfg.partitioned_collectives
            and cfg.family in ("dense", "moe", "vlm", "audio")),
        moe_mode=o.get("moe_mode", "ep" if cfg.family == "moe" else "dense"),
        n_parts=o.get("n_parts", cfg.halo_n_parts if cfg.partitioned_collectives else 1),
        state_method=o.get("state_method", "ring"),
        tp_mode=o.get("tp_mode", "gspmd"),
    )


def _microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh: VirtualMesh) -> int:
    return microbatches_of(cfg, shape, math.prod(mesh.shape[a] for a in data_axes_of(mesh)))


def _deferred_train_step(model, opt_cfg: OptimizerConfig, ctx: ParallelContext, mb: int,
                         specs: Any) -> Callable:
    """The mesh step, made at its first call (where JAX lowers its step), so
    a step the port refuses fails the run of its cell, not its build."""
    made: list[Callable] = []

    def step(state, batch):
        if not made:
            made.append(make_train_step(model, opt_cfg, ctx, mb, shardings=specs))
        return made[0](state, batch)

    return step


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: VirtualMesh,
               overrides: dict | None = None):
    """Returns ``(step_fn, meta_args, donate_argnums, specs)``: ``specs``
    one spec tree per argument (a train state's on each leaf's own axes in
    the stacked layout, :func:`~repro_torch.train.train_loop.
    stacked_specs`)."""
    model = build_model(cfg, "meta")
    ctx = make_context(cfg, shape, mesh, overrides)
    da = ctx.data_axes
    msize = mesh.shape["model"]
    pkw = dict(cfg=cfg, model_axis="model", model_size=msize, fsdp_experts=cfg.fsdp_experts,
               data_axes=da, mesh=mesh)

    if shape.kind == "train":
        opt_cfg = OptimizerConfig()
        like = init_state(model, opt_cfg, "meta")
        specs = train_pspecs(cfg, like, mesh, da)
        placed = stacked_specs(specs, like, mesh, da)
        batch = batch_spec(cfg, shape)
        step = _deferred_train_step(model, opt_cfg, ctx, _microbatches(cfg, shape, mesh), specs)
        return (step, (reshard_state(like, mesh, placed), batch), (0,),
                (placed, shd.batch_pspecs(batch, data_axes=da, mesh=mesh)))

    params = model.init("meta")
    pspec = shd.param_pspecs(params, **pkw)
    if shape.kind == "prefill" and cfg.is_encoder_only:
        # encoder-only: the inference-prefill cell is a full encode pass
        batch = batch_spec(cfg, shape)
        batch.pop("labels", None)
        batch.pop("mask", None)

        def encode_step(params, batch):
            return model.logits(params, batch, ctx=ctx)

        return (encode_step, (params, batch), (),
                (pspec, shd.batch_pspecs(batch, data_axes=da, mesh=mesh)))

    if shape.kind == "prefill":
        batch = batch_spec(cfg, shape)

        def serve_step(params, batch, cache):
            return model.prefill(params, batch, cache, ctx=ctx)

    else:  # decode
        batch = {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                       device="meta")}

        def serve_step(params, batch, cache):
            return model.decode_step(params, batch["tokens"], cache, ctx=ctx)

    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    cspec = shd.cache_pspecs(cache, data_axes=da, model_axis="model", model_size=msize,
                             mesh=mesh)
    return (serve_step, (params, batch, cache), (2,),
            (pspec, shd.batch_pspecs(batch, data_axes=da, mesh=mesh), cspec))


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------


def leaf_bytes(leaf: torch.Tensor, spec: Any, mesh: VirtualMesh) -> float:
    """A leaf's bytes on one device: a leaf in the stacked layout (a
    :class:`Pinned` spec, or leading dims equal to the mesh's) its bytes
    over the devices; any other its bytes over the sizes of the mesh axes
    its spec names."""
    nbytes = leaf.numel() * leaf.element_size()
    m = len(mesh.axis_sizes)
    if isinstance(spec, Pinned) or (tuple(leaf.shape[:m]) == mesh.axis_sizes
                                    and leaf.dim() == m + len(spec)):
        return nbytes / mesh.size
    return nbytes / math.prod(mesh.shape[a] for e in spec for a in _names(e))


def tree_bytes(tree: Any, specs: Any, mesh: VirtualMesh) -> float:
    """:func:`leaf_bytes` summed over a tree beside its spec tree."""
    out = [0.0]

    def one(leaf, spec):
        out[0] += leaf_bytes(leaf, spec, mesh)

    _map_specs(one, tree, specs)
    return out[0]


def _memory(args: tuple, specs: tuple, donate: tuple, result: Any, mesh: VirtualMesh,
            data_axes: tuple[str, ...]) -> dict:
    """``memory.argument``, ``output`` and ``alias`` (module docstring)."""
    by_storage: dict[int, tuple[float, bool]] = {}
    argument = 0.0
    for i, (arg, spec) in enumerate(zip(args, specs)):
        def one(leaf, s, i=i):
            nonlocal argument
            b = leaf_bytes(leaf, s, mesh)
            argument += b
            by_storage[leaf.untyped_storage()._cdata] = (b, i in donate)

        _map_specs(one, arg, spec)
    output = alias = 0.0
    for t in tree_leaves(result):
        if not isinstance(t, torch.Tensor):
            continue
        hit = by_storage.get(t.untyped_storage()._cdata)
        if hit is None:  # a new output: stacked, or by the batch rule
            stacked = tuple(t.shape[:len(mesh.axis_sizes)]) == mesh.axis_sizes
            output += (t.numel() * t.element_size() / mesh.size if stacked else
                       leaf_bytes(t, shd.batch_pspecs(t, data_axes=data_axes, mesh=mesh), mesh))
            continue
        output += hit[0]
        if hit[1]:
            alias += hit[0]
    return {"argument": argument, "output": output, "alias": alias}


def analyze_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: VirtualMesh,
                 overrides: dict | None = None) -> dict:
    """Build one cell on ``mesh``, run it once under :func:`count_cost`:
    its per-device record (module docstring)."""
    step, args, donate, specs = build_cell(cfg, shape, mesh, overrides)
    stats = count_cost(step, *args)
    n = mesh.size
    memory = _memory(args, specs, donate, stats.result, mesh, data_axes_of(mesh))
    temp = stats.peak_bytes / n
    memory.update(temp=temp, peak=memory["argument"] + temp)
    return {
        "flops": stats.flops / n,
        "bytes": stats.bytes / n,
        "wire_bytes": stats.wire_bytes,
        "wire_by_op": {k: float(v) for k, v in stats.by_op_bytes.items()},
        "coll_counts": dict(stats.by_op_counts),
        "n_loops": 0,
        "trip_counts": [],
        "memory": {k: memory[k] for k in ("argument", "output", "temp", "peak", "alias")},
        "kernels": {k: {"calls": v["calls"], "flops": v["flops"] / n, "bytes": v["bytes"] / n}
                    for k, v in stats.kernels.items()},
        "ops": stats.ops,
    }


# ---------------------------------------------------------------------------
# depth-reduced variants (JAX's trip-count correction; here a cross-check)
# ---------------------------------------------------------------------------


def reduced_depth(cfg: ModelConfig, units: int) -> tuple[ModelConfig, int]:
    """A config with ``units`` scan iterations; returns (cfg, full_units)."""
    if cfg.family == "hybrid":
        g = cfg.attn_every
        full = cfg.n_layers // g  # groups (tail ~ scaled by analyzer)
        return cfg.with_updates(n_layers=units * g), full
    if cfg.family == "vlm":
        per = cfg.n_layers // cfg.n_cross_layers
        full = cfg.n_cross_layers
        return cfg.with_updates(n_layers=units * per, n_cross_layers=units), full
    return cfg.with_updates(n_layers=units), cfg.n_layers


# ---------------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides: dict | None = None,
             depth_variants: bool = False, tag: str = "") -> dict:
    cfg = get_config(arch)
    # "cfg.<field>=<val>" overrides patch the model config; the rest are the context's
    overrides = overrides or {}
    patches = {k[4:]: v for k, v in overrides.items() if k.startswith("cfg.")}
    if patches:
        cfg = cfg.with_updates(**patches)
    overrides = {k: v for k, v in overrides.items() if not k.startswith("cfg.")}
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    result: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "n_devices": mesh.size,
        "overrides": overrides,
        "microbatches": _microbatches(cfg, shape, mesh),
    }
    t0 = time.time()
    result["full"] = analyze_cell(cfg, shape, mesh, overrides or None)
    result["compile_s"] = round(time.time() - t0, 1)
    m = result["full"]["memory"]
    need = m["peak"] or (m["argument"] + m["temp"] + m["output"])
    result["fits_16gb"] = bool(need <= 16e9)
    result["hbm_fits"] = bool(need <= H100.hbm_per_chip)
    if depth_variants:
        for units in (1, 2):
            cfg_u, _ = reduced_depth(cfg, units)
            result[f"depth{units}"] = analyze_cell(cfg_u, shape, mesh, overrides or None)
        result["scan_units_full"] = reduced_depth(cfg, 1)[1]
    return result


def cell_path(arch: str, shape_name: str, multi_pod: bool, tag: str = "") -> str:
    mesh = "multi" if multi_pod else "single"
    suffix = f".{tag}" if tag else ""
    return os.path.join(RESULTS_DIR, f"{arch}.{shape_name}.{mesh}{suffix}.json")


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape.name) for arch in ARCH_IDS for shape in get_config(arch).shapes()]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--depth-variants", action="store_true",
                    help="also count L=1/L=2 variants (debug cross-check)")
    ap.add_argument("--tag", default="", help="result-file suffix for perf experiments")
    ap.add_argument("--set", action="append", default=[],
                    help="context override k=v (seq_parallel, n_parts, moe_mode, "
                    "state_method, tp_mode, cfg.<field>)")
    ap.add_argument("--reanalyze", action="store_true",
                    help="refused: the port stores no HLO to analyze again")
    args = ap.parse_args(argv)

    if args.reanalyze:
        raise SystemExit("--reanalyze: the port compiles no program and stores no HLO; run the "
                         "cells again (--force)")
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    overrides: dict = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = (v == "true" if v in ("true", "false") else
                        int(v) if v.isdigit() else v)

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(RESULTS_DIR, exist_ok=True)

    ok = fail = skip = 0
    for arch, shape_name in cells:
        for mesh_kind in meshes:
            multi = mesh_kind == "multi"
            path = cell_path(arch, shape_name, multi, args.tag)
            if os.path.exists(path) and not args.force:
                skip += 1
                continue
            label = f"{arch} x {shape_name} x {mesh_kind}"
            try:
                res = run_cell(arch, shape_name, multi, overrides or None,
                               depth_variants=args.depth_variants and not multi, tag=args.tag)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                m = res["full"]["memory"]
                print(f"PASS {label}: meta run={res['compile_s']}s "
                      f"peak={m['peak']/1e9:.2f}GB args={m['argument']/1e9:.2f}GB "
                      f"fits={res['fits_16gb']} hbm_fits={res['hbm_fits']} "
                      f"flops={res['full']['flops']:.3e} "
                      f"wire={res['full']['wire_bytes']/1e9:.3f}GB", flush=True)
                ok += 1
            except Exception as e:
                fail += 1
                print(f"FAIL {label}: {type(e).__name__}: {e}", flush=True)
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
    print(f"done: {ok} pass, {fail} fail, {skip} cached", flush=True)
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
