"""Phase N of ``chip_smoke.py``: training on a mesh of stacked ranks.

* N1, the ring KV hop's backward (``RingHopFn``, ``core/ring.py``): at
  llama3-8b's and stablelm-1.6b's ring KV shapes (a 4096-token sequence
  over 4 stacked ranks of a ``(1, 4)`` mesh: ``(2, 1, 1024, 8, 128)`` and
  ``(2, 1, 1024, 32, 64)`` a rank, bf16), ``n_parts`` 1 and 4, the
  ``cuda`` packer (``gather_pack`` and ``copy_convert``): the hop's output
  must be the ring predecessor's block and the gradient the cotangent sent
  back to it, bitwise, and both equal to the ``slice`` packer's on the
  card; the kernels' launches in the backward are printed and must be
  ``n_parts`` gathers and 2 x ``n_parts`` copies (K and V each round).
* N2, stablelm-1.6b at full width and depth (random bf16 weights from
  seed 0, f32 moments) trains through the ``Trainer`` on a ``(2, 4)``
  ``("data", "model")`` mesh with phase L2's data (2 x 4096 tokens, one
  sequence a data rank), steps 0-1; the state at step 2, gathered to the
  host, is placed onto ``(2, 2)`` by ``reshard_state`` for steps 2-3.
  Held: (a) step 0's loss within ``LOSS_TOL`` of L2's one-card ``Trainer``
  on the same weights and data, (b) steps 1-3 likewise, (c) after the
  first step on each mesh every leaf in the stacked layout of
  ``state_pspecs`` (its shape, and its replicas equal).  Then the restart
  through a checkpoint, at ``N2_CKPT_LAYERS`` layers (the full model's
  16.5 GB checkpoint took most of the phase): steps 0-1 on ``(2, 4)``, a
  checkpoint at step 2 (the gathered global state, under ``build/``,
  removed after), a ``Trainer`` on ``(2, 2)`` restores it through
  ``reshard_state`` and runs steps 2-3; (d) its losses bitwise equal to
  the same state switched without a checkpoint or, if not, within
  ``LOSS_TOL`` with the difference printed, and its layouts as in (c).
  Prints ms a step (median of steps 1-3, host clock ending with the loss
  read back) beside L2's, the peak memory, the collectives of step 1
  (``comm_analysis.count_collectives``: ops and wire bytes), and one
  traced step's device time by kernel and its idle share.
* N3, gradients through the ring paths: stablelm-1.6b at full width and 2
  layers, in f32 (the flash kernels' CUDA-core route locally, so the bound
  reads the ring paths' order of sums, not bf16 rounding), one sequence of
  4096 tokens, on a ``(1, 4)`` mesh: ``seq_parallel=True`` with
  ``comm_packer="cuda"`` (ring attention, the pack kernels forward and
  backward), then ``tp_mode="ring"`` (the ring collective-matmul MLP), each
  at ``n_parts`` 1 and 4.  The loss and every gradient leaf within
  ``GRAD_TOL`` relative L2 of the same loss under the local context; the
  pack kernels must launch in the ring-attention backward.

* N4, parameters split over the data axes (FSDP): phi3.5-moe-42b-a6.6b at
  full width and 2 of its 32 layers (2.86 B parameters, bf16, f32
  moments), ``moe_mode="ep"`` on a ``(2, 16)`` mesh (one expert slot a
  model rank, as ``check_ep_mesh`` requires), synthetic data (one
  sequence of ``N4_SEQ`` = 1024 tokens a data rank), 2 steps from one
  state: once with the specs of ``fsdp_experts=True``
  (``train/train_loop.train_pspecs``: each layer's expert stacks, and
  their moments, on one data rank, all-gathered over the data ranks
  before each rank's pass), once without (the expert
  stacks on every data rank, ZeRO-1 moments).  The losses and the gathered
  parameters and moments must be bitwise equal (the gradients' sums are
  rank-ordered either way).  Prints ms a step, the peak memory and the
  second step's collectives of each.

``chip_smoke.py`` calls :func:`mesh_phase` after phase M, handing it L2's
record; alone (it runs L2 first)::

    PYTHONPATH=src python3 tools/train_mesh_lm.py [--phases N1,N2,N3,N4]
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import shutil
import statistics
import sys
import tempfile
import time

import train_lm
from train_lm import FLASH_KERNELS, PhaseFailure, kernel_device_ms

STABLELM = "stablelm-1.6b"
TRAIN_SEQ, TRAIN_BATCH = train_lm.TRAIN_SEQ, train_lm.TRAIN_BATCH
#: relative difference of a loss from L2's one-card run (and of a
#: restarted loss from the uninterrupted one where they are not bitwise):
#: the same per-sequence forward, the clip's global norm summed in another
#: order
LOSS_TOL = 1e-3
#: relative L2 of the ring paths' loss and each gradient leaf against the
#: local context's, f32: the ring's online softmax and ring matmuls sum in
#: another order than the flash kernel and one matmul
GRAD_TOL = 1e-3
RING = 4
#: (B, S a rank, Hkv, D) of each ring KV hop checked in N1
HOP_SHAPES = {"llama3-8b": (1, TRAIN_SEQ // RING, 8, 128),
              "stablelm-1.6b": (1, TRAIN_SEQ // RING, 32, 64)}
BIG, SMALL = (2, 4), (2, 2)
N2_STEPS, N2_SWITCH = 4, 2
#: layers of N2's restart through a checkpoint
N2_CKPT_LAYERS = 2
N3_LAYERS = 2
PACK_KERNELS = ("gather_pack", "copy_convert")
N4_ARCH, N4_LAYERS, N4_MESH, N4_STEPS = "phi3.5-moe-42b-a6.6b", 2, (2, 16), 2
#: N4's tokens a data rank (one sequence): at L2's 4096 the card's peak,
#: with what the earlier phases hold, came to 77.0 GB of its 79.2
N4_SEQ = 1024


def hop_backward_checks(torch, dev, fails: list) -> dict:
    """N1; appends to ``fails``."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.ring import RingHopFn, ring_kv_plan
    from repro_torch.core.transport import resolve_packer, resolve_transport
    from repro_torch.kernels import _build

    mesh = make_mesh((1, RING), ("data", "model"), device=dev)
    src = torch.tensor([(r - 1) % RING for r in range(RING)], device=dev)
    out: dict = {"cases": []}
    for name, (b, s, h, d) in HOP_SHAPES.items():
        gen = torch.Generator(dev).manual_seed(0)
        kv = torch.randn((RING, 2, b, s, h, d), generator=gen, device=dev).bfloat16()
        cot = torch.randn(kv.shape, generator=gen, device=dev).bfloat16()
        for n_parts in (1, 4):
            got = {}
            case = dict(config=name, kv_shape=list(kv.shape[1:]), n_parts=n_parts)
            for packer in ("cuda", "slice"):
                plan = dict(n_parts=n_parts, packer=resolve_packer(packer),
                            transport=resolve_transport("loopback"), coalesce=True)
                hop = ring_kv_plan(mesh, "model", tuple(kv.shape[1:]), kv.dtype, **plan)
                back = ring_kv_plan(mesh, "model", tuple(kv.shape[1:]), kv.dtype, shift=-1,
                                    **plan)
                x = kv.clone().requires_grad_(True)
                y = RingHopFn.apply(x, hop, back)
                torch.cuda.synchronize()
                _build.reset_launches()
                (g,) = torch.autograd.grad(y, x, cot)
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)
                case[f"{packer}_forward_bitwise"] = bool(torch.equal(y, kv[src]))
                case[f"{packer}_backward_bitwise"] = bool(torch.equal(g[src], cot))
                case[f"{packer}_backward_launches"] = launches
                got[packer] = (y, g)
            case["cuda_equals_slice"] = all(torch.equal(a, c)
                                            for a, c in zip(got["cuda"], got["slice"]))
            want = {"gather_pack": n_parts, "copy_convert": 2 * n_parts}
            ok = (all(case[f"{p}_{w}_bitwise"] for p in ("cuda", "slice")
                      for w in ("forward", "backward"))
                  and case["cuda_equals_slice"] and case["cuda_backward_launches"] == want
                  and not case["slice_backward_launches"])
            case["ok"] = ok
            print(f"N1 hop backward {name} {case['kv_shape']} n_parts={n_parts}: "
                  f"{json.dumps(case)}", flush=True)
            if not ok:
                fails.append(f"N1 {name} n_parts={n_parts}: {case}")
            out["cases"].append(case)
            del got
        del kv, cot
    return out


def _layout_errors(torch, state, mesh, placed, like) -> list[str]:
    """Leaves of a stacked ``state`` whose shape is not the stacked layout
    of their spec or whose replicas differ (the spec's layout of their own
    global array)."""
    from repro_torch.train.fault_tolerance import _from_stacked, _to_stacked
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import _spec_leaves

    bad = []
    for part in (("params",), ("opt", "m"), ("opt", "v")):
        tree, specs, shapes = state, placed, like
        for key in part:
            tree, specs, shapes = tree[key], specs[key], shapes[key]
        for (path, leaf), spec, (_, meta) in zip(tree_leaves(tree), _spec_leaves(specs),
                                                 tree_leaves(shapes), strict=True):
            want = tuple(_to_stacked(meta, mesh, spec).shape)
            same = (tuple(leaf.shape) == want
                    and torch.equal(leaf, _to_stacked(_from_stacked(leaf, mesh, spec), mesh,
                                                      spec)))
            if not same:
                bad.append("/".join(map(str, (*part, *path))))
    return bad


def _trainer_run(torch, trainer, seen: dict, tag: str, like, count_at=None):
    """``trainer.run()`` with its step wrapped: the layout check after its
    first call, the collective count at call ``count_at``, the last state
    kept in ``seen[tag + "_state"]``; returns the result, the unwrapped
    step and the launches of the run."""
    from repro_torch.core.comm_analysis import count_collectives
    from repro_torch.kernels import _build

    inner, mesh = trainer.step_fn, trainer.ctx.mesh

    def step(state, batch):
        i = seen.setdefault(f"{tag}_calls", 0)
        seen[f"{tag}_calls"] = i + 1
        if i == count_at:
            stats = count_collectives(inner, state, batch)
            state, met = stats.result
            seen["collectives"] = dict(ops=stats.by_op_counts, wire_bytes=stats.wire_bytes,
                                       wire_bytes_by_op=stats.by_op_bytes)
        else:
            state, met = inner(state, batch)
        if i == 0:
            seen[f"{tag}_layout_errors"] = _layout_errors(torch, state, mesh, trainer.placed,
                                                          like)
        seen[f"{tag}_state"] = state
        return state, met

    trainer.step_fn = step
    torch.cuda.synchronize()
    _build.reset_launches()
    res = trainer.run()
    torch.cuda.synchronize()
    return res, inner, dict(_build.LAUNCHES)


def _switched_steps(torch, model, opt, ctx, state, batches: list, like) -> dict:
    """The steps of ``batches`` on ``ctx.mesh`` from a global ``state``
    placed there (a step timed as the ``Trainer`` times it: host clock,
    ending with the loss read back); the layout check after the first."""
    from repro_torch.kernels import _build
    from repro_torch.train.fault_tolerance import reshard_state
    from repro_torch.train.train_loop import make_train_step

    step = make_train_step(model, opt, ctx, 1)
    state = reshard_state(state, ctx.mesh, step.placed)
    losses, secs, layout = [], [], None
    torch.cuda.synchronize()
    _build.reset_launches()
    for batch in batches:
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(met["loss"].item())
        secs.append(time.perf_counter() - t0)
        if layout is None:
            layout = _layout_errors(torch, state, ctx.mesh, step.placed, like)
    torch.cuda.synchronize()
    return dict(losses=losses, secs=secs, layout_errors=layout, launches=dict(_build.LAUNCHES))


def mesh_training(torch, dev, fails: list, l2: dict) -> dict:
    """N2; appends to ``fails``.  ``l2`` is phase L2's record."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.train.train_loop import Trainer, gather_state, init_state

    cfg = get_config(STABLELM)
    model = build_model(cfg, dev)
    opt = OptimizerConfig()
    like = init_state(model, opt, "meta")
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()}

    ctx = {m: ParallelContext(mesh=make_mesh(m, ("data", "model"), device=dev))
           for m in (BIG, SMALL)}
    run = RunConfig(model=cfg, shape=ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
                    optimizer=opt, steps=N2_SWITCH, log_every=1)
    out: dict = dict(config=STABLELM, params=cfg.param_count(), seq=TRAIN_SEQ,
                     batch=TRAIN_BATCH, meshes=[list(BIG), list(SMALL)], steps=N2_STEPS,
                     switch_at=N2_SWITCH)
    seen: dict = {}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # -- steps 0-1 on (2, 4) through the Trainer -----------------------------
    first = Trainer(model, run, ctx=ctx[BIG])
    if first.microbatches != 1:
        fails.append(f"N2: {first.microbatches} microbatches, want 1 (one sequence a rank)")
    t0 = time.perf_counter()
    res_a, inner_big, launches = _trainer_run(torch, first, seen, "big", like, count_at=1)
    out["run_a_s"] = time.perf_counter() - t0
    state = seen.pop("big_state")
    # the state at step 2, off the card
    t0 = time.perf_counter()
    switched = gather_state(state, ctx[BIG].mesh, first.placed, "cpu")
    out["gather_s"] = time.perf_counter() - t0
    # one traced step on (2, 4) (it moves this state on; the copy stays)
    batch = batch_at(N2_SWITCH)
    trace = device_breakdown(lambda: inner_big(state, batch), n_cycles=1)
    out["idle_share"] = trace["idle_share"]
    out["trace_sessions"] = trace["sessions"]
    out["busy_ms"] = trace["busy_us_per_cycle"] / 1e3
    out["window_ms"] = trace["window_us_per_cycle"] / 1e3
    out["kernels_per_step"] = kernel_device_ms(trace, FLASH_KERNELS)
    out["top_kernels"] = trace["kernels"][:12]
    del state, batch, first, inner_big
    gc.collect()
    torch.cuda.empty_cache()

    # -- switched onto (2, 2), steps 2-3 ----------------------------------------
    t0 = time.perf_counter()
    b = _switched_steps(torch, model, opt, ctx[SMALL], switched,
                        [batch_at(i) for i in range(N2_SWITCH, N2_STEPS)], like)
    del switched
    out["run_b_s"] = time.perf_counter() - t0
    for k, n in b["launches"].items():
        launches[k] = launches.get(k, 0) + n
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()

    losses = res_a.losses + b["losses"]
    l2_losses = l2["losses"][:N2_STEPS]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, l2_losses)]
    secs = res_a.step_seconds[1:] + b["secs"]
    want = {"flash_attention": cfg.n_layers * BIG[0] * N2_STEPS,
            "flash_attention_bwd": 3 * cfg.n_layers * BIG[0] * N2_STEPS}
    out.update(
        losses=losses, l2_losses=l2_losses, rel_to_l2=rel,
        layout_errors={"big": seen.get("big_layout_errors"), "small": b["layout_errors"]},
        collectives=seen.get("collectives"), step_ms_each=[s * 1e3 for s in secs],
        step_ms=statistics.median(secs) * 1e3, l2_step_ms=l2["step_ms"],
        launches=launches, launches_want=want,
        timing="host clock around each step, ending with the loss read back; step_ms the "
               "median of steps 1-3 (0-based: one on (2, 4), two on (2, 2))")
    if len(losses) != N2_STEPS or not all(math.isfinite(x) for x in losses):
        fails.append(f"N2: losses {losses}")
    if max(rel, default=math.inf) > LOSS_TOL:
        fails.append(f"N2: losses {losses} against L2's {l2_losses}: relative {rel}")
    if any(out["layout_errors"][m] != [] for m in ("big", "small")):
        fails.append(f"N2: leaves off state_pspecs' layout: {out['layout_errors']}")
    if any(launches.get(k, 0) != n for k, n in want.items()):
        fails.append(f"N2: launches {launches}, want {want}")
    out["restart"] = checkpoint_restart(torch, dev, fails)
    print(f"N2 {STABLELM} on {BIG} switched onto {SMALL}: {json.dumps(out)}", flush=True)
    print(f"N2 step ms {out['step_ms']:.1f} (L2 {l2['step_ms']:.1f}), peak "
          f"{out['peak_bytes'] / 1e9:.1f} GB, idle share {out['idle_share']:.4f}, restart "
          f"bitwise {out['restart']['bitwise']}, collectives {json.dumps(out['collectives'])}",
          flush=True)
    return out


def checkpoint_restart(torch, dev, fails: list) -> dict:
    """N2's restart through a checkpoint, at ``N2_CKPT_LAYERS`` layers;
    appends to ``fails``."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.core.mesh import make_mesh
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.train.train_loop import Trainer, gather_state, init_state

    cfg = get_config(STABLELM).with_updates(n_layers=N2_CKPT_LAYERS)
    model = build_model(cfg, dev)
    opt = OptimizerConfig()
    like = init_state(model, opt, "meta")
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ)
    ctx = {m: ParallelContext(mesh=make_mesh(m, ("data", "model"), device=dev))
           for m in (BIG, SMALL)}
    build = pathlib.Path(__file__).resolve().parents[1] / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_mesh_", dir=build)
    run = RunConfig(model=cfg, shape=ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
                    optimizer=opt, steps=N2_SWITCH, log_every=1, checkpoint_dir=root,
                    checkpoint_every=N2_SWITCH, keep_checkpoints=1, async_checkpoint=False)
    out: dict = dict(layers=N2_CKPT_LAYERS, params=cfg.param_count())
    seen: dict = {}
    try:
        t0 = time.perf_counter()
        first = Trainer(model, run, ctx=ctx[BIG])
        _trainer_run(torch, first, seen, "big", like)
        switched = gather_state(seen.pop("big_state"), ctx[BIG].mesh, first.placed, "cpu")
        out["run_a_s"] = time.perf_counter() - t0
        del first
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        second = Trainer(model, dataclasses.replace(run, steps=N2_STEPS), ctx=ctx[SMALL])
        res_b, _, _ = _trainer_run(torch, second, seen, "small", like)
        out["run_b_s"] = time.perf_counter() - t0
        seen.pop("small_state", None)
        del second
        gc.collect()
        torch.cuda.empty_cache()
        ref = _switched_steps(torch, model, opt, ctx[SMALL], switched,
                              [{k: torch.from_numpy(v).to(dev)
                                for k, v in data.batch_at(i).items()}
                               for i in range(N2_SWITCH, N2_STEPS)], like)
        del switched
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(res_b.losses, ref["losses"])]
    out.update(restart_losses=res_b.losses, uninterrupted_losses=ref["losses"],
               bitwise=res_b.losses == ref["losses"], rel=rel,
               layout_errors={"big": seen.get("big_layout_errors"),
                              "small": seen.get("small_layout_errors")})
    if len(res_b.losses) != N2_STEPS - N2_SWITCH or (not out["bitwise"]
                                                      and max(rel) > LOSS_TOL):
        fails.append(f"N2 restart: {res_b.losses} against uninterrupted {ref['losses']}")
    if any(out["layout_errors"][m] != [] for m in ("big", "small")):
        fails.append(f"N2 restart: leaves off state_pspecs' layout: {out['layout_errors']}")
    print(f"N2 restart at {N2_CKPT_LAYERS} layers: {json.dumps(out)}", flush=True)
    return out


def ring_gradients(torch, dev, fails: list) -> dict:
    """N3; appends to ``fails``."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.parallel.context import LOCAL, ParallelContext
    from repro_torch.train.optimizer import tree_leaves

    cfg = get_config(STABLELM).with_updates(n_layers=N3_LAYERS, dtype="float32",
                                            param_dtype="float32")
    model = build_model(cfg, dev)
    params = model.init(0)
    leaves = [p.requires_grad_(True) for _, p in tree_leaves(params)]
    batch = {k: torch.from_numpy(v[:1]).to(dev)
             for k, v in SyntheticLM(cfg, 1, TRAIN_SEQ).batch_at(0).items()}

    def grads(ctx):
        loss = model.loss(params, batch, ctx=ctx)
        fwd = dict(_build.LAUNCHES)
        _build.reset_launches()
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.detach(), g, fwd, dict(_build.LAUNCHES)

    want_loss, want, _, _ = grads(LOCAL)
    mesh = make_mesh((1, RING), ("data", "model"), device=dev)
    out: dict = dict(config=STABLELM, layers=N3_LAYERS, dtype="float32", tokens=TRAIN_SEQ,
                     mesh=[1, RING], cases=[], launches={})
    for kind, kw in (("seq_parallel", dict(seq_parallel=True, comm_packer="cuda")),
                     ("ring_tp", dict(tp_mode="ring"))):
        for n_parts in (1, 4):
            _build.reset_launches()
            t0 = time.perf_counter()
            loss, got, fwd, bwd = grads(ParallelContext(mesh=mesh, n_parts=n_parts, **kw))
            wall = time.perf_counter() - t0
            errs = [train_lm.rel_err(g, w) for g, w in zip(got, want)]
            loss_rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
            worst = max(errs)
            for k, n in (*fwd.items(), *bwd.items()):
                out["launches"][k] = out["launches"].get(k, 0) + n
            case = dict(kind=kind, n_parts=n_parts, loss=loss.item(), local_loss=want_loss.item(),
                        loss_rel=loss_rel, worst_leaf_rel=worst, leaves=len(errs),
                        worst_leaf="/".join(map(str, tree_leaves(params)[errs.index(worst)][0])),
                        forward_launches=fwd, backward_launches=bwd, wall_s=wall)
            ok = loss_rel <= GRAD_TOL and worst <= GRAD_TOL
            if kind == "seq_parallel" and not all(bwd.get(k, 0) > 0 for k in PACK_KERNELS):
                ok = False
                fails.append(f"N3 {kind} n_parts={n_parts}: the pack kernels did not launch in "
                             f"the backward ({bwd})")
            case["ok"] = ok
            if not ok:
                fails.append(f"N3 {kind} n_parts={n_parts}: {case}")
            print(f"N3 {kind} n_parts={n_parts}: {json.dumps(case)}", flush=True)
            out["cases"].append(case)
            del got
    del params, leaves, want
    return out


def fsdp_training(torch, dev, fails: list) -> dict:
    """N4; appends to ``fails``."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, ShapeConfig
    from repro_torch.core.comm_analysis import count_collectives
    from repro_torch.core.mesh import make_mesh
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.train.fault_tolerance import Pinned, reshard_state
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import (
        _spec_leaves,
        gather_state,
        init_state,
        make_train_step,
        microbatches_of,
        train_pspecs,
    )

    base = get_config(N4_ARCH).with_updates(n_layers=N4_LAYERS)
    opt = OptimizerConfig()
    mesh = make_mesh(N4_MESH, ("data", "model"), device=dev)
    ctx = ParallelContext(mesh=mesh, moe_mode="ep")
    data = SyntheticLM(base, TRAIN_BATCH, N4_SEQ)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()}
               for i in range(N4_STEPS)]
    out: dict = dict(config=N4_ARCH, layers=N4_LAYERS, params=base.param_count(),
                     mesh=list(N4_MESH), moe_mode="ep", tokens_a_data_rank=N4_SEQ,
                     steps=N4_STEPS, runs={})
    got: dict = {}
    for fsdp in (True, False):
        cfg = base.with_updates(fsdp_experts=fsdp)
        model = build_model(cfg, dev)
        like = init_state(model, opt, "meta")
        mb = microbatches_of(cfg, ShapeConfig("chip", N4_SEQ, TRAIN_BATCH, "train"),
                             N4_MESH[0])
        step = make_train_step(model, opt, ctx, mb,
                               shardings=train_pspecs(cfg, like, mesh, ("data",)))
        pinned = sum(isinstance(sp, Pinned) for sp in _spec_leaves(step.placed["params"]))
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        # one initial state for both runs: made on the card from seed 0 (the
        # flag changes no draw) and placed; the whole copy is freed here
        state = reshard_state(init_state(model, opt, 0), mesh, step.placed)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses, secs, coll = [], [], None
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == N4_STEPS - 1:
                stats = count_collectives(step, state, batch)
                state, met = stats.result
                coll = dict(ops=stats.by_op_counts, wire_bytes=stats.wire_bytes,
                            wire_bytes_by_op=stats.by_op_bytes)
                del stats  # it holds the state, which the next run's memory needs
            else:
                state, met = step(state, batch)
            losses.append(met["loss"].item())
            secs.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        run = dict(fsdp=fsdp, microbatches=mb, pinned_param_leaves=pinned, losses=losses,
                   step_ms_each=[x * 1e3 for x in secs], step_ms=secs[-1] * 1e3,
                   peak_bytes=torch.cuda.max_memory_allocated() - base_bytes,
                   peak_bytes_whole=torch.cuda.max_memory_allocated(),
                   collectives=coll, launches=dict(_build.LAUNCHES), place_s=place_s)
        out["runs"]["fsdp" if fsdp else "no_fsdp"] = run
        t0 = time.perf_counter()
        got[fsdp] = (losses, gather_state(state, mesh, step.placed, "cpu"))
        run["gather_s"] = time.perf_counter() - t0
        print(f"N4 {N4_ARCH} x {N4_LAYERS} layers on {N4_MESH} fsdp={fsdp}: "
              f"{json.dumps(run)}", flush=True)
        del state, met, step, model
        gc.collect()
        torch.cuda.empty_cache()
    (la, sa), (lb, sb) = got[True], got[False]
    t0 = time.perf_counter()
    same = [torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(sa), tree_leaves(sb),
                                                        strict=True)]
    out.update(compare_s=time.perf_counter() - t0,
               losses_bitwise=la == lb, state_bitwise=all(same),
               leaves=len(same), leaves_differing=same.count(False),
               launches=out["runs"]["fsdp"]["launches"],
               timing="host clock around each step ending with the loss read back; step_ms "
                      "the second step's, which also counts its collectives")
    del got, sa, sb
    gc.collect()
    fsdp_run = out["runs"]["fsdp"]
    if fsdp_run["pinned_param_leaves"] != 3 * N4_LAYERS:
        fails.append(f"N4: {fsdp_run['pinned_param_leaves']} pinned parameter leaves, want "
                     f"{3 * N4_LAYERS} (each layer's expert stacks)")
    if out["runs"]["no_fsdp"]["pinned_param_leaves"]:
        fails.append("N4: the run without FSDP pinned parameters")
    if not (out["losses_bitwise"] and out["state_bitwise"]):
        fails.append(f"N4: FSDP {la} against {lb}; {out['leaves_differing']} of "
                     f"{out['leaves']} leaves differ")
    if not all(math.isfinite(x) for x in la):
        fails.append(f"N4: losses {la}")
    gathers = (fsdp_run["collectives"] or {}).get("ops", {}).get("all-gather", 0)
    plain = (out["runs"]["no_fsdp"]["collectives"] or {}).get("ops", {}).get("all-gather", 0)
    if gathers - plain != 3 * N4_LAYERS:
        fails.append(f"N4: {gathers} all-gathers with FSDP, {plain} without: want "
                     f"{3 * N4_LAYERS} more (each pinned leaf over the data ranks)")
    print(f"N4 FSDP {out['runs']['fsdp']['step_ms']:.1f} ms a step, peak "
          f"{fsdp_run['peak_bytes'] / 1e9:.2f} GB; without "
          f"{out['runs']['no_fsdp']['step_ms']:.1f} ms, peak "
          f"{out['runs']['no_fsdp']['peak_bytes'] / 1e9:.2f} GB; bitwise: losses "
          f"{out['losses_bitwise']}, state {out['state_bitwise']}", flush=True)
    return out


def mesh_phase(torch, dev, l2: dict, phases=("N1", "N2", "N3", "N4")) -> dict:
    """Phase N; raises :class:`train_lm.PhaseFailure` after printing
    everything when a check fails."""
    import gc

    fails: list[str] = []
    out: dict = {}
    steps = {"N1": hop_backward_checks, "N2": lambda t, d, f: mesh_training(t, d, f, l2),
             "N3": ring_gradients, "N4": fsdp_training}
    for name in phases:
        t0 = time.perf_counter()
        out[name] = steps[name](torch, dev, fails)
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"phase {name} took {out[name]['phase_s']:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["failures"] = fails
    if fails:
        raise PhaseFailure("; ".join(fails))
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="N1,N2,N3,N4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_mesh_lm: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s; card {torch.cuda.get_device_name(0)}",
          flush=True)
    dev = torch.device("cuda", 0)
    phases = tuple(args.phases.split(","))
    try:
        l2 = (train_lm.train_phase(torch, dev, ("L2",))["L2"] if "N2" in phases else {})
        out = mesh_phase(torch, dev, l2, phases)
    except PhaseFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    out_dir = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "train_mesh_lm.json").write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
