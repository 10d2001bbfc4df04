"""Training loop: the step factory and the fault-tolerant driver (PyTorch
port of ``src/repro/train/train_loop.py``).

The JAX step is one jitted program; the port's runs eagerly: the loss's
backward through autograd (on the card the attention's backward is the
hand-written ``flash_attention_bwd`` kernel), then the f32 AdamW update in
place under ``torch.no_grad``.  Capturing the step as a CUDA graph is
ROADMAP Queue 1 item 22.  Training on a mesh (data-parallel, ZeRO-1,
tensor-parallel on stacked ranks) is item 21: a context with a mesh
raises.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.core.compat import torch_dtype
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models.api import Model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.context import LOCAL, ParallelContext
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import (
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
)
from repro_torch.train.optimizer import (
    adamw_update,
    compress_grads,
    init_opt_state,
    tree_leaves,
    tree_unflatten,
)

log = logging.getLogger("repro_torch.train")

TrainState = dict  # {"params": ..., "opt": {"m", "v", "step"}}


def _refuse_mesh(ctx: ParallelContext) -> None:
    if ctx.mesh is not None:
        raise NotImplementedError("training on a mesh (data-parallel, ZeRO-1, tensor-parallel "
                                  "on stacked ranks) waits for ROADMAP Queue 1 item 21")


def make_train_step(model: Model, opt_cfg: OptimizerConfig, ctx: ParallelContext = LOCAL,
                    microbatches: int = 1) -> Callable:
    """``(state, batch) -> (state, metrics)``; the state's tensors are
    updated in place and returned.

    ``microbatches > 1`` takes each equal batch slice's gradients with
    ``torch.autograd.grad`` and adds them into accumulators of
    ``model.cfg.grad_accum_dtype``, then divides and casts to the parameter
    dtype, as JAX's scan does (``.backward()`` into ``.grad`` would
    accumulate in the parameter dtype instead)."""
    _refuse_mesh(ctx)
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


def microbatches_of(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The step's gradient accumulation: ``cfg.train_microbatches``, cut
    until it divides the global batch (JAX's ``launch/dryrun._microbatches``
    on one data rank, the only layout the port trains on)."""
    if shape.kind != "train" or cfg.train_microbatches <= 1:
        return 1
    mb = min(cfg.train_microbatches, max(1, shape.global_batch))
    while shape.global_batch % mb:
        mb -= 1
    return max(1, mb)


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
    :func:`microbatches_of` the model's config and the run's shape.
    """

    def __init__(self, model: Model, run_cfg: RunConfig, ctx: ParallelContext = LOCAL,
                 injector: FailureInjector | None = None):
        _refuse_mesh(ctx)
        self.model = model
        self.run_cfg = run_cfg
        self.ctx = ctx
        self.injector = injector or FailureInjector(enabled=False)
        self.monitor = StragglerMonitor(ewma=run_cfg.straggler_ewma,
                                        factor=run_cfg.straggler_factor)
        self.microbatches = microbatches_of(model.cfg, run_cfg.shape)
        self.step_fn = make_train_step(model, run_cfg.optimizer, ctx, self.microbatches)
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
        if self.run_cfg.resume and d and ckpt.latest_step(d) is not None:
            like = init_state(self.model, opt, "meta")
            state, step = ckpt.restore(d, like=like, device=self.model.device)
            log.info("restored checkpoint at step %d", step)
            return state, step
        return init_state(self.model, opt, self.run_cfg.seed), 0

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
                    if self.checkpointer is not None:
                        self.checkpointer.save(state, step + 1)
                    else:
                        ckpt.save(state, cfg.checkpoint_dir, step + 1,
                                  keep=cfg.keep_checkpoints)
        finally:
            prefetch.stop()
        if self.checkpointer is not None:
            self.checkpointer.wait()
        first = tree_leaves(state["params"])[0][1]  # embed, JAX's first leaf
        return TrainResult(
            steps_done=cfg.steps,
            losses=losses,
            restarts=self.restarts,
            straggler_flags=len(self.monitor.flagged),
            checksum=float(torch.mean(first.detach().float())),
            step_seconds=self.step_seconds,
        )
