"""Parameters split over the data axes (FSDP) in the port's mesh step
(``repro_torch.train.train_loop``), against the JAX package's sharded step,
on the CPU.

Reduced grok-1-314b (2 layers, 4 experts in 4 slots, ``fsdp_experts``) on a
``(2, 4)`` mesh over ``("data", "model")``: the specs are JAX's
``param_pspecs(..., fsdp_experts=True)`` and ``zero1_pspecs``
(``train/train_loop.train_pspecs``), so each layer's slot-stacked expert
weights, and their moments, live on one data rank.  All four dtypes are
f32 (grok accumulates gradients and keeps moments in bf16, which would
round in another order than XLA's).  Expert parallelism over the model
axis (``moe_mode="ep"``), as the dry-run trains grok.

* The mesh step against JAX's jitted step on 8 virtual CPU devices with the
  state placed by ``NamedSharding`` as those specs say, 3 steps from one
  state: losses within 1e-5 relative, every leaf of the parameters and of
  both moments within 1e-4 relative L2 (f32 sums in other orders, carried
  through 3 AdamW steps), as ``test_torch_train_mesh.py`` holds the
  non-FSDP step.
* FSDP against the same step without it, bitwise: the gradients' rank-ordered
  sums and the AdamW update are the same arithmetic either way.
* The layout: the expert stacks' parameters are ``Pinned`` to their layer's
  data rank; each data rank's pass all-gathers them over the data axes
  (``OP_LOG``), and stage 6 gathers nothing over the data axes for them.
* The dry-run's grok-1-314b ``train_4k`` cell on the ``(16, 16)``
  production mesh at 16 layers (the least depth whose layer axis the 16
  data ranks split) passes.
* A checkpoint of an FSDP state through the ``Trainer`` restores onto
  ``(1, 4)`` (one data rank: every layer pinned to it), and the run goes on
  as the uninterrupted one switched there without a checkpoint.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs import get_config as j_get_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import compat as j_compat
from repro.models import build_model as j_build_model
from repro.parallel import sharding as j_shd
from repro.parallel.context import ParallelContext as JCtx
from repro.train import train_loop as JT
from test_torch_models_hybrid import random_tree
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.core import transport
from repro_torch.core.mesh import make_mesh
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_jax, train_state_to_numpy
from repro_torch.parallel.context import ParallelContext
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_loop as T
from repro_torch.train.fault_tolerance import Pinned, reshard_state
from repro_torch.train.optimizer import tree_leaves

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

ARCH = "grok-1-314b"
AXES = ("data", "model")
SHAPE = (2, 4)
STEPS, BATCH, SEQ = 3, 8, 32
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
F32 = dict(dtype="float32", param_dtype="float32", opt_state_dtype="float32",
           grad_accum_dtype="float32")
EXPERTS = ("w_gate", "w_up", "w_down")


def _cfgs(fsdp: bool = True):
    upd = dict(F32, fsdp_experts=fsdp)
    return (get_config(ARCH).reduced().with_updates(**upd),
            j_get_config(ARCH).reduced().with_updates(**upd))


@functools.lru_cache(maxsize=None)
def _jax_init() -> dict:
    """A fresh train state in JAX's layout (numpy): parameters drawn at JAX
    init's statistics (no JAX init compiles), zero moments, step 0."""
    params = random_tree(j_build_model(_cfgs()[1]).init, 5)
    zeros = jax.tree.map(np.zeros_like, params)
    return {"params": params, "opt": {"m": zeros, "v": zeros, "step": np.zeros((), np.int32)}}


def _ctx(mesh) -> ParallelContext:
    return ParallelContext(mesh=mesh, moe_mode="ep")


def _port_run(state, n, shape=SHAPE, fsdp=True, start=0, log=None):
    """The port's mesh step with JAX's specs (FSDP or not), ``n`` steps from
    a global state: the losses, the stacked state, the step and the mesh;
    ``log``, a list, receives ``OP_LOG``'s entries of the first step."""
    cfg = _cfgs(fsdp)[0]
    mesh = make_mesh(shape, AXES, device="cpu")
    model = build_model(cfg, "cpu")
    like = T.init_state(model, OptimizerConfig(**OPT), "meta")
    step = T.make_train_step(model, OptimizerConfig(**OPT), _ctx(mesh), 1,
                             shardings=T.train_pspecs(cfg, like, mesh, ("data",)))
    state = reshard_state(state, mesh, step.placed)
    data = SyntheticLM(cfg, BATCH, SEQ, seed=0)
    losses = []
    for i in range(start, start + n):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        outer, transport.OP_LOG = transport.OP_LOG, ([] if log is not None else None)
        try:
            state, met = step(state, batch)
        finally:
            if log is not None and i == start:
                log.extend(transport.OP_LOG)
            transport.OP_LOG = outer
        losses.append(met["loss"].item())
    return losses, state, step, mesh


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def test_fsdp_mesh_step_matches_jax_sharded_step():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest)")
    cfg, jcfg = _cfgs()
    init = _jax_init()
    jmodel = j_build_model(jcfg)
    jmesh = j_compat.make_mesh(SHAPE, AXES, devices=jax.devices()[:8])
    jctx = JCtx(mesh=jmesh, moe_mode="ep")
    pkw = dict(model_axis="model", model_size=SHAPE[1], fsdp_experts=True, data_axes=("data",),
               mesh=jmesh)
    pspec = j_shd.param_pspecs(init["params"], **pkw)
    mspec = j_shd.zero1_pspecs(init["opt"]["m"], j_shd.param_pspecs(init["opt"]["m"], **pkw),
                               data_axes=("data",), mesh=jmesh)
    assert any(tuple(s)[:1] == ("data",) for s in jax.tree.leaves(
        pspec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    specs = {"params": pspec, "opt": {"m": mspec, "v": mspec,
                                      "step": jax.sharding.PartitionSpec()}}
    jstate = jax.tree.map(lambda x, s: jax.device_put(np.asarray(x), NamedSharding(jmesh, s)),
                          init, specs)
    jstep = _jitr(JT.make_train_step(jmodel, JOptimizerConfig(**OPT), jctx))
    data = SyntheticLM(cfg, BATCH, SEQ, seed=0)
    want_losses = []
    with j_compat.set_mesh(jmesh):
        for i in range(STEPS):
            jstate, met = jstep(jstate, {k: jnp.asarray(v) for k, v in data.batch_at(i).items()})
            want_losses.append(float(met["loss"]))
    want = jax.tree.map(np.asarray, jstate)

    losses, state, step, mesh = _port_run(train_state_from_jax(cfg, init, "cpu"), STEPS)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = train_state_to_numpy(cfg, T.gather_state(state, mesh, step.placed))
    assert int(got["opt"]["step"]) == STEPS
    for a, b in ((got["params"], want["params"]), (got["opt"]["m"], want["opt"]["m"]),
                 (got["opt"]["v"], want["opt"]["v"])):
        worst = max(_rel_l2(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                                                  strict=True))
        assert worst <= 1e-4, worst
    assert _rel_l2(jax.tree.leaves(want["params"])[0],
                   jax.tree.leaves(init["params"])[0]) > 1e-3


@pytest.mark.parametrize("n_parts", [1, 2])
def test_fsdp_is_bitwise_the_step_without_it(n_parts):
    cfg = _cfgs()[0]
    init = train_state_from_jax(cfg, _jax_init(), "cpu")
    out = {}
    for fsdp in (True, False):
        mesh = make_mesh(SHAPE, AXES, device="cpu")
        c = _cfgs(fsdp)[0]
        model = build_model(c, "cpu")
        like = T.init_state(model, OptimizerConfig(**OPT), "meta")
        step = T.make_train_step(model, OptimizerConfig(**OPT),
                                 ParallelContext(mesh=mesh, moe_mode="ep", n_parts=n_parts), 1,
                                 shardings=T.train_pspecs(c, like, mesh, ("data",)))
        state = reshard_state(init, mesh, step.placed)
        data = SyntheticLM(c, BATCH, SEQ, seed=0)
        losses = []
        for i in range(2):
            state, met = step(state, {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()})
            losses.append(met["loss"].item())
        out[fsdp] = losses, T.gather_state(state, mesh, step.placed)
    assert out[True][0] == out[False][0]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(out[True][1]),
                                                           tree_leaves(out[False][1])))


def test_fsdp_layout_and_stage_one_all_gathers():
    """The expert stacks' parameters are pinned to their layer's data rank
    (one layer on each of the 2), the other parameters are on every data
    rank; the last data rank's pass all-gathers each expert leaf over the 2
    data ranks (its layer's model shard) besides over the 4 model ranks as
    without FSDP, and stage 6's ring all-gather over the data ranks (one
    hop a leaf: a ``collective-permute``) skips the expert stacks."""
    cfg = _cfgs()[0]
    init = train_state_from_jax(cfg, _jax_init(), "cpu")
    log: list = []
    _, state, step, mesh = _port_run(init, 1, log=log)
    pinned = 0
    for (path, leaf), spec in zip(tree_leaves(state["params"]),
                                  T._spec_leaves(step.placed["params"])):
        if path[0] == "layers" and path[-1] in EXPERTS:
            pinned += 1
            assert isinstance(spec, Pinned) and spec.coords == (path[1],), path
            assert leaf.shape[:2] == (1, 4)
        else:
            assert not isinstance(spec, Pinned) and leaf.shape[:2] == (2, 4), path
    assert pinned == cfg.n_layers * len(EXPERTS)
    shard = {leaf.numel() // 4 * leaf.element_size()
             for path, leaf in tree_leaves(state["params"]) if path[-1] in EXPERTS}
    over_data = [e for e in log if e[0] == "all-gather" and e[2] == SHAPE[0]]
    assert len(over_data) == cfg.n_layers * len(EXPERTS)
    assert {e[1] for e in over_data} <= shard
    log_plain: list = []
    _port_run(init, 1, fsdp=False, log=log_plain)
    assert not [e for e in log_plain if e[0] == "all-gather" and e[2] == SHAPE[0]]
    assert sorted(e for e in log if e[2] == SHAPE[1]) == sorted(
        e for e in log_plain if e[2] == SHAPE[1])
    like = T.init_state(build_model(cfg, "cpu"), OptimizerConfig(**OPT), "meta")
    groups = T._groups(like["params"], T.train_pspecs(cfg, like, mesh, ("data",)), ("data",))
    assert sum(g.fsdp for g in groups) == len(EXPERTS)
    hops = [sum(e[0] == "collective-permute" for e in x) for x in (log, log_plain)]
    assert hops == [sum(g.zero is not None and not g.fsdp for g in groups),
                    sum(g.zero is not None for g in groups)]


def test_fsdp_refuses_other_data_splits():
    cfg = _cfgs()[0]
    model = build_model(cfg, "cpu")
    like = T.init_state(model, OptimizerConfig(**OPT), "meta")
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    specs = T.train_pspecs(cfg, like, mesh, ("data",))
    specs["params"]["embed"] = ("data", None)  # a data split off any layer axis
    with pytest.raises(NotImplementedError, match="FSDP.*embed.*stacked layer axis"):
        T.make_train_step(model, OptimizerConfig(**OPT), _ctx(mesh), 1, shardings=specs)


def test_dryrun_grok_train_cell_on_the_production_mesh():
    """grok-1-314b x ``train_4k`` on ``(16, 16)`` at 16 layers (one a data
    rank): the cell runs, and its collectives hold one all-gather over the
    16 data ranks for each of the 16 layers' 3 expert stacks."""
    cfg = D.reduced_depth(get_config(ARCH), 16)[0]
    assert cfg.fsdp_experts
    mesh = make_production_mesh()
    step, args, _, specs = D.build_cell(cfg, SHAPES["train_4k"], mesh)
    pinned = [s for s in T._spec_leaves(specs[0]["params"]) if isinstance(s, Pinned)]
    assert len(pinned) == 16 * len(EXPERTS)
    assert sorted({s.coords for s in pinned}) == [(d,) for d in range(16)]
    rec = D.analyze_cell(cfg, SHAPES["train_4k"], mesh)
    assert rec["coll_counts"]["all-gather"] >= 16 * len(EXPERTS)
    assert 0 < rec["memory"]["peak"] <= 80e9  # fits the card's HBM


def test_fsdp_checkpoint_restores_onto_one_data_rank(tmp_path):
    cfg = _cfgs()[0]
    init = train_state_from_jax(cfg, _jax_init(), "cpu")
    model = build_model(cfg, "cpu")
    like = T.init_state(model, OptimizerConfig(**OPT), "meta")
    ckpt.save(init, str(tmp_path), 0)

    def trainer(shape, steps):
        mesh = make_mesh(shape, AXES, device="cpu")
        run = RunConfig(model=cfg, shape=ShapeConfig("fsdp", SEQ, BATCH, "train"),
                        optimizer=OptimizerConfig(**OPT), steps=steps,
                        checkpoint_dir=str(tmp_path), checkpoint_every=2,
                        async_checkpoint=False, log_every=0)
        return T.Trainer(model, run, ctx=_ctx(mesh),
                         shardings=T.train_pspecs(cfg, like, mesh, ("data",)))

    first = trainer(SHAPE, 2)
    r1 = first.run()
    assert ckpt.latest_step(str(tmp_path)) == 2
    second = trainer((1, 4), 3)
    assert all(isinstance(s, Pinned) and s.coords == (0,)
               for (path, _), s in zip(tree_leaves(like["params"]),
                                       T._spec_leaves(second.placed["params"]))
               if path[-1] in EXPERTS)
    r2 = second.run()
    assert len(r1.losses) == 2 and len(r2.losses) == 1

    # the uninterrupted run on (2, 4), switched to (1, 4) at step 2
    mb = first.microbatches
    mesh = make_mesh(SHAPE, AXES, device="cpu")
    step = T.make_train_step(model, OptimizerConfig(**OPT), _ctx(mesh), mb,
                             shardings=T.train_pspecs(cfg, like, mesh, ("data",)))
    state = reshard_state(init, mesh, step.placed)
    data = SyntheticLM(cfg, BATCH, SEQ, seed=0)
    for i in range(2):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()})
    assert met["loss"].item() == r1.losses[-1]
    switched = T.gather_state(state, mesh, step.placed)
    small = make_mesh((1, 4), AXES, device="cpu")
    step2 = T.make_train_step(model, OptimizerConfig(**OPT), _ctx(small), second.microbatches,
                              shardings=T.train_pspecs(cfg, like, small, ("data",)))
    state2 = reshard_state(switched, small, step2.placed)
    _, met = step2(state2, {k: torch.from_numpy(v) for k, v in data.batch_at(2).items()})
    assert met["loss"].item() == r2.losses[0]
