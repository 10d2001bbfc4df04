"""Training on a mesh of stacked ranks (``repro_torch.train.train_loop``
with ``ctx.mesh`` set) against the JAX package's sharded step, on the CPU.

* The mesh step: reduced llama3-8b and stablelm-1.6b in f32 on ``(2, 4)``
  and ``(4, 2)`` meshes over ``("data", "model")``, 3 steps from one state
  (parameters drawn with numpy at JAX init's statistics, zero moments,
  carried over by ``train_state_from_jax``)
  on the same ``SyntheticLM`` batches, against JAX's jitted step on 8
  virtual CPU devices with the state placed by ``NamedSharding`` as
  ``tests/distributed_progs/check_elastic.py`` places it.  Tolerances,
  stated: losses within 1e-5 relative, every leaf of the parameters and
  of both moments within 1e-4 relative L2 (f32 sums in other orders,
  carried through 3 AdamW steps).  Any ``n_parts`` gives the same bits.
* ``check_elastic.py``'s restart: 4 steps through the ``Trainer`` on
  ``(4, 2)``, a checkpoint, the restore onto ``(2, 2)`` and 3 more steps,
  against JAX's trajectory (1e-5 relative) and bitwise against the port's
  uninterrupted run switched to ``(2, 2)`` at step 4 without a checkpoint.
  A checkpoint of a mesh state is byte for byte a one-device checkpoint of
  the same state.  Two data axes (the multi-pod mesh's ``("pod",
  "data")``) train as their flattening does.
* Gradients through the ring paths (``check_models_dist.py``'s contexts on
  ``(2, 4)``: ring attention under ``seq_parallel``, the ring-TP MLP under
  ``tp_mode="ring"``) against ``jax.grad``, every leaf within 1e-4
  relative L2; the KV hop's backward (``RingHopFn``) and the loopback
  permute's are the inverse permutation of the cotangent, bitwise.
* ``python -m repro_torch.launch.train --mesh production --reduced
  --device cpu`` trains on the 256 stacked ranks of the production mesh.
"""

import functools
import json
import math
import os

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
from repro.parallel.context import ParallelContext as JCtx
from repro.train import train_loop as JT
from repro.train.fault_tolerance import reshard_state as j_reshard_state
from test_torch_models_hybrid import random_tree
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.core.mesh import make_mesh
from repro_torch.core.ring import ring_attention
from repro_torch.core.transport import resolve_transport, ring_perm
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
    train_state_from_jax,
    train_state_to_numpy,
)
from repro_torch.parallel.context import ParallelContext
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_loop as T
from repro_torch.train.fault_tolerance import Pinned, _to_stacked, reshard_state
from repro_torch.train.optimizer import tree_leaves

#: ``jax.jit`` with XLA's backend optimisation off, which about halves the
#: compile of a JAX reference here
_jitr = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})

torch.set_num_threads(1)

AXES = ("data", "model")
STEPS, BATCH, SEQ = 3, 8, 32
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
F32 = dict(dtype="float32", param_dtype="float32")


def _cfgs(arch: str, **upd):
    return (get_config(arch).reduced().with_updates(**F32, **upd),
            j_get_config(arch).reduced().with_updates(**F32, **upd))


def _need(n: int) -> None:
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices (conftest)")


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str) -> dict:
    """A fresh train state in JAX's layout (numpy): parameters drawn at
    JAX init's statistics (no JAX init compiles), zero moments, step 0."""
    params = random_tree(j_build_model(_cfgs(arch)[1]).init, 4)
    zeros = jax.tree.map(np.zeros_like, params)
    return {"params": params, "opt": {"m": zeros, "v": zeros,
                                      "step": np.zeros((), np.int32)}}


@functools.lru_cache(maxsize=None)
def _jax_program(arch: str, shape: tuple, microbatches: int):
    """JAX's jitted step on ``shape`` devices, its mesh and state specs,
    built once a cell."""
    _need(math.prod(shape))
    jmodel = j_build_model(_cfgs(arch)[1])
    jmesh = j_compat.make_mesh(shape, AXES, devices=jax.devices()[:math.prod(shape)])
    jctx = JCtx(mesh=jmesh)
    like = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, _jax_init(arch)))
    specs = JT.state_pspecs(jmodel, like, jmesh, jctx)
    step = _jitr(JT.make_train_step(jmodel, JOptimizerConfig(**OPT), jctx,
                                    microbatches=microbatches))
    return step, jmesh, specs


def _jax_run(arch, shape, microbatches, state, start, n):
    """``n`` JAX steps from the numpy ``state`` at batch ``start``: the
    losses and the final state (numpy)."""
    step, jmesh, specs = _jax_program(arch, shape, microbatches)
    state = jax.tree.map(lambda x, s: jax.device_put(np.asarray(x), NamedSharding(jmesh, s)),
                         state, specs)
    data = SyntheticLM(_cfgs(arch)[0], BATCH, SEQ, seed=0)
    losses = []
    with j_compat.set_mesh(jmesh):
        for i in range(start, start + n):
            state, met = step(state, {k: jnp.asarray(v) for k, v in data.batch_at(i).items()})
            losses.append(float(met["loss"]))
    return losses, jax.tree.map(np.asarray, state)


def _port_run(arch, shape, microbatches, state, start, n, n_parts=1):
    """The port's mesh step, ``n`` steps from a global state: the losses,
    the stacked state and the step."""
    cfg = _cfgs(arch)[0]
    mesh = make_mesh(shape, AXES, device="cpu")
    step = T.make_train_step(build_model(cfg, "cpu"), OptimizerConfig(**OPT),
                             ParallelContext(mesh=mesh, n_parts=n_parts), microbatches)
    state = reshard_state(state, mesh, step.placed)
    data = SyntheticLM(cfg, BATCH, SEQ, seed=0)
    losses = []
    for i in range(start, start + n):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()})
        losses.append(met["loss"].item())
    return losses, state, step, mesh


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def _assert_tree_close(got: dict, want: dict, tol: float) -> None:
    worst = max(_rel_l2(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                                              strict=True))
    assert worst <= tol, worst


@pytest.mark.parametrize("arch,shape,microbatches", [
    ("llama3-8b", (2, 4), 1), ("llama3-8b", (4, 2), 1),
    ("stablelm-1.6b", (2, 4), 2), ("stablelm-1.6b", (4, 2), 1)])
def test_mesh_step_matches_jax_sharded_step(arch, shape, microbatches):
    init = _jax_init(arch)
    want_losses, want = _jax_run(arch, shape, microbatches, init, 0, STEPS)
    cfg = _cfgs(arch)[0]
    losses, state, step, mesh = _port_run(arch, shape, microbatches,
                                          train_state_from_jax(cfg, init, "cpu"), 0, STEPS)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = train_state_to_numpy(cfg, T.gather_state(state, mesh, step.placed))
    assert int(got["opt"]["step"]) == STEPS
    _assert_tree_close(got["params"], want["params"], 1e-4)
    _assert_tree_close(got["opt"]["m"], want["opt"]["m"], 1e-4)
    _assert_tree_close(got["opt"]["v"], want["opt"]["v"], 1e-4)
    assert _rel_l2(jax.tree.leaves(want["params"])[0], jax.tree.leaves(init["params"])[0]) > 1e-3


def test_mesh_state_layout_and_n_parts():
    """After a step the state is in ``state_pspecs``'s stacked layout (a
    leaf's stacked layout of its global array, ZeRO-1's split layers
    pinned to their data rank), and ``n_parts`` 4 gives ``n_parts`` 1's
    bits."""
    cfg = _cfgs("stablelm-1.6b")[0]
    init = train_state_from_jax(cfg, _jax_init("stablelm-1.6b"), "cpu")
    l1, s1, step, mesh = _port_run("stablelm-1.6b", (2, 4), 2, init, 0, 1, n_parts=1)
    l4, s4, _, _ = _port_run("stablelm-1.6b", (2, 4), 2, init, 0, 1, n_parts=4)
    assert l1 == l4
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(s1), tree_leaves(s4)))
    glob = T.gather_state(s1, mesh, step.placed)
    pinned = 0
    for (path, leaf), (_, g), spec in zip(tree_leaves(s1["opt"]["m"]),
                                          tree_leaves(glob["opt"]["m"]),
                                          T._spec_leaves(step.placed["opt"]["m"])):
        assert torch.equal(leaf, _to_stacked(g, mesh, spec)), path
        if isinstance(spec, Pinned):  # the leaf lives on one data rank
            pinned += 1
            assert leaf.shape[0] == 1 and spec.coords[0] == path[1] // (cfg.n_layers // 2)
        else:
            assert leaf.shape[:2] == (2, 4)
    assert pinned == sum(1 for path, _ in tree_leaves(s1["opt"]["m"]) if path[0] == "layers")
    for (path, leaf), (_, g) in zip(tree_leaves(s1["params"]), tree_leaves(glob["params"])):
        assert leaf.shape[:2] == (2, 4) and torch.equal(leaf[0], leaf[1]), path


def test_mesh_step_over_two_data_axes():
    """A mesh whose data axes are two, ``("pod", "data")`` as the
    multi-pod production mesh's, flattens them: ZeRO-1 splits over both,
    the reduce-scatter runs over each in turn, and the step follows the
    ``(4, 2)`` mesh's within f32 rounding."""
    arch = "stablelm-1.6b"
    cfg = _cfgs(arch)[0]
    init = train_state_from_jax(cfg, _jax_init(arch), "cpu")
    flat, s_flat, step_flat, m_flat = _port_run(arch, (4, 2), 1, init, 0, 2)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    step = T.make_train_step(build_model(cfg, "cpu"), OptimizerConfig(**OPT),
                             ParallelContext(mesh=mesh, data_axes=("pod", "data")), 1)
    assert any(("pod", "data") in tuple(s) for s in T._spec_leaves(step.placed["opt"]["m"]))
    state = reshard_state(init, mesh, step.placed)
    data = SyntheticLM(cfg, BATCH, SEQ, seed=0)
    losses = []
    for i in range(2):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()})
        losses.append(met["loss"].item())
    np.testing.assert_allclose(losses, flat, rtol=1e-6)
    got = T.gather_state(state, mesh, step.placed)
    want = T.gather_state(s_flat, m_flat, step_flat.placed)
    _assert_tree_close(train_state_to_numpy(cfg, got), train_state_to_numpy(cfg, want), 1e-5)


def _trainer_cfg(cfg, root, steps):
    return RunConfig(model=cfg, shape=ShapeConfig("mesh", SEQ, BATCH, "train"),
                     optimizer=OptimizerConfig(**OPT), steps=steps, checkpoint_dir=str(root),
                     checkpoint_every=4, async_checkpoint=False, log_every=0)


def test_restart_onto_a_smaller_mesh_matches_jax_elastic(tmp_path):
    """``check_elastic.py`` through the ``Trainer``: the JAX state saved at
    step 0, 4 steps on ``(4, 2)``, a checkpoint at step 4, a ``Trainer``
    on ``(2, 2)`` restores it and runs steps 4-6."""
    _need(8)
    arch = "llama3-8b"
    init = _jax_init(arch)
    big, after = _jax_run(arch, (4, 2), 1, init, 0, 4)
    _, jmesh, jspecs = _jax_program(arch, (2, 2), 1)
    small, _ = _jax_run(arch, (2, 2), 1, jax.tree.map(np.asarray, j_reshard_state(
        after, jmesh, jspecs)), 4, 3)

    cfg = _cfgs(arch, train_microbatches=1)[0]
    model = build_model(cfg, "cpu")
    ckpt.save(train_state_from_jax(cfg, init, "cpu"), str(tmp_path), 0)
    ctx_big = ParallelContext(mesh=make_mesh((4, 2), AXES, device="cpu"))
    ctx_small = ParallelContext(mesh=make_mesh((2, 2), AXES, device="cpu"))
    first = T.Trainer(model, _trainer_cfg(cfg, tmp_path, 4), ctx=ctx_big).run()
    assert ckpt.latest_step(str(tmp_path)) == 4
    second = T.Trainer(model, _trainer_cfg(cfg, tmp_path, 7), ctx=ctx_small).run()
    np.testing.assert_allclose(first.losses, big, rtol=1e-5)
    np.testing.assert_allclose(second.losses, small, rtol=1e-5)

    # the uninterrupted run, switched at step 4 without a checkpoint
    _, state, step, mesh = _port_run(arch, (4, 2), 1, train_state_from_jax(cfg, init, "cpu"),
                                     0, 4)
    switched = T.gather_state(state, mesh, step.placed)
    losses, _, _, _ = _port_run(arch, (2, 2), 1, switched, 4, 3)
    assert losses == second.losses


def test_mesh_checkpoint_is_a_one_device_checkpoint(tmp_path):
    """A mesh state saved through the ``Trainer``'s gather writes the bytes
    that ``ckpt.save`` writes for the same state held whole."""
    cfg = _cfgs("stablelm-1.6b")[0]
    init = train_state_from_jax(cfg, _jax_init("stablelm-1.6b"), "cpu")
    _, state, step, mesh = _port_run("stablelm-1.6b", (2, 4), 1, init, 0, 1)
    run = _trainer_cfg(cfg, tmp_path / "mesh", 1)
    trainer = T.Trainer(build_model(cfg, "cpu"), run, ctx=ParallelContext(mesh=mesh))
    ckpt.save(trainer.global_state(state, "cpu"), str(tmp_path / "mesh"), 1)
    whole = T.gather_state(state, mesh, step.placed)
    ckpt.save({"params": whole["params"], "opt": whole["opt"]}, str(tmp_path / "one"), 1)
    a, b = tmp_path / "mesh" / "step_00000001", tmp_path / "one" / "step_00000001"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) > 3
    for name in names:
        if name == "manifest.json":
            ma, mb = (json.loads((d / name).read_text()) for d in (a, b))
            ma.pop("time"), mb.pop("time")
            assert ma == mb
        else:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    # and the restore onto another mesh holds the same values
    restored, at = ckpt.restore(str(tmp_path / "mesh"), like=T.init_state(
        build_model(cfg, "cpu"), OptimizerConfig(**OPT), "meta"), device="cpu")
    assert at == 1 and all(torch.equal(x, y) for (_, x), (_, y) in
                           zip(tree_leaves(restored), tree_leaves(whole)))


@functools.lru_cache(maxsize=None)
def _jax_grads(kind: str):
    """``jax.value_and_grad`` of reduced llama3-8b's loss under
    ``check_models_dist.py``'s context on ``(2, 4)``, jitted: the
    parameters (numpy), the batch, the loss and the gradients."""
    _need(8)
    _, jcfg = _cfgs("llama3-8b")
    jmodel = j_build_model(jcfg)
    params = _jax_init("llama3-8b")["params"]
    jmesh = j_compat.make_mesh((2, 4), AXES)
    jctx = JCtx(mesh=jmesh, **({"seq_parallel": True} if kind == "ring_attention"
                               else {"tp_mode": "ring"}))
    batch = SyntheticLM(_cfgs("llama3-8b")[0], 4, 64, seed=2).batch_at(0)
    with j_compat.set_mesh(jmesh):
        loss, grads = _jitr(jax.value_and_grad(lambda p, b: jmodel.loss(p, b, ctx=jctx)))(
            jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    return params, batch, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("kind,kw", [
    ("ring_attention", dict(seq_parallel=True, n_parts=2)),
    ("ring_tp", dict(tp_mode="ring"))])
def test_gradients_through_the_ring_paths_match_jax(kind, kw):
    params, batch, want_loss, want = _jax_grads(kind)
    cfg = _cfgs("llama3-8b")[0]
    model = build_model(cfg, "cpu")
    tree = params_from_jax(cfg, params, "cpu")
    leaves = [p.requires_grad_(True) for _, p in tree_leaves(tree)]
    ctx = ParallelContext(mesh=make_mesh((2, 4), AXES, device="cpu"), **kw)
    loss = model.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, ctx=ctx)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    got = params_to_numpy(cfg, T.tree_unflatten(tree, [g.detach() for g in grads]))
    _assert_tree_close(got, want, 1e-4)


@pytest.mark.parametrize("packer", ["slice", "cuda"])
def test_ring_hop_backward_is_the_inverse_route(packer):
    """The KV hop under grad: each hop's output is the ring predecessor's
    block and the cotangent goes back to it, bitwise, partitioned (3 parts)
    and coalesced or not; the same attention without grad gives the same
    bits (the in-place serving path)."""
    from repro_torch.core.ring import RingHopFn, ring_kv_plan
    from repro_torch.core.transport import resolve_packer

    mesh = make_mesh((1, 4), AXES, device="cpu")
    gen = torch.Generator().manual_seed(0)
    kv = torch.randn((4, 2, 2, 12, 2, 8), generator=gen)
    cot = torch.randn(kv.shape, generator=gen)
    src = torch.tensor([3, 0, 1, 2])  # rank r receives rank r - 1's block
    for coalesce in (True, False):
        plan = dict(n_parts=3, packer=resolve_packer(packer), transport=resolve_transport(
            "loopback"), coalesce=coalesce)
        hop = ring_kv_plan(mesh, "model", tuple(kv.shape[1:]), kv.dtype, **plan)
        back = ring_kv_plan(mesh, "model", tuple(kv.shape[1:]), kv.dtype, shift=-1, **plan)
        x = kv.clone().requires_grad_(True)
        y = RingHopFn.apply(x, hop, back)
        assert torch.equal(y, kv[src])
        (g,) = torch.autograd.grad(y, x, cot)
        assert torch.equal(g[src], cot)
    q, k, v = (torch.randn((4, 2, 12, 4, 8), generator=gen) for _ in range(3))
    kw = dict(n_parts=3, packer=packer)
    with torch.no_grad():
        want = ring_attention(q, k, v, mesh, "model", **kw)
    kg = k.clone().requires_grad_(True)
    assert torch.equal(ring_attention(q, kg, v, mesh, "model", **kw), want)


def test_loopback_permute_gradient_is_the_inverse_permutation():
    """The ``index_select`` of the ring collective-matmuls' hops carries a
    gradient: a cotangent comes back to the sender's rows, a row that
    receives nothing (a non-periodic hop) gives none."""
    mesh = make_mesh((2, 4), AXES, device="cpu")
    t = resolve_transport("loopback")
    x = torch.randn((8, 3, 5), requires_grad=True)
    cot = torch.randn(8, 3, 5)
    y = t.permute(x, mesh, "model", ring_perm(4))
    (g,) = torch.autograd.grad(y, x, cot)
    src = [3, 0, 1, 2, 7, 4, 5, 6]  # the sender of each row, within its data row
    assert torch.equal(y, x.detach()[src]) and torch.equal(g[src], cot)
    y = t.permute(x, mesh, "model", [(i, i + 1) for i in range(3)])
    (g,) = torch.autograd.grad(y, x, cot)
    assert torch.equal(y[[0, 4]], torch.zeros(2, 3, 5))
    assert torch.equal(g[[3, 7]], torch.zeros(2, 3, 5))
    assert torch.equal(g[[0, 1, 2, 4, 5, 6]], cot[[1, 2, 3, 5, 6, 7]])


def test_launch_train_on_the_production_mesh(capsys):
    res = launch_train.main(["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
                             "--mesh", "production", "--steps", "2", "--log-every", "0"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert "trained 2 steps on cpu" in capsys.readouterr().out
