"""The port's train step and fault-tolerant ``Trainer`` against the JAX
package's (``repro.train.train_loop``), on the CPU.

* ``make_train_step``: 3 steps from one train state (the JAX package's
  ``init_state`` of reduced stablelm-1.6b in f32, carried over by
  ``train_state_from_jax``) on the same ``SyntheticLM`` batches, at
  ``microbatches`` 1 and 2, against JAX's jitted step.  Tolerances, stated:
  losses within 1e-5 relative, the parameters within 1e-4 relative L2 over
  the tree (f32 sums in other orders, carried through 3 AdamW steps).
* ``Trainer``: a run with a failure injected mid-run restarts from its
  checkpoint and reproduces the uninterrupted run bitwise (the CPU's
  arithmetic is deterministic and the restored state exact), as
  ``tests/train/test_fault_tolerance.py`` asserts for JAX.
* ``python -m repro_torch.launch.train --device cpu --reduced`` in-process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.models import build_model as j_build_model
from repro.train import train_loop as JT
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.core.mesh import make_mesh
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import _build
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_jax, train_state_to_numpy
from repro_torch.parallel.context import ParallelContext
from repro_torch.train.fault_tolerance import FailureInjector
from repro_torch.train.train_loop import Trainer, make_train_step

torch.set_num_threads(1)

ARCH = "stablelm-1.6b"
STEPS, BATCH, SEQ = 3, 4, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20)


def _cfgs():
    upd = dict(dtype="float32", param_dtype="float32")
    return (get_config(ARCH).reduced().with_updates(**upd),
            j_get_config(ARCH).reduced().with_updates(**upd))


@pytest.fixture(scope="module")
def jax_state():
    jmodel = j_build_model(_cfgs()[1])
    return jax.tree.map(np.asarray, JT.init_state(jmodel, JOptimizerConfig(**OPT),
                                                  jax.random.key(4)))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree.leaves(tree)])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(jax_state, microbatches):
    cfg, jcfg = _cfgs()
    jmodel = j_build_model(jcfg)
    jstep = jax.jit(JT.make_train_step(jmodel, JOptimizerConfig(**OPT),
                                       microbatches=microbatches))
    step = make_train_step(build_model(cfg, "cpu"), OptimizerConfig(**OPT),
                           microbatches=microbatches)
    jstate = jax.tree.map(jnp.asarray, jax_state)
    state = train_state_from_jax(cfg, jax_state, "cpu")
    data = SyntheticLM(cfg, BATCH, SEQ, seed=2)
    for i in range(STEPS):
        batch = data.batch_at(i)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-5)
    got = train_state_to_numpy(cfg, state)
    assert int(got["opt"]["step"]) == STEPS
    want_p, got_p = _flat(jstate["params"]), _flat(got["params"])
    assert np.linalg.norm(got_p - want_p) / np.linalg.norm(want_p) <= 1e-4
    moved = np.linalg.norm(want_p - _flat(jax_state["params"])) / np.linalg.norm(want_p)
    assert moved > 1e-3  # the steps moved the parameters far beyond the tolerance


def test_train_state_round_trip_is_exact(jax_state):
    cfg, _ = _cfgs()
    back = train_state_to_numpy(cfg, train_state_from_jax(cfg, jax_state, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _run_cfg(tmp_path, steps=6):
    return RunConfig(model=get_config(ARCH).reduced(), shape=ShapeConfig("tiny", SEQ, BATCH,
                                                                         "train"),
                     optimizer=OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=100),
                     steps=steps, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2,
                     async_checkpoint=False, log_every=0)


@pytest.mark.parametrize("async_checkpoint", [False, True], ids=["sync", "async"])
def test_restart_reproduces_uninterrupted_run_bitwise(tmp_path, async_checkpoint):
    model = build_model(get_config(ARCH).reduced(), "cpu")
    clean_cfg = _run_cfg(tmp_path / "clean")
    clean = Trainer(model, clean_cfg).run()
    faulty_cfg = _run_cfg(tmp_path / "faulty")
    if async_checkpoint:
        import dataclasses

        faulty_cfg = dataclasses.replace(faulty_cfg, async_checkpoint=True)
    faulty = Trainer(model, faulty_cfg, injector=FailureInjector(fail_at_steps=(3,))).run()
    assert clean.restarts == 0 and faulty.restarts == 1
    assert len(clean.losses) == 6
    # steps 0-2, the failure before step 3, the restore of step 2, steps 2-5
    assert faulty.losses == clean.losses[:3] + clean.losses[2:]
    assert faulty.checksum == clean.checksum
    assert clean.losses[-1] < clean.losses[0]


def test_trainer_and_step_refuse_a_mesh():
    model = build_model(get_config(ARCH).reduced(), "cpu")
    ctx = ParallelContext(mesh=make_mesh((1, 2), ("data", "model"), device="cpu"))
    with pytest.raises(NotImplementedError, match="item 21"):
        make_train_step(model, OptimizerConfig(), ctx)
    with pytest.raises(NotImplementedError, match="item 21"):
        launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh",
                           "production", "--steps", "1"])


def test_launch_train_cli_on_the_cpu(capsys):
    # stablelm-1.6b's train_microbatches=2: two microbatches of one sequence
    res = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
                             "--batch", "2", "--seq", "16", "--log-every", "0"])
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert "trained 3 steps on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch,kind,batch,want", [
    ("stablelm-1.6b", "train", 4, 2), ("stablelm-1.6b", "train", 3, 1),
    ("stablelm-1.6b", "train", 1, 1), ("llama3-8b", "train", 6, 3),
    ("llama3-8b", "train", 2, 2), ("llama3-8b", "decode", 8, 1)])
def test_trainer_takes_the_configs_microbatches(arch, kind, batch, want):
    """The Trainer's gradient accumulation is the config's
    ``train_microbatches`` (stablelm-1.6b 2, llama3-8b 4), cut until it
    divides the global batch, as JAX's ``launch/dryrun._microbatches`` on
    one data rank; 1 for a shape that does not train."""
    from repro_torch.train.train_loop import microbatches_of

    cfg = get_config(arch)
    assert microbatches_of(cfg, ShapeConfig("t", SEQ, batch, kind)) == want
    if kind == "train":
        run = RunConfig(model=cfg.reduced(), shape=ShapeConfig("t", SEQ, batch, kind), steps=1)
        assert Trainer(build_model(cfg.reduced(), "cpu"), run).microbatches == want


def test_refuse_grad_check_on_cpu_tensors():
    """The shared check of the kernel wrappers without a backward: raises
    only while grad is enabled and an input requires grad."""
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    with pytest.raises(NotImplementedError, match="no backward kernel.*item 19"):
        _build.refuse_grad("wkv_chunked", y, x, why="ROADMAP Queue 1 item 19")
    _build.refuse_grad("wkv_chunked", y, y, why="-")
    with torch.no_grad():
        _build.refuse_grad("wkv_chunked", x, why="-")


def test_microbatch_grads_accumulate_in_f32(monkeypatch):
    """With bf16 parameters, ``microbatches=4`` sums the slices' gradients
    in f32 (``grad_accum_dtype``), then divides and casts to bf16, as JAX's
    scan does; a running sum in bf16 (``.backward()`` into ``.grad``)
    rounds at every add, and the check can tell the two apart."""
    from repro_torch.train import train_loop

    cfg = get_config(ARCH).reduced()
    assert cfg.param_dtype == "bfloat16" and cfg.grad_accum_dtype == "float32"
    model = build_model(cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg, BATCH, SEQ).batch_at(0).items()}
    seen = {}

    def capture(params, grads, opt, ocfg):
        seen["grads"] = [g.clone() for _, g in train_loop.tree_leaves(grads)]
        return params, opt, {}

    monkeypatch.setattr(train_loop, "adamw_update", capture)
    state = train_loop.init_state(model, OptimizerConfig(), 0)
    train_loop.make_train_step(model, OptimizerConfig(), microbatches=BATCH)(state, batch)
    leaves = [p for _, p in train_loop.tree_leaves(state["params"])]
    per = [torch.autograd.grad(model.loss(state["params"], {k: v[i:i + 1] for k, v in
                                                            batch.items()}), leaves)
           for i in range(BATCH)]
    want = [(sum(g.float() for g in gs) / BATCH).to(torch.bfloat16) for gs in zip(*per)]
    in_bf16 = [sum(gs[1:], gs[0]) / BATCH for gs in zip(*per)]
    assert all(torch.equal(g, w) for g, w in zip(seen["grads"], want))
    assert not all(torch.equal(g, w) for g, w in zip(seen["grads"], in_bf16))
