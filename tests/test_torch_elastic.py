"""The port's elastic stencil runner (``repro_torch.launch.elastic``)
against the JAX package's (``repro.launch.elastic``).

Every case of JAX ``tests/stencil/test_elastic.py`` re-runs as port-vs-JAX
parity on a ``(16, 8)`` f32 interior over 4 ranks (the JAX package's
virtual devices; 8 where noted), with the same failures injected in both:

* exact packers (``slice``, and the port's ``cuda`` beside JAX's
  ``pallas``, their plain versions here): the port's ``final_interior`` is
  bitwise the JAX runner's, and both equal the one-rank oracle;
* the events agree on cause, ranks, step, epoch and invalidations, and the
  plan-cache counters, ``replans``, ``checkpoint_step``, ``warm_ranks`` and
  ``final_epoch`` agree;
* the cases: mid-exchange over all five strategies, plan-build group and
  round, resume from the committed step, restart with no checkpoint,
  ``max_replans`` exhausted, in-grid recovery with a warm unrelated plan,
  JOIN, the coordinator fallback, the straggler monitor, and ``bf16``
  (bitwise JAX's ``bf16`` run, and within ``wire_tolerance`` x steps of
  the exact oracle).

One ``slow`` chaos test runs the grid form (JAX
``tests/distributed_progs/check_elastic_stencil.py``): a 2-process gloo
grid dies mid-run, and the survivor resumes in one process from the
committed checkpoint, bitwise against JAX's oracle.  The ``cuda`` tests run
on the card.
"""

import dataclasses
import json
import os
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.launch import elastic as j_el
from repro.train.fault_tolerance import FailureInjector as JInjector
from repro.train.fault_tolerance import StragglerMonitor as JStraggler
from repro_torch.launch import elastic as t_el
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.fault_tolerance import FailureInjector, SimulatedFailure, StragglerMonitor

torch.set_num_threads(1)

BASE = dict(global_interior=(16, 8), n_steps=6)
#: port packer -> JAX packer of the same exact wire
JAX_PACKER = {"slice": "slice", "cuda": "pallas", "bf16": "bf16"}
STRATEGIES = ("standard", "persistent", "partitioned", "fused", "overlap")


def _configs(**kw):
    kw = {**BASE, **kw}
    jkw = dict(kw, packer=JAX_PACKER[kw.get("packer", "slice")], transport="ppermute")
    return t_el.ElasticConfig(**kw), j_el.ElasticConfig(**jkw)


def run_both(tmp_path, ranks=4, *, ckpt=True, fail=None, phases=("mid-exchange",),
             joins=(), prewarm=False, straggler=None, **kw):
    """The same run in both packages: ``fail`` steps injected at
    ``phases``, ``joins`` as ``(step, n new ranks)``.  Returns (port
    result, JAX result, port runner, JAX runner)."""
    tcfg, jcfg = _configs(**kw)
    out = {}
    for pkg in ("torch", "jax"):
        ckpt_dir = str(tmp_path / f"{pkg}_ckpt") if ckpt else None
        injector = None
        if fail is not None:
            injector = (FailureInjector if pkg == "torch" else JInjector)(
                fail_at_steps=tuple(fail), phases=phases)
        if pkg == "torch":
            devs, step_joins = list(range(ranks)), [
                (s, list(range(ranks, ranks + n))) for s, n in joins]
            runner = t_el.ElasticStencilRunner(
                tcfg, ckpt_dir, injector=injector, devices=devs, joins=step_joins,
                device="cpu",
                straggler=StragglerMonitor(**straggler) if straggler else None)
        else:
            devs = jax.devices()[:ranks]
            step_joins = [(s, jax.devices()[ranks:ranks + n]) for s, n in joins]
            runner = j_el.ElasticStencilRunner(
                jcfg, ckpt_dir, injector=injector, devices=devs, joins=step_joins,
                straggler=JStraggler(**straggler) if straggler else None)
        warm = _prewarm(pkg, runner.cache) if prewarm else None
        out[pkg] = (runner.run(), runner, warm)
    return out["torch"], out["jax"]


def _prewarm(pkg, cache):
    """An epoch-free persistent plan for an unrelated geometry in the
    runner's cache; returns the cache's keys after it."""
    if pkg == "torch":
        from repro_torch.core.mesh import make_mesh
        from repro_torch.stencil import Domain, StrategyConfig, make_driver

        mesh = make_mesh((2,), ("px",), device="cpu")
        dom = Domain(mesh, (8, 4), ("px", None))
        drv = make_driver(StrategyConfig(name="persistent", plan_cache=cache), mesh,
                          dom.halo_spec, ndim=2)
        drv.init(dom.random(0))
    else:
        from repro.core.compat import make_mesh
        from repro.stencil.domain import Domain
        from repro.stencil.strategies import StrategyConfig, make_driver

        mesh = make_mesh((2,), ("px",), devices=jax.devices()[:2])
        dom = Domain(mesh, global_interior=(8, 4), mesh_axes=("px", None), halo=1)
        drv = make_driver(StrategyConfig(name="persistent", plan_cache=cache), mesh,
                          dom.halo_spec, ndim=2)
        drv.init(jax.ShapeDtypeStruct(dom.stored_global, np.dtype(dom.dtype),
                                      sharding=dom.sharding()))
    drv.free()
    return set(cache.keys())


def _oracle(**kw) -> np.ndarray:
    """JAX's one-device reference trajectory (no chaos, no checkpoints)."""
    _, jcfg = _configs(**kw)
    return j_el.ElasticStencilRunner(dataclasses.replace(jcfg, checkpoint_every=0), None,
                                     devices=jax.devices()[:1]).run().final_interior


def _events(result):
    return [(e.cause, e.n_devices, e.step, e.epoch, e.plan_invalidations) for e in result.events]


RESULT_FIELDS = ("steps", "replans", "checkpoint_step", "recovery_mode", "warm_ranks",
                 "final_epoch", "plan_cache_inits", "plan_cache_hits",
                 "plan_cache_invalidations")


def assert_same(t, j):
    (tr, _, _), (jr, _, _) = t, j
    assert _events(tr) == _events(jr)
    assert {f: getattr(tr, f) for f in RESULT_FIELDS} == {f: getattr(jr, f) for f in RESULT_FIELDS}
    assert set(tr.bench_record()) == set(jr.bench_record()) | {"device"}
    assert tr.bench_record()["device"] == "cpu"
    assert tr.final_interior.dtype == jr.final_interior.dtype == np.float32
    np.testing.assert_array_equal(tr.final_interior, jr.final_interior)


# ---------------------------------------------------------------------------
# the update and the initial state
# ---------------------------------------------------------------------------


def test_initial_interior_is_jax_s():
    tcfg, jcfg = _configs(seed=5)
    a = t_el.initial_interior(tcfg)
    np.testing.assert_array_equal(a, j_el.initial_interior(jcfg))
    assert a.dtype == np.float32 and tuple(a.shape) == (16, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_diffusion_update_equals_jax_bitwise_and_keeps_the_rim(dtype):
    import jax.numpy as jnp

    block = np.random.default_rng(2).normal(size=(3, 10, 5)).astype(np.float32)
    x = torch.from_numpy(block).to(getattr(torch, dtype))
    got = t_el.diffusion_update(1)(x.clone())
    want = np.stack([np.asarray(j_el.diffusion_update(1)(jnp.asarray(b, dtype))
                                .astype(jnp.float32)) for b in block])
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got[:, 0], x[:, 0]) and torch.equal(got[:, -1], x[:, -1])


# ---------------------------------------------------------------------------
# rank loss: relaunch recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packer", ["slice", "cuda"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mid_exchange_failure_resumes_bitwise_as_jax(tmp_path, strategy, packer):
    t, j = run_both(tmp_path, fail=(3,), strategy=strategy, packer=packer,
                    n_parts=3 if strategy == "partitioned" else 1)
    assert_same(t, j)
    tr = t[0]
    assert [e.cause for e in tr.events] == ["initial", "rank-loss"]
    assert (tr.events[0].n_devices, tr.events[1].n_devices) == (4, 2)
    np.testing.assert_array_equal(tr.final_interior, _oracle(strategy=strategy))
    (rec,) = tr.recoveries
    assert rec.cause == "rank-loss" and rec.step == 3 and rec.recover_s > 0


def test_mid_exchange_from_8_ranks(tmp_path):
    t, j = run_both(tmp_path, ranks=8, fail=(4,), global_interior=(32, 8), n_steps=8,
                    checkpoint_every=4)
    assert_same(t, j)
    assert [(e.n_devices, e.step) for e in t[0].events] == [(8, 0), (4, 4)]


def test_resumed_run_matches_reference_exchange_oracle(tmp_path):
    from repro_torch.core.mesh import make_mesh
    from repro_torch.stencil import Domain, reference_exchange

    t, j = run_both(tmp_path, fail=(2,))
    assert_same(t, j)
    dom = Domain(make_mesh((2,), ("px",), device="cpu"), (16, 8), ("px", None))
    assert torch.equal(reference_exchange(dom, t[0].final_interior),
                       reference_exchange(dom, _oracle()))


@pytest.mark.parametrize("phase", ["plan-build:group", "plan-build:round"])
def test_plan_build_abort_leaves_cache_clean_as_jax(tmp_path, phase):
    t, j = run_both(tmp_path, fail=(0,), phases=(phase,), strategy="partitioned", n_parts=3)
    assert_same(t, j)
    runner = t[1]
    assert t[0].replans == 1 and t[0].events[-1].plan_invalidations == 0
    assert runner.cache.stats.inits == 1 and runner.cache.stats.invalidations == 0
    assert len(runner.cache) == 1


def test_resume_uses_committed_checkpoint_as_jax(tmp_path):
    t, j = run_both(tmp_path, fail=(5,), checkpoint_every=2)
    assert_same(t, j)
    assert t[0].events[1].step == 4
    assert (t_ckpt.committed_steps(str(tmp_path / "torch_ckpt"))
            == t_ckpt.committed_steps(str(tmp_path / "jax_ckpt")) == [2, 4, 6])


def test_failure_without_checkpoint_restarts_from_initial_as_jax(tmp_path):
    t, j = run_both(tmp_path, fail=(0,))
    assert_same(t, j)
    assert t[0].events[1].step == 0 and t[0].recoveries[0].restore_s == 0.0


#: timed re-plans and plan builds a topology in the cost comparison
REPLAN_TIMINGS = 7


def test_replan_is_deterministic_and_cheap(tmp_path):
    """The re-plan is table math and cheaper than building the plan.  One
    run's single readings of each (a few hundred microseconds) are at the
    mercy of a loaded host, so at every topology the run planned on, the
    fastest of several timed re-plans is held against the fastest of as
    many builds of a plan on the same tables, in the runner's order
    (re-plan, then build), each build on a fresh driver and plan cache."""
    import time

    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.plan import PlanCache
    from repro_torch.stencil import Domain, StrategyConfig, make_driver

    t, _ = run_both(tmp_path, fail=(3,))
    result, runner, _ = t
    assert [e.n_devices for e in result.events] == [4, 2]
    for event in result.events:
        assert event.replan_us > 0.0 and event.init_us > 0.0
    cfg = runner.config
    for event in result.events:
        n = event.n_devices
        dom = Domain(make_mesh((n,), ("px",), device="cpu"), cfg.global_interior,
                     ("px", None), halo=cfg.halo)
        x = dom.random(0)
        replan_us, init_us, tables = [], [], set()
        for _ in range(REPLAN_TIMINGS):
            drv = make_driver(StrategyConfig(
                name=cfg.strategy, n_parts=cfg.n_parts, packer=cfg.packer,
                transport=cfg.transport, coalesce=cfg.coalesce, plan_cache=PlanCache(),
                epoch=event.epoch), dom.mesh, dom.halo_spec, ndim=len(cfg.global_interior))
            t0 = time.perf_counter()
            tables.add(drv.replan_tables(x))
            replan_us.append((time.perf_counter() - t0) * 1e6)
            t0 = time.perf_counter()
            drv.init(x)
            init_us.append((time.perf_counter() - t0) * 1e6)
        assert len(tables) == 1  # deterministic
        print("MARGIN", n, min(replan_us), min(init_us))
        assert 0.0 < min(replan_us) < min(init_us), (n, replan_us, init_us)


def test_max_replans_exhausted_propagates_as_jax(tmp_path):
    """Past the chaos budget the failure propagates in both packages, and
    the checkpoint committed before it is what a relaunch resumes from."""
    tcfg, jcfg = _configs(max_replans=0)
    runners = {
        "torch": t_el.ElasticStencilRunner(
            tcfg, str(tmp_path / "t"), device="cpu", devices=list(range(4)),
            injector=FailureInjector(fail_at_steps=(1,), phases=("mid-exchange",))),
        "jax": j_el.ElasticStencilRunner(
            jcfg, str(tmp_path / "j"), devices=jax.devices()[:4],
            injector=JInjector(fail_at_steps=(1,), phases=("mid-exchange",))),
    }
    with pytest.raises(SimulatedFailure):
        runners["torch"].run()
    with pytest.raises(j_el.SimulatedFailure):
        runners["jax"].run()
    assert runners["torch"].checkpoint_step == runners["jax"].checkpoint_step == 1
    assert (t_ckpt.committed_steps(str(tmp_path / "t"))
            == t_ckpt.committed_steps(str(tmp_path / "j")) == [1])


def test_compressed_packer_resume_within_wire_tolerance(tmp_path):
    from repro_torch.core.transport import get_packer

    t, j = run_both(tmp_path, fail=(2,), packer="bf16", n_steps=4)
    assert_same(t, j)  # the same bf16 wire: the same bits as JAX's run
    again, _ = run_both(tmp_path / "b", fail=(2,), packer="bf16", n_steps=4)
    np.testing.assert_array_equal(t[0].final_interior, again[0].final_interior)
    exact = _oracle(n_steps=4)
    rtol, atol = get_packer("bf16").wire_tolerance("float32")
    scale = float(np.abs(exact).max())
    np.testing.assert_allclose(t[0].final_interior, exact, rtol=4 * rtol,
                               atol=4 * max(atol, rtol * scale))


# ---------------------------------------------------------------------------
# in-grid recovery, JOIN, coordinator fallback, stragglers
# ---------------------------------------------------------------------------


def test_in_grid_recovery_keeps_survivors_warm_as_jax(tmp_path):
    t, j = run_both(tmp_path, fail=(3,), recovery_mode="in-grid", prewarm=True)
    assert_same(t, j)
    tr, runner, warm = t
    assert [e.cause for e in tr.events] == ["initial", "loss-ingrid"]
    assert tr.final_epoch == 1 and tr.events[1].epoch == 1 and tr.warm_ranks == 2
    assert tr.events[1].plan_invalidations == 1 == tr.plan_cache_invalidations
    assert warm <= set(runner.cache.keys())
    assert tr.plan_cache_inits == 3


@pytest.mark.parametrize("ranks,joiners", [(2, 2), (4, 4)])
def test_join_grows_mesh_and_moves_live_state_as_jax(tmp_path, ranks, joiners):
    t, j = run_both(tmp_path, ranks=ranks, ckpt=False, checkpoint_every=0,
                    recovery_mode="in-grid", joins=[(3, joiners)])
    assert_same(t, j)
    tr = t[0]
    assert tr.replans == 0 and [e.cause for e in tr.events] == ["initial", "join"]
    assert (tr.events[0].n_devices, tr.events[1].n_devices) == (ranks, ranks + joiners)
    assert tr.final_epoch == joiners and tr.warm_ranks == ranks
    assert tr.join_us > 0.0 and tr.checkpoint_step is None
    assert tr.recoveries[0].cause == "join"
    np.testing.assert_array_equal(tr.final_interior, _oracle())


def test_coordinator_death_falls_back_to_relaunch_as_jax(tmp_path):
    tcfg, jcfg = _configs(recovery_mode="in-grid")
    tr_runner = t_el.ElasticStencilRunner(tcfg, str(tmp_path / "t"), devices=list(range(4)),
                                          fail_coordinator_at=2, device="cpu")
    jr_runner = j_el.ElasticStencilRunner(jcfg, str(tmp_path / "j"), devices=jax.devices()[:4],
                                          fail_coordinator_at=2)
    t = (tr_runner.run(), tr_runner, None)
    j = (jr_runner.run(), jr_runner, None)
    assert_same(t, j)
    assert [e.cause for e in t[0].events] == ["initial", "coordinator-lost"]
    assert t[0].warm_ranks == 0 and t[0].final_epoch == 1
    assert tr_runner.membership.alive and tr_runner.membership.view.epoch == 1
    assert tr_runner.membership.view.to_wire() == jr_runner.membership.view.to_wire()


@pytest.mark.parametrize("factor,flagged", [(0.0, list(range(1, 6))), (1e9, [])])
def test_straggler_monitor_wired_into_runner_as_jax(tmp_path, factor, flagged):
    t, j = run_both(tmp_path, ranks=2, ckpt=False, checkpoint_every=0,
                    straggler=dict(factor=factor))
    assert_same(t, j)
    assert [s for s, _, _ in t[0].straggler_flags] == flagged
    assert [s for s, _, _ in j[0].straggler_flags] == flagged
    assert t[0].bench_record()["straggler_flags"] == [list(f) for f in t[0].straggler_flags]


def test_runner_takes_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_el.ElasticStencilRunner(t_el.ElasticConfig(), None)


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    t_el.main(["--device", "cpu", "--ranks", "4", "--n-steps", "6", "--fail-step", "3",
               "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "plan[rank-loss] step=3 ranks=2" in out and "bitwise vs the one-rank oracle: True" in out


# ---------------------------------------------------------------------------
# the grid form: a 2-process grid dies, one process resumes
# ---------------------------------------------------------------------------

_GRID_PROG = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.stencil import maybe_initialize_from_env
    rank = maybe_initialize_from_env()
    import torch.distributed as dist
    from repro_torch.launch.elastic import ElasticConfig, ElasticStencilRunner
    from repro_torch.launch.membership import MembershipService, client_from_env, serve_from_env
    from repro_torch.train.fault_tolerance import FailureInjector
    ckpt, fail_step, n_steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    # the rank-0 membership service the launcher advertised; every rank
    # registers through the wire, rank 0 seals the founding set
    srv = serve_from_env(MembershipService()) if rank == 0 else None
    dist.barrier()
    client_from_env().register(rank)
    dist.barrier()
    if rank == 0:
        view = client_from_env().seal()
        print("MEMBERS", json.dumps(view.to_wire()), flush=True)
    dist.barrier()
    cfg = ElasticConfig(global_interior=(16, 8), n_steps=n_steps, checkpoint_every=1,
                        transport="multihost", max_replans=0)
    runner = ElasticStencilRunner(
        cfg, ckpt, device="cpu", devices=list(range(4)),
        injector=FailureInjector(fail_at_steps=(fail_step,) if rank == 1 else (),
                                 phases=("mid-exchange",)))
    runner.run()  # rank 1 dies mid-exchange; rank 0 loses its peer
    print(f"rank {rank}: survived a run that should have died", flush=True)
    sys.exit(17)
""")


@pytest.mark.slow
def test_grid_dies_and_one_process_resumes_bitwise_against_jax(tmp_path):
    from repro_torch.launch.stencil import launch_grid

    fail_step, n_steps = 3, 6
    prog = tmp_path / "grid.py"
    prog.write_text(_GRID_PROG)
    ckpt = tmp_path / "ckpt"
    grid = launch_grid([sys.executable, str(prog), str(ckpt), str(fail_step), str(n_steps)],
                       processes=2, timeout=120.0, check=False, attempts=1, reap_grace=5.0,
                       membership=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert not grid.ok and 17 not in grid.returncodes, grid.returncodes
    assert "SimulatedFailure" in grid.errs[1], grid.errs[1][-2000:]
    assert grid.failed_ranks == (0, 1), grid.returncodes
    members = [line for line in grid.outs[0].splitlines() if line.startswith("MEMBERS")]
    assert json.loads(members[0].split(maxsplit=1)[1]) == {
        "epoch": 0, "members": [0, 1], "cause": "form"}
    # the step the failure interrupted never committed; the one before did
    assert t_ckpt.committed_steps(str(ckpt)) == [1, 2, 3]
    # the survivor: one process, the same cell, from the shared directory
    cfg = t_el.ElasticConfig(global_interior=(16, 8), n_steps=n_steps, checkpoint_every=1,
                             transport="multihost", max_replans=0)
    result = t_el.ElasticStencilRunner(cfg, str(ckpt), device="cpu",
                                       devices=list(range(2))).run()
    assert result.steps == n_steps and result.replans == 0
    assert (result.events[0].step, result.events[0].n_devices) == (fail_step, 2)
    assert result.events[0].replan_us > 0.0
    np.testing.assert_array_equal(result.final_interior, _oracle(n_steps=n_steps))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


def _cpu_result(kw, fail, phases, tmp_path):
    cfg = t_el.ElasticConfig(**kw)
    return t_el.ElasticStencilRunner(
        cfg, str(tmp_path / "cpu"), device="cpu", devices=list(range(8)),
        injector=FailureInjector(fail_at_steps=fail, phases=phases)).run()


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["mid-exchange", "plan-build:group", "plan-build:round"])
def test_recovery_on_the_card_equals_the_cpu_and_frees_the_dead_plan(cuda, tmp_path, phase):
    kw = dict(global_interior=(256, 256, 64), n_steps=6, checkpoint_every=2,
              strategy="partitioned", n_parts=2, packer="cuda")
    fail = (3,) if phase == "mid-exchange" else (0,)
    runner = t_el.ElasticStencilRunner(
        t_el.ElasticConfig(**kw), str(tmp_path / "card"), device=cuda, devices=list(range(8)),
        injector=FailureInjector(fail_at_steps=fail, phases=(phase,)))
    result = runner.run()
    assert not torch.cuda.is_current_stream_capturing()
    assert len(runner.cache) == 1 and all(p.captured for p in runner.cache._plans.values())
    np.testing.assert_array_equal(result.final_interior,
                                  _cpu_result(kw, fail, (phase,), tmp_path).final_interior)
    (rec,) = result.recoveries
    if phase == "mid-exchange":
        # the dead plan's graph pool and buffers came back
        assert rec.memory_released < rec.memory_at_raise
        assert rec.memory_after <= rec.memory_at_raise * 1.1


@pytest.mark.cuda
def test_join_on_the_card_moves_live_state_on_the_device(cuda):
    kw = dict(global_interior=(256, 256, 64), n_steps=5, checkpoint_every=0,
              recovery_mode="in-grid", packer="cuda")
    result = t_el.ElasticStencilRunner(t_el.ElasticConfig(**kw), None, device=cuda,
                                       devices=list(range(4)), joins=[(2, [4, 5, 6, 7])]).run()
    oracle = t_el.ElasticStencilRunner(t_el.ElasticConfig(**kw), None, device="cpu",
                                       devices=[0]).run()
    np.testing.assert_array_equal(result.final_interior, oracle.final_interior)
    assert [e.n_devices for e in result.events] == [4, 8]
