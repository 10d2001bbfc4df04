"""Persistent plans that capture at init and replay at start (CUDA graphs).

On the CPU (these count here): a plan stays eager, the five strategies
give the outputs and plan counters they gave before, the argument binding
and the launch accounting behave as plain functions, and the engine's plan
counts for a fixed request set are unchanged.  ``cuda``-marked (run on the
card, skipped here): replay against the eager step (``CommPlan.fn``)
bitwise for every strategy, packer and coalesce mode, ``free()`` returning
the memory, a step that synchronizes inside making init raise, and reduced
llama and rwkv engines giving equal tokens graph against eager.
"""

import collections
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mesh import make_mesh
from repro_torch.core.plan import (
    CommPlan,
    PlanCache,
    _Graph,
    bind_args,
    is_bound,
    take_launches,
    tree_map,
)
from repro_torch.core.transport import available_packers
from repro_torch.kernels import _build
from repro_torch.kernels.stencil27.ref import jacobi_weights
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine, _carry
from repro_torch.stencil import Domain, StrategyConfig, available_strategies, make_driver
from repro_torch.stencil.heat3d import DOMAIN_AXES, MESH_AXES, heat3d_update

torch.set_num_threads(1)

STRATEGIES = ("standard", "persistent", "partitioned", "fused", "overlap")
#: a small heat3d layout: (4, 2) ranks over (z, y), x whole; 4 x 4 x 6 a rank
GLOBAL = (16, 8, 6)
CYCLES = 5


def _domain(device):
    return Domain(make_mesh((4, 2), MESH_AXES, device=device), GLOBAL, DOMAIN_AXES)


def _cycles(step, x, n=CYCLES):
    for _ in range(n):
        x = step(x)
    return x


# ---------------------------------------------------------------------------
# CPU: the plan stays eager
# ---------------------------------------------------------------------------


def test_cpu_plan_is_eager_with_example_args():
    built = []

    def factory():
        built.append(1)
        return lambda x: x * 2

    x = torch.arange(4.0)
    plan = CommPlan(factory, device=torch.device("cpu"), example_args=(x,))
    assert not plan.captured and len(built) == 1
    assert torch.equal(plan.start(x), x * 2) and torch.equal(plan.fn(x), x * 2)
    assert plan.init_seconds >= 0.0
    plan.free()
    with pytest.raises(RuntimeError, match="after free"):
        plan.start(x)


@pytest.mark.parametrize("name", STRATEGIES)
def test_cpu_strategies_unchanged(name):
    """Every strategy with the heat3d update on the CPU: eager plans, cycles
    bitwise equal to ``standard``'s, one init and then a cache hit in a
    shared cache, as before plans could capture."""
    dom = _domain("cpu")
    update = heat3d_update(jacobi_weights().numpy(), dom.mesh.device)
    x0 = dom.random(0)
    want = _cycles(make_driver("standard", dom.mesh, dom.halo_spec, ndim=3,
                               update_fn=update).step, x0.clone())
    cache = PlanCache()
    cfg = StrategyConfig(name=name, plan_cache=cache, n_parts=2 if name == "partitioned" else 1)
    for run in range(2):
        drv = make_driver(cfg, dom.mesh, dom.halo_spec, ndim=3, update_fn=update)
        got = _cycles(drv.step, x0.clone())
        assert torch.equal(got, want), (name, run)
        if name != "standard":
            assert not drv.plan.captured
        drv.free()
    want_stats = (0, 0) if name == "standard" else (1, 1)
    assert (cache.stats.inits, cache.stats.cache_hits) == want_stats


def test_auto_keeps_only_the_fastest_probe_plan():
    """Calibration keeps the fastest probe's plan (the resolved driver's
    cache hit) and frees every other probe's plan at once."""
    dom = _domain("cpu")
    drv = make_driver(StrategyConfig(name="auto", packer="auto", coalesce="auto"),
                      dom.mesh, dom.halo_spec, ndim=3)
    x = dom.random(1)
    drv.init(x)
    cache = drv._owned_cache
    assert drv.selected_by in ("calibration", "cache", "trace", "model")
    if drv.selected_by == "calibration":
        assert len(cache) == (0 if drv.strategy == "standard" else 1)
        assert cache.stats.frees == cache.stats.inits - len(cache)
    drv.free()


# ---------------------------------------------------------------------------
# CPU: argument binding and launch accounting, as plain functions
# ---------------------------------------------------------------------------


def test_bind_args_skips_the_same_storage_and_copies_otherwise():
    static = (torch.zeros(3, 4), {"a": torch.zeros(2), "b": torch.ones(5, dtype=torch.int32)})
    assert bind_args(static, static) == 0 and is_bound(static, static)
    view = (static[0].view(3, 4), {"a": static[1]["a"][:], "b": static[1]["b"]})
    assert bind_args(view, static) == 0  # a view of the same storage is the same input
    src = (torch.full((3, 4), 7.0), {"a": torch.arange(2.0), "b": static[1]["b"]})
    assert not is_bound(src, static)
    assert bind_args(src, static) == 2
    assert torch.equal(static[0], src[0]) and torch.equal(static[1]["a"], src[1]["a"])
    assert static[0].data_ptr() != src[0].data_ptr()
    # another stride of the same storage is not the same input: copied
    t = torch.arange(4.0).view(2, 2)
    st = torch.zeros(2, 2)
    assert bind_args((t.t(),), (st,)) == 1 and torch.equal(st, t.t())


@pytest.mark.parametrize("bad", ["shape", "dtype", "keys", "length", "static", "type"])
def test_bind_args_raises_on_another_signature(bad):
    static = (torch.zeros(3), {"k": torch.zeros(2)}, 5)
    args = {
        "shape": (torch.zeros(4), {"k": torch.zeros(2)}, 5),
        "dtype": (torch.zeros(3, dtype=torch.float64), {"k": torch.zeros(2)}, 5),
        "keys": (torch.zeros(3), {"j": torch.zeros(2)}, 5),
        "length": (torch.zeros(3), {"k": torch.zeros(2)}),
        "static": (torch.zeros(3), {"k": torch.zeros(2)}, 6),
        "type": (torch.zeros(3), {"k": [1.0, 2.0]}, 5),
    }[bad]
    static[0].fill_(-1.0)
    with pytest.raises((ValueError, TypeError)):
        bind_args(args, static)
    assert bool((static[0] == -1.0).all())  # checked whole before anything is copied


def test_tree_map_copies_tensors_and_keeps_the_nesting():
    tree = (torch.ones(2), {"a": [torch.zeros(1), 3]})
    out = tree_map(torch.Tensor.clone, tree)
    assert isinstance(out, tuple) and isinstance(out[1]["a"], list) and out[1]["a"][1] == 3
    assert out[0].data_ptr() != tree[0].data_ptr() and torch.equal(out[0], tree[0])


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_accounting_is_the_capture_delta_times_replays():
    """A capture's counted launches are taken back out (no kernel ran) and
    each replay adds them once; launches before the capture stay."""
    _build.reset_launches()
    _build.LAUNCHES["copy_convert"] += 3  # a warm-up, say: real launches
    before = collections.Counter(_build.LAUNCHES)
    _build.LAUNCHES["copy_convert"] += 4  # what the wrappers count while capturing
    _build.LAUNCHES["gather_pack"] += 2
    delta = take_launches(before)
    assert delta == {"copy_convert": 4, "gather_pack": 2}
    assert dict(_build.LAUNCHES) == {"copy_convert": 3}
    g = object.__new__(_Graph)
    g.graph, g.launches, g.outputs = _FakeGraph(), delta, "out"
    for _ in range(5):
        assert g.replay() == "out"
    assert g.graph.replays == 5
    assert dict(_build.LAUNCHES) == {"copy_convert": 3 + 5 * 4, "gather_pack": 5 * 2}
    # a capture that counted nothing leaves no zero entries behind
    assert take_launches(collections.Counter(_build.LAUNCHES)) == {}
    assert all(v > 0 for v in _build.LAUNCHES.values())
    _build.reset_launches()


# ---------------------------------------------------------------------------
# CPU: the serving engine's plans
# ---------------------------------------------------------------------------


def _serve(engine_cls, model, params, prompts, n_new, max_len=64):
    engine = engine_cls(model, params, max_slots=2, max_len=max_len)
    uids = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    out = engine.run()
    return engine, [out[u] for u in uids]


@pytest.mark.parametrize("name,want_inits", [("stablelm-1.6b", 1 + 1), ("rwkv6-1.6b", 3 + 1)])
def test_engine_plan_counts_unchanged(name, want_inits):
    """Prompts of 5, 8, 3 and 5 tokens, 6 new tokens each, two slots: one
    prefill plan per bucket (dense: bucket 8) or per distinct length (RWKV:
    3, 5, 8) plus one decode plan; every other start a hit.  The engine
    keeps one cache dict: a decode step writes its new state back into it."""
    cfg = get_config(name).reduced()
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 8, 3, 5)]
    engine = ServingEngine(model, params, max_slots=2, max_len=64)
    cache = engine._cache
    uids = [engine.submit(p, max_new_tokens=6) for p in prompts]
    out = engine.run()
    st = engine.stats
    assert engine._cache is cache
    assert st.prefills == 4 and all(len(out[u]) == 6 for u in uids)
    assert st.plan_inits == want_inits
    assert st.plan_hits == st.prefills + st.decode_steps - want_inits
    plans = list(engine.plans._plans.values())
    assert not any(p.captured for p in plans)


def test_carry_writes_fresh_entries_back_in_place():
    cache = {"k": torch.zeros(2, 3), "pos": torch.zeros(2, dtype=torch.int32)}
    k = cache["k"]
    k += 1.0  # updated in place by the step
    new = {"k": k, "pos": cache["pos"] + 1}
    pos = cache["pos"]
    assert _carry(cache, new) is cache
    assert cache["k"] is k and cache["pos"] is pos and pos.tolist() == [1, 1]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesced", "uncoalesced"])
@pytest.mark.parametrize("packer", ["slice", "cuda", "bf16", "scaled-int8"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_replay_equals_eager_bitwise(cuda, name, packer, coalesce):
    """5 cycles of the heat3d update: the captured plan's replays against
    its eager step ``plan.fn`` on the same start, bitwise; ``overlap``
    alternates its two graphs, one a parity.  ``standard`` has no plan and
    stays eager: its cycles equal ``persistent``'s eager ones."""
    assert set(STRATEGIES) == set(available_strategies())
    assert packer in available_packers()
    dom = _domain(cuda)
    update = heat3d_update(jacobi_weights().numpy(), cuda)
    x0 = dom.random(0)
    cfg = StrategyConfig(name=name, packer=packer, coalesce=coalesce,
                         n_parts=2 if name == "partitioned" else 1)
    drv = make_driver(cfg, dom.mesh, dom.halo_spec, ndim=3, update_fn=update)
    _build.reset_launches()
    got = _cycles(drv.step, x0.clone()).clone()
    torch.cuda.synchronize()
    if name == "standard":
        ref = make_driver(cfg.with_(name="persistent"), dom.mesh, dom.halo_spec, ndim=3,
                          update_fn=update)
        ref.init(x0)
        assert torch.equal(got, _cycles(ref.plan.fn, x0.clone()))
        ref.free()
        return
    plan = drv.plan
    assert plan.captured and len(plan._graphs) == (2 if name == "overlap" else 1)
    want = _cycles(plan.fn, x0.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if name == "overlap":  # each parity alone, from the same block
        for g, inputs in enumerate(plan.fn.graph_inputs):
            inputs[0].copy_(x0)
            out = plan.start(inputs[0])
            assert out is plan._graphs[g].outputs
            replayed = out.clone()
            inputs[0].copy_(x0)
            assert torch.equal(replayed, plan.fn(inputs[0].clone()))
    per_replay = plan._graphs[0].launches
    if packer in ("cuda", "bf16"):
        assert per_replay["copy_convert"] > 0 and _build.LAUNCHES["copy_convert"] > 0
    assert per_replay["stencil27"] >= 1
    drv.free()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["persistent", "overlap"])
def test_free_returns_the_memory(cuda, name):
    dom = _domain(cuda)
    update = heat3d_update(jacobi_weights().numpy(), cuda)
    x = dom.random(0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    drv = make_driver(StrategyConfig(name=name, packer="cuda"), dom.mesh, dom.halo_spec,
                      ndim=3, update_fn=update)
    y = drv.wait(drv.step(drv.step(x)))
    assert torch.cuda.memory_allocated(cuda) > before
    del y
    drv.free()
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) == before


@pytest.mark.cuda
def test_a_step_that_synchronizes_cannot_be_captured(cuda):
    x = torch.ones(8, device=cuda)

    def factory():
        return lambda t: t * t.sum().item()

    launches = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError):
        CommPlan(factory, device=cuda, example_args=(x,))
    assert dict(_build.LAUNCHES) == launches
    torch.cuda.synchronize()
    assert torch.equal(x * 2, torch.full((8,), 2.0, device=cuda))  # the card still works


class _EagerDecodeEngine(ServingEngine):
    """The engine with its decode plan built without example arguments:
    eager on the card (the comparison run only)."""

    def _plan(self, fn, args, *, example_args=None):
        return super()._plan(fn, args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama3-8b", "rwkv6-1.6b"])
def test_engine_graph_decode_equals_eager(cuda, name):
    """Reduced f32 engines, 16 new tokens a request: tokens equal graph
    against eager, and one more decode step's logits from the same cache
    within rtol=atol=1e-5 (the same kernels replayed; cuBLAS may pick
    another algorithm for the capture stream's workspace).  The llama
    heads are 64 wide, a width the flash kernel of its prefill takes."""
    upd = dict(dtype="float32", param_dtype="float32")
    if name == "llama3-8b":
        upd["head_dim"] = 64
    cfg = get_config(name).reduced().with_updates(**upd)
    model = build_model(cfg, cuda)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 8, 3, 12)]
    graph, got = _serve(ServingEngine, model, params, prompts, 16)
    eager, want = _serve(_EagerDecodeEngine, model, params, prompts, 16)
    assert got == want
    assert (graph.stats.plan_inits, graph.stats.plan_hits) == (
        eager.stats.plan_inits, eager.stats.plan_hits)
    decode = [p for p in graph.plans._plans.values() if p.captured]
    assert len(decode) == 1 and not any(p.captured for p in eager.plans._plans.values())
    plan = decode[0]
    token = torch.zeros((2, 1), dtype=torch.long, device=cuda)
    cache = tree_map(torch.Tensor.clone, graph._cache)
    want_logits, want_cache = plan.fn(token, tree_map(torch.Tensor.clone, cache))
    got_logits, got_cache = plan.start(token, cache)
    torch.testing.assert_close(got_logits, want_logits, rtol=1e-5, atol=1e-5)
    for k in got_cache:
        torch.testing.assert_close(got_cache[k], want_cache[k], rtol=1e-5, atol=1e-5)
