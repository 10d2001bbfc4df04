"""The port's sharding rules against the JAX package's
(``repro.parallel.sharding``, ``repro.train.train_loop.state_pspecs``), on
the CPU, at the full width of stablelm-1.6b and llama3-8b (the port's
shapes as meta tensors, JAX's by ``jax.eval_shape``) on a ``(16, 16)`` mesh
over ``("data", "model")``.

The port's specs follow its layout (one dict a layer, weight matrices
``(out, in)``); mapped onto JAX's (each leaf's stacked entries, the same
over its layers, then a matrix's two entries swapped back) they must equal
JAX's exactly.  llama3-8b's 32 layers divide over the 16 data ranks, so
ZeRO-1 shards its moments' layer-stack dim, which only the mapping shows.
"""

import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.parallel import sharding as JS
from repro.parallel.context import ParallelContext as JParallelContext
from repro.train import train_loop as JT
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.launch.mesh import data_axes_of, make_production_mesh
from repro_torch.models import build_model
from repro_torch.parallel import sharding as S
from repro_torch.parallel.context import ParallelContext
from repro_torch.train import train_loop as T

torch.set_num_threads(1)

ARCHS = ("stablelm-1.6b", "llama3-8b")


@dataclasses.dataclass(frozen=True)
class _JMesh:
    """What JAX's rules read of a mesh: its axis sizes."""

    shape: dict


J_MESH = _JMesh({"data": 16, "model": 16})


def _jax_layout(tree, path=()):
    """The port's spec tree on JAX's layout: a list of layers joined (their
    specs must agree), a 2-D weight matrix's entries swapped."""
    if isinstance(tree, dict):
        return {k: _jax_layout(v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        subs = [_jax_layout(v, path) for v in tree]
        assert all(s == subs[0] for s in subs), path
        return subs[0]
    entries = tuple(tree)
    stacked = 1 if path[0] == "layers" else 0
    if len(entries) - stacked == 2 and path[-1].startswith("w"):
        entries = entries[:stacked] + entries[stacked:][::-1]
    return entries


def _as_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.fixture(scope="module", params=ARCHS)
def shapes(request):
    name = request.param
    model = build_model(get_config(name), "cpu")
    jmodel = j_build_model(j_get_config(name))
    state = T.init_state(model, OptimizerConfig(), "meta")
    jstate = jax.eval_shape(lambda: JT.init_state(jmodel, JOptimizerConfig(),
                                                  jax.random.key(0)))
    return name, model, jmodel, state, jstate


def test_param_and_zero1_specs_match_jax(shapes):
    name, model, _, state, jstate = shapes
    params, jparams = state["params"], jstate["params"]
    assert all(t.device.type == "meta" for _, t in T.tree_leaves(params))
    ps = S.param_pspecs(params, cfg=model.cfg, model_size=16)
    jps = JS.param_pspecs(jparams, model_size=16)
    assert _jax_layout(ps) == _as_tuples(jps)
    zs = S.zero1_pspecs(params, ps, cfg=model.cfg, data_axes=("data",), mesh=J_MESH)
    jzs = JS.zero1_pspecs(jparams, jps, data_axes=("data",), mesh=J_MESH)
    assert _jax_layout(zs) == _as_tuples(jzs)
    # the traps the mapping handles: column-parallel is the port's dim 0
    assert tuple(ps["layers"][0]["attn"]["wq"]) == (None, "model", None)
    if name == "llama3-8b":  # 32 layers over 16 data ranks: the stack dim
        assert tuple(zs["layers"][0]["attn"]["wq"]) == ("data", "model", None)


def test_state_pspecs_match_jax(shapes):
    _, model, jmodel, state, jstate = shapes
    mesh = make_production_mesh()
    assert mesh.device.type == "meta" and mesh.shape == {"data": 16, "model": 16}
    ctx = ParallelContext(mesh=mesh, data_axes=data_axes_of(mesh))
    jctx = JParallelContext(mesh=J_MESH, data_axes=("data",))
    got = T.state_pspecs(model, state, mesh, ctx)
    want = JT.state_pspecs(jmodel, jstate, J_MESH, jctx)
    assert _jax_layout(got["params"]) == _as_tuples(want["params"])
    for k in ("m", "v"):
        assert _jax_layout(got["opt"][k]) == _as_tuples(want["opt"][k])
    assert tuple(got["opt"]["step"]) == tuple(want["opt"]["step"]) == ()


def test_production_mesh_is_metadata():
    pod = make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    assert data_axes_of(pod) == ("pod", "data")
    assert data_axes_of(make_production_mesh()) == ("data",)


def test_batch_and_cache_specs_match_jax():
    batch = {"tokens": torch.empty((32, 4096), device="meta"),
             "labels": torch.empty((32, 4096), device="meta"),
             "one": torch.empty((1, 8), device="meta"), "s": torch.empty((), device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), "float32") for k, v in batch.items()}
    for mesh in (J_MESH, None):
        got = S.batch_pspecs(batch, data_axes=("data",), mesh=mesh)
        want = JS.batch_pspecs(jbatch, data_axes=("data",), mesh=mesh)
        assert {k: tuple(v) for k, v in got.items()} == _as_tuples(want)
    model = build_model(get_config("llama3-8b"), "cpu")
    cache = model.init_cache(128, 1024, device="meta")
    jcache = jax.eval_shape(lambda: j_build_model(j_get_config("llama3-8b")).init_cache(128, 1024))
    got = S.cache_pspecs(cache, data_axes=("data",), model_size=16, mesh=J_MESH)
    want = JS.cache_pspecs(jcache, data_axes=("data",), model_size=16, mesh=J_MESH)
    assert {k: tuple(v) for k, v in got.items()} == _as_tuples(want)
