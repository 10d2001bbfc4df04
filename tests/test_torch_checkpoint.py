"""The port's ``train/checkpoint.py`` against the JAX package's on-disk
format.

* A checkpoint the JAX package writes restores bitwise in the port, and one
  the port writes restores bitwise in the JAX package, for f32, bf16 and
  int leaves; both write the same manifest (every field but the wall-clock
  ``time``), the treedef string included.
* The JAX package's checkpoint cases on the port: round trip, retention and
  the latest step, an uncommitted directory ignored, a corrupted leaf
  failing its CRC, the async writer (which copies every leaf before its
  thread starts), ``like=`` and the structure-free restore.
* ``restore`` takes the card unless asked for the CPU; the ``cuda`` test
  (run on the card) snapshots a persistent plan's output that the plan's
  next start overwrites while the writer's thread runs.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as j_ckpt
from repro_torch.train import checkpoint as t_ckpt

torch.set_num_threads(1)


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(4, 6)).astype(np.float32),
                   "b": rng.normal(size=(6,)).astype(np.float32),
                   "e": rng.normal(size=(3, 5)).astype(np.float32)},
        "opt": {"m": {"w": np.zeros((4, 6), np.float32), "b": np.ones((6,), np.float32)},
                "step": np.asarray(7, np.int32)},
        "ids": np.arange(10, dtype=np.int32).reshape(2, 5),
        "count": np.int64(3),
    }


#: leaves stored as bf16 (the rest keep their numpy dtype)
BF16 = {("params", "w"), ("params", "e")}


def _jax_state(np_state):
    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, (*path, k)) for k, v in t.items()}
        if path in BF16:
            return jnp.asarray(t, jnp.bfloat16)
        return t if isinstance(t, np.generic) else jnp.asarray(t)

    return walk(np_state)


def _torch_state(np_state):
    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, (*path, k)) for k, v in t.items()}
        if path in BF16:
            return torch.from_numpy(t).to(torch.bfloat16)
        return t if isinstance(t, np.generic) else torch.from_numpy(t)

    return walk(np_state)


def _bits(leaf) -> tuple[str, np.ndarray]:
    """(dtype name, raw bits as numpy) of a JAX or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        if leaf.dtype == torch.bfloat16:
            return name, leaf.view(torch.int16).numpy().view(np.uint16)
        return name, leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype == ml_dtypes.bfloat16:
        return "bfloat16", arr.view(np.uint16)
    return str(arr.dtype), arr


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], (*prefix, k))
    else:
        yield prefix, tree


def _manifest(path):
    m = json.loads((path / "manifest.json").read_text())
    m.pop("time")
    return m


def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path):
    np_state = _numpy_state()
    jstate = _jax_state(np_state)
    j_ckpt.save(jstate, str(tmp_path), 11)
    got, step = t_ckpt.restore(str(tmp_path), device="cpu")
    assert step == 11
    want = dict(_paths(jstate))
    have = dict(_paths(got))
    assert want.keys() == have.keys()
    for path, leaf in have.items():
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        (tn, tb), (jn, jb) = _bits(leaf), _bits(want[path])
        assert tn == jn, path
        np.testing.assert_array_equal(tb, jb, err_msg=str(path))
    assert got["params"]["w"].dtype == torch.bfloat16
    assert got["count"].dtype == torch.int64 and int(got["count"]) == 3


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    np_state = _numpy_state(1)
    tstate = _torch_state(np_state)
    t_ckpt.save(tstate, str(tmp_path), 4)
    jstate = _jax_state(np_state)
    got, step = j_ckpt.restore(str(tmp_path), like=jstate)
    assert step == 4
    for (path, g), (_, w) in zip(_paths(got), _paths(jstate)):
        (gn, gb), (wn, wb) = _bits(g), _bits(w)
        if (gn, wn) == ("int32", "int64"):
            # JAX's own restore casts int64 to int32 (x64 off): the file
            # holds the port's int64
            assert np.load(tmp_path / "step_00000004" / "leaf_00000.npy").dtype == np.int64
        else:
            assert gn == wn, path
        np.testing.assert_array_equal(gb, wb, err_msg=str(path))
    # JAX's structure-free restore reads the port's leaf paths
    free, _ = j_ckpt.restore(str(tmp_path))
    assert set(free) == {"params", "opt", "ids", "count"}
    assert set(free["opt"]["m"]) == {"w", "b"}


def test_both_packages_write_the_same_manifest(tmp_path):
    np_state = _numpy_state(2)
    j_ckpt.save(_jax_state(np_state), str(tmp_path / "jax"), 9)
    t_ckpt.save(_torch_state(np_state), str(tmp_path / "torch"), 9)
    jm = _manifest(tmp_path / "jax" / "step_00000009")
    tm = _manifest(tmp_path / "torch" / "step_00000009")
    assert tm == jm
    # and the same bytes in every leaf file
    for meta in jm["leaves"]:
        a = np.load(tmp_path / "jax" / "step_00000009" / meta["file"])
        b = np.load(tmp_path / "torch" / "step_00000009" / meta["file"])
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


TREES = [
    {"interior": 1, "step": 2},
    {"b": [1, (2, 3)], "a": {"x": None, "y": 1}},
    [1],
    (1,),
    {},
    {"k": []},
    {"a": {"b": (4, [5, None])}},
]


@pytest.mark.parametrize("tree", TREES, ids=range(len(TREES)))
def test_treedef_and_leaf_paths_match_jax(tree):
    assert t_ckpt._treedef(tree) == str(jax.tree.structure(tree))
    flat = t_ckpt._flatten(tree)
    assert [leaf for _, leaf in flat] == jax.tree.leaves(tree)
    assert [p for p, _ in flat] == j_ckpt._leaf_paths(tree)


def test_roundtrip_exact_with_like(tmp_path):
    state = _torch_state(_numpy_state())
    state["opt"]["moments"] = [torch.zeros(3), (torch.ones(2, dtype=torch.int64),)]
    t_ckpt.save(state, str(tmp_path), 10)
    restored, step = t_ckpt.restore(str(tmp_path), like=state, device="cpu")
    assert step == 10
    assert isinstance(restored["opt"]["moments"], list)
    assert isinstance(restored["opt"]["moments"][1], tuple)
    for a, b in zip(t_ckpt._flatten(state), t_ckpt._flatten(restored)):
        ta = a[1] if isinstance(a[1], torch.Tensor) else torch.as_tensor(a[1])
        assert b[1].dtype == ta.dtype and torch.equal(b[1], ta)


def test_latest_and_retention(tmp_path):
    state = _torch_state(_numpy_state())
    for s in (1, 2, 3, 4):
        t_ckpt.save(state, str(tmp_path), s, keep=2)
    assert t_ckpt.committed_steps(str(tmp_path)) == [3, 4]
    assert t_ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_uncommitted_dir_ignored_and_commit_is_atomic(tmp_path):
    state = _torch_state(_numpy_state())
    t_ckpt.save(state, str(tmp_path), 1)
    # a crashed save: no commit marker
    d = tmp_path / "step_00000002"
    d.mkdir()
    (d / "manifest.json").write_text("{}")
    # a half-written save of step 3 left behind as .tmp
    (tmp_path / "step_00000003.tmp").mkdir()
    assert t_ckpt.latest_step(str(tmp_path)) == 1
    assert j_ckpt.latest_step(str(tmp_path)) == 1
    path = t_ckpt.save(state, str(tmp_path), 3)
    assert not (tmp_path / "step_00000003.tmp").exists()
    assert os.path.exists(os.path.join(path, "_COMMITTED"))
    assert t_ckpt.committed_steps(str(tmp_path)) == [1, 3]


@pytest.mark.parametrize("leaf", ["params/b", "params/w", "count"])  # f32, bf16, int64
def test_corruption_detected(tmp_path, leaf):
    state = _torch_state(_numpy_state())
    path = t_ckpt.save(state, str(tmp_path), 5)
    with open(os.path.join(path, "manifest.json")) as f:
        index = json.load(f)["paths"].index(leaf)
    name = os.path.join(path, f"leaf_{index:05d}.npy")
    arr = np.load(name)
    arr.reshape(-1).view(np.uint8)[0] ^= 0xFF
    np.save(name, arr)
    with pytest.raises(IOError, match="checksum"):
        t_ckpt.restore(str(tmp_path), device="cpu")
    with pytest.raises(IOError, match="checksum"):
        j_ckpt.restore(str(tmp_path))
    got, _ = t_ckpt.restore(str(tmp_path), device="cpu", verify=False)
    assert got is not None


def test_crc_matches_tobytes():
    for arr in (np.arange(7, dtype=np.int64), np.asarray(3.5, np.float32),
                np.ones((3, 4), np.float32)[:, ::2], np.zeros(0, np.float32)):
        assert t_ckpt._crc32(arr) == zlib_crc(arr)


def zlib_crc(arr):
    import zlib

    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def test_async_checkpointer_snapshots_before_its_thread(tmp_path):
    x = torch.arange(12, dtype=torch.float32)
    ac = t_ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    for s in (2, 4, 6):
        ac.save({"x": x, "s": np.int64(s)}, s)
        x.add_(100)  # the caller's tensor moves on at once
    ac.wait()
    assert t_ckpt.committed_steps(str(tmp_path)) == [2, 4, 6]
    assert ac.saved_steps == [2, 4, 6]
    for k, s in enumerate((2, 4, 6)):
        got, step = t_ckpt.restore(str(tmp_path), s, device="cpu")
        assert step == s and int(got["s"]) == s
        assert torch.equal(got["x"], torch.arange(12, dtype=torch.float32) + 100 * k)


def test_restore_takes_the_card_unless_asked(tmp_path):
    t_ckpt.save({"a": torch.ones(2)}, str(tmp_path), 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_ckpt.restore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "empty"), device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card; see chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_async_snapshot_of_a_plan_output_on_the_card(cuda, tmp_path):
    """A persistent plan's output is overwritten by its next start: the
    writer must have copied it to the host before save() returned."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch.elastic import diffusion_update
    from repro_torch.stencil import Domain, StrategyConfig, make_driver

    dom = Domain(make_mesh((4,), ("px",), device=cuda), (256, 512, 64), ("px", None, None))
    drv = make_driver(StrategyConfig(name="persistent", packer="cuda"), dom.mesh,
                      dom.halo_spec, ndim=3, update_fn=diffusion_update())
    x = drv.wait(drv.step(dom.random(0)))
    assert drv.plan.captured
    want = x.cpu()
    ac = t_ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save({"x": x, "bf": x.to(torch.bfloat16)}, 1)
    for _ in range(5):
        x = drv.step(x)  # the same storage, overwritten by each replay
    drv.wait(x)
    ac.wait()
    got, _ = t_ckpt.restore(str(tmp_path), device=cuda)
    assert got["x"].device.type == "cuda"
    assert torch.equal(got["x"].cpu(), want)
    assert torch.equal(got["bf"].cpu(), want.to(torch.bfloat16))
    drv.free()
