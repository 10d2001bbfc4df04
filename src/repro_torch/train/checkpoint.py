"""Atomic, CRC-checked, async checkpoints in the JAX package's on-disk
format (PyTorch port of ``src/repro/train/checkpoint.py``).

Layout (the same as the JAX package's, so a checkpoint written by either
restores in the other)::

    <dir>/step_<N>/
        manifest.json    tree structure, leaf paths, shapes, dtypes, crc32
        leaf_<i>.npy     one array per tree leaf
        _COMMITTED       written last; an uncommitted dir is ignored

A tree is a nesting of dicts (flattened in sorted key order, as
``jax.tree.flatten``), lists and tuples; ``None`` holds no leaf.  A leaf is
a tensor on any device, a numpy array or a numpy scalar.  numpy has no
bfloat16 or float8: those leaves are stored as a same-width unsigned view
under their own dtype name (``"bfloat16"`` as ``uint16``), the view taken
through torch and numpy alone.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.compat import resolve_device
from repro_torch.core.plan import tree_map

Params = Any
_COMMIT = "_COMMITTED"

#: dtype name -> (torch dtype, the same-width torch integer it is viewed as
#: for numpy, the numpy dtype it is stored as)
_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the host array the file holds, and its dtype name; a
    tensor is copied off its device, never shared with the caller, and in
    C order whatever its strides (JAX hands ``np.save`` a C-ordered array,
    so a transposed tensor would otherwise write a Fortran-order file)."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if name in _VIEW_DTYPES:
            return t.view(_VIEW_DTYPES[name][1]).numpy().view(_VIEW_DTYPES[name][2]), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _VIEW_DTYPES:
        dtype, view, _ = _VIEW_DTYPES[dtype_name]
        return torch.from_numpy(arr.view(str(view).removeprefix("torch."))).view(dtype)
    return torch.from_numpy(arr)


def _crc32(arr: np.ndarray) -> int:
    """The manifest's checksum, ``zlib.crc32(arr.tobytes())``, without the
    copy ``tobytes`` makes."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# trees (the subset of jax.tree the checkpoints use)
# ---------------------------------------------------------------------------


def _flatten(tree: Any, path: tuple = ()) -> list[tuple[str, Any]]:
    """``(path, leaf)`` in ``jax.tree.flatten`` order; a path is its keys
    and indices joined by ``/``."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten(tree[k], (*path, str(k)))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _flatten(v, (*path, str(i)))]
    if tree is None:
        return []
    return [("/".join(path), tree)]


def _treedef(tree: Any) -> str:
    """``str(jax.tree.structure(tree))`` of such a tree."""
    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(v) for v in t) + ("," if len(t) == 1 else "") + ")"
        return "None" if t is None else "*"

    return f"PyTreeDef({walk(tree)})"


def _unflatten(like: Any, leaves: list) -> Any:
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return None if t is None else next(it)

    out = walk(like)
    if next(it, None) is not None:
        raise ValueError("the checkpoint holds more leaves than `like`")
    return out


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def save(state: Params, ckpt_dir: str, step: int, *, keep: int = 3) -> str:
    """Atomic synchronous save; returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    manifest = {
        "step": step,
        "treedef": _treedef(state),
        "n_leaves": len(flat),
        "paths": [p for p, _ in flat],
        "leaves": [],
        "time": time.time(),
    }
    for i, (_, leaf) in enumerate(flat):
        arr, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "crc32": _crc32(arr),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write(str(step))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _apply_retention(ckpt_dir, keep)
    return final


def _apply_retention(ckpt_dir: str, keep: int) -> None:
    steps = committed_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def committed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, _COMMIT)):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _tree_from_paths(paths: list[str], leaves: list) -> Params:
    """Nested dicts rebuilt from the manifest's leaf paths (``"a/b/c"``):
    the structure-free restore, for a process that knows the directory but
    never held the state (a sequence comes back as a dict keyed by its
    stringified indices; pass ``like`` where that matters)."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def restore(ckpt_dir: str, step: int | None = None, *, like: Params = None,
            device: str | torch.device | None = None,
            verify: bool = True) -> tuple[Params, int]:
    """Load a checkpoint (the latest committed one by default); every leaf
    a tensor on ``device`` (the card unless ``"cpu"`` is asked for).

    ``like`` supplies the tree structure; without it the structure comes
    from the manifest's leaf paths (nested dicts).  ``verify`` checks each
    leaf's crc32 and raises ``IOError`` on a mismatch.
    """
    dev = resolve_device(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for meta in manifest["leaves"]:
        arr = np.load(os.path.join(d, meta["file"]))
        if verify and _crc32(arr) != meta["crc32"]:
            raise IOError(f"checksum mismatch in {meta['file']}")
        leaves.append(_from_numpy(arr, meta["dtype"]).to(dev))
    if like is None:
        return _tree_from_paths(manifest["paths"], leaves), step
    return _unflatten(like, leaves), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer.  :meth:`save` copies every
    tensor to the host before its thread starts: a persistent plan's output
    tensor is overwritten by the plan's next start, so the thread must
    never read the caller's tensors (numpy leaves are the caller's, as in
    the JAX package)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.saved_steps: list[int] = []

    def save(self, state: Params, step: int) -> None:
        self.wait()
        host_state = tree_map(lambda t: t.detach().to("cpu", copy=True), state)

        def work():
            try:
                save(host_state, self.ckpt_dir, step, keep=self.keep)
                self.saved_steps.append(step)
            except Exception as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
