"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` alone into its own shared library (no PyTorch headers, so a build
takes seconds rather than minutes), at first use, into
``build/repro_torch_kernels/`` under the repository root (override with
``REPRO_TORCH_BUILD_DIR``).  Libraries are named by a hash of their source
and flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code, so a refused launch (too many threads, too much shared
memory) is reported at its call site instead of vanishing.

``LAUNCHES`` counts kernel launches by kernel name.  A wrapper adds one
exactly where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.

A kernel is a ctypes call: its output has no ``grad_fn``.  A wrapper
without a backward calls :func:`refuse_grad` first, so a gradient through
it raises instead of silently stopping at its output.

On meta tensors the LM kernels' wrappers launch nothing: they return
outputs of the kernel's shapes and dtypes and :func:`record_cost` its
operations and bytes (:mod:`repro_torch.kernels.costs`) into
``COST_LOG`` when a count is on (``comm_analysis.count_cost``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_REPO = pathlib.Path(__file__).resolve().parents[3]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: collections.Counter = collections.Counter()

#: ``(kernel name, flops, bytes)`` of every meta-route call while a cost
#: count is on (``comm_analysis.count_cost`` sets it to a list), else None
COST_LOG: list | None = None

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def build_dir() -> pathlib.Path:
    return pathlib.Path(
        os.environ.get("REPRO_TORCH_BUILD_DIR", _REPO / "build" / "repro_torch_kernels")
    )


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return str(path)


def _target(name: str) -> pathlib.Path:
    digest = hashlib.sha256(
        (_CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build_all(names: list[str] | None = None, *, verbose: bool = False) -> dict[str, pathlib.Path]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together; returns name -> library path.  ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's register/spill report."""
    names = sources() if names is None else names
    out = {name: _target(name) for name in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        if verbose and log:
            print(f"--- {name}.cu ---\n{log}", end="")
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use) with every entry
    point in ``signatures`` declared: ``{fn: [ctypes argtypes...]}``, all
    returning the ``int`` error code of :func:`check`."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def refuse_grad(name: str, *tensors, why: str) -> None:
    """Raise ``NotImplementedError`` when grad is enabled and any of
    ``tensors`` requires grad: the kernel ``name`` has no backward, and its
    output would cut the graph (``why`` says where the backward is, or
    which ROADMAP item it waits for)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: no backward kernel, so a gradient through it would "
                                  f"stop at its output; {why}")


def record_cost(name: str, cost: tuple[int, int]) -> None:
    """A meta route's call of kernel ``name``: its ``(flops, bytes)`` into
    ``COST_LOG`` when a count is on.  Never a launch: ``LAUNCHES`` is not
    touched."""
    if COST_LOG is not None:
        COST_LOG.append((name, *cost))


def check(code: int, what: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
