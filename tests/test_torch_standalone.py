"""The PyTorch port stands alone and never runs on the CPU unasked.

* No module of ``src/repro_torch/`` and no line of ``chip_smoke.py`` imports
  ``jax`` or anything of the JAX package ``repro`` (checked on the syntax
  tree, so an import inside a function counts too).
* Entry points take the card by default: without CUDA they raise instead of
  running on the CPU, and the CUDA kernel wrappers refuse CPU tensors.
"""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_modules_and_smoke_script():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for required in ("chip_smoke.py", "src/repro_torch/core/transport.py",
                     "src/repro_torch/stencil/comb.py",
                     "src/repro_torch/kernels/pack/pack.py",
                     "src/repro_torch/kernels/stencil27/stencil27.py"):
        assert required in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_package_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_kernel_sources_are_built_not_committed_binaries():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    names = sorted(p.name for p in csrc.iterdir())
    assert {"pack.cu", "stencil27.cu"} <= set(names)
    assert all(n.endswith((".cu", ".cuh")) for n in names), names


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core.compat import resolve_device
    from repro_torch.core.mesh import make_mesh

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh((2,), ("px",))
    assert make_mesh((2,), ("px",), device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.pack.pack import copy_convert, gather_pack
    from repro_torch.kernels.stencil27.stencil27 import stencil27

    x = torch.zeros((2, 5, 5, 5))
    with pytest.raises(ValueError, match="CUDA"):
        copy_convert(x, torch.empty_like(x))
    with pytest.raises(ValueError, match="CUDA"):
        gather_pack(x, torch.zeros((1, 7), dtype=torch.int64), torch.empty((2, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        stencil27(x, torch.zeros((3, 3, 3)), torch.empty((2, 3, 3, 3)))
