"""The PyTorch port stands alone and never runs on the CPU unasked.

* No module of ``src/repro_torch/``, no line of ``chip_smoke.py`` and none
  of the port's example imports ``jax``, ``ml_dtypes`` or anything of the
  JAX package ``repro`` (checked on the syntax tree, so an import inside a function
  counts too).
* Entry points take the card by default: without CUDA they raise instead of
  running on the CPU, and the CUDA kernel wrappers refuse CPU tensors.
"""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "stencil_heat3d_torch.py",
    ROOT / "tools" / "ring_lm.py", ROOT / "tools" / "moe_lm.py",
    ROOT / "tools" / "serve_bench_lm.py", ROOT / "tools" / "families_lm.py",
    ROOT / "tools" / "train_lm.py", ROOT / "examples" / "train_lm_torch.py",
    ROOT / "tools" / "trace_sessions.py"]


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
                     "src/repro_torch/kernels/stencil27/stencil27.py",
                     "src/repro_torch/configs/base.py", "src/repro_torch/configs/llama3_8b.py",
                     "src/repro_torch/parallel/context.py",
                     "src/repro_torch/kernels/flash_attention/flash.py",
                     "src/repro_torch/kernels/flash_attention/ops.py",
                     "src/repro_torch/kernels/flash_attention/ref.py",
                     "src/repro_torch/models/layers.py", "src/repro_torch/models/transformer.py",
                     "src/repro_torch/models/api.py", "src/repro_torch/models/convert.py",
                     "src/repro_torch/serving/engine.py", "src/repro_torch/launch/serve.py",
                     "src/repro_torch/launch/mapping.py", "src/repro_torch/core/autotune.py",
                     "src/repro_torch/stencil/sweep.py",
                     "src/repro_torch/train/fault_tolerance.py",
                     "src/repro_torch/train/checkpoint.py",
                     "src/repro_torch/launch/membership.py",
                     "src/repro_torch/launch/elastic.py",
                     "src/repro_torch/core/partitioned.py", "src/repro_torch/core/ring.py",
                     "tools/ring_lm.py", "tools/moe_lm.py", "src/repro_torch/models/moe.py",
                     "src/repro_torch/configs/phi3_5_moe_42b.py",
                     "src/repro_torch/configs/grok_1_314b.py",
                     "examples/stencil_heat3d_torch.py",
                     "src/repro_torch/core/model_comm.py",
                     "src/repro_torch/configs/comb_paper.py",
                     "src/repro_torch/core/comm_analysis.py",
                     "src/repro_torch/serving/bench.py", "tools/serve_bench_lm.py",
                     "src/repro_torch/models/ssm.py", "src/repro_torch/models/hybrid.py",
                     "src/repro_torch/models/vision.py", "src/repro_torch/models/encoder.py",
                     "src/repro_torch/configs/zamba2_1_2b.py",
                     "src/repro_torch/configs/llama_3_2_vision_11b.py",
                     "src/repro_torch/configs/hubert_xlarge.py", "tools/families_lm.py",
                     "src/repro_torch/train/optimizer.py", "src/repro_torch/train/train_loop.py",
                     "src/repro_torch/data/pipeline.py", "src/repro_torch/parallel/sharding.py",
                     "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/train.py",
                     "tools/train_lm.py", "examples/train_lm_torch.py",
                     "tools/trace_sessions.py"):
        assert required in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_package_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "ml_dtypes"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_serve_bench_raises_without_cuda():
    """The serve bench's CLI takes the card by default, as the other entry
    points do."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.serving.bench import main, serve_once

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_once(requests=1)


def test_kernel_sources_are_built_not_committed_binaries():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    names = sorted(p.name for p in csrc.iterdir())
    assert {"pack.cu", "stencil27.cu", "flash_attention.cu"} <= set(names)
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


def test_training_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch.train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "1"])


def test_serving_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models import build_model

    cfg = get_config("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "llama3-8b", "--reduced"])
    assert build_model(cfg, "cpu").device.type == "cpu"


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


def test_flash_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention.flash import flash_attention

    q = torch.zeros((1, 8, 4, 128))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
