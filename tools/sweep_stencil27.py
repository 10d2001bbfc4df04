"""Time shape variants of the port's ``stencil27`` kernel at the heat3d shape.

Each variant is ``src/repro_torch/kernels/csrc/stencil27.cu`` with its
shape constants replaced (rows of outputs a thread ``RY``, warps a block
``WARPS``, shared-memory stages ``NS``) or with each term contracted into
an FMA, built by ``nvcc`` into ``build/stencil27_sweep/`` (all builds
started together) and called through its C entry point at the heat3d
update's shape: the x-wrapped ``(8, 258, 514, 514)`` block into the
interior window of an ``(8, 258, 514, 512)`` block, in f32 and in bf16.
Every variant is timed by CUDA events around one call (median of 9), in
two rounds taken in turn, and its output is compared with
``stencil27_ref`` bit for bit.  Run it from a checkout's root on a machine
with a card::

    PYTHONPATH=src python3 tools/sweep_stencil27.py

Prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "stencil27.cu"
OUT_DIR = ROOT / "build" / "stencil27_sweep"
TERM = "acc[i] = __fadd_rn(acc[i], __fmul_rn(w[DZ * 9 + dy * 3 + dx], v[i + dy][dx]));"
FMA_TERM = "acc[i] = fmaf(w[DZ * 9 + dy * 3 + dx], v[i + dy][dx], acc[i]);"
#: name -> (RY, WARPS, NS, FMA); the first is the source as it stands
VARIANTS = {
    "source (8 rows, 8 warps, 4 stages)": (8, 8, 4, False),
    "4 warps": (8, 4, 4, False),
    "4 rows, 16 warps": (4, 16, 4, False),
    "6 rows": (6, 8, 4, False),
    "16 rows, 4 warps": (16, 4, 4, False),
    "3 stages": (8, 8, 3, False),
    "5 stages": (8, 8, 5, False),
    "FMA": (8, 8, 4, True),
}


def variant_source(text: str, ry: int, warps: int, ns: int, fma: bool) -> str:
    for name, value in (("RY", ry), ("WARPS", warps), ("NS", ns)):
        line = next(ln for ln in text.splitlines() if ln.startswith(f"constexpr int {name} = "))
        text = text.replace(line, f"constexpr int {name} = {value};" + line.split(";", 1)[1])
    if fma:
        assert TERM in text, "the kernel's term changed; update TERM"
        text = text.replace(TERM, FMA_TERM)
    return text


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_stencil27: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil27 import stencil27_ref

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for i, (name, shape) in enumerate(VARIANTS.items()):
        src, lib = OUT_DIR / f"v{i}.cu", OUT_DIR / f"libv{i}.so"
        src.write_text(variant_source(text, *shape))
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, registers = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
        registers[name] = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        f = ctypes.CDLL(str(lib)).stencil27
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        f.argtypes = [P, P, P, I, I, I, I, I, I, I, L, L, L, L, I, P]
        libs[name] = f

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    block = torch.randn((8, 258, 514, 512), generator=gen, device=dev)
    w = torch.randn((3, 3, 3), generator=gen, device=dev)
    cases = {}
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        blk = block.to(dtype)
        xp = torch.cat([blk[..., -1:], blk, blk[..., :1]], dim=-1)
        cases[str(dtype)[6:]] = (code, xp, blk[:, 1:-1, 1:-1, :], stencil27_ref(xp, w))
    del block

    def events_ms(fn, reps: int = 9) -> float:
        fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    results = {name: {"registers": registers[name]} for name in VARIANTS}
    for _ in range(2):
        for name, f in libs.items():
            for dname, (code, xp, out, want) in cases.items():
                def call(f=f, code=code, xp=xp, out=out):
                    rc = f(xp.data_ptr(), out.data_ptr(), w.data_ptr(), code, 8, 256, 512, 512,
                           256, 8, *out.stride(), 1, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"variant {name!r}: CUDA error {rc}")

                out.zero_()
                call()
                torch.cuda.synchronize()
                r = results[name].setdefault(dname, {"ms": [], "bitwise": torch.equal(out, want)})
                r["ms"].append(events_ms(call))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0] if smi else "not read", "torch": torch.__version__,
                      "input": [8, 258, 514, 514], "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
