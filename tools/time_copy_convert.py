"""Time the port's ``copy_convert`` kernel at the heat3d pz face, two ways.

The window is the one the heat3d main path packs (``chip_smoke.py``): the
pz face ``(8, 1, 514, 512)`` f32 of a ``(8, 258, 514, 512)`` stacked block,
packed into a wire buffer (f32 or bf16) and unpacked into a ghost window.
Each case is timed, after an L2 flush each time, as

* ``events_ms``: CUDA events around one call of the wrapper, median of 7
  (the wrapper's host time is inside the window; ``chip_smoke.py``'s ``ms``);
* ``device_ms``: the kernel's own device time by ``torch.profiler``, mean
  of 7 (the flush's fill left out);
* ``host_us``: host time of one wrapper call, mean of 200 calls with no
  synchronize between them;

beside ``Tensor.copy_`` of the same window timed both ways.  It uses only
the wrapper's public call, so the same script times any version of the
package.  Run it from a checkout's root on a machine with a card::

    PYTHONPATH=src python3 tools/time_copy_convert.py --label change

and, to compare two versions in one session, from each checkout's ``src``
in turns (parent, change, change, parent).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def events_ms(torch, fn, flush, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, flush, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "Fill" not in e.key)
    return total / reps / 1e3


def host_us(torch, fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="name of the version timed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_copy_convert: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.pack import pack as pack_k

    _build.build_all(["pack"])
    dev = torch.device("cuda")
    xb = torch.randn((8, 258, 514, 512), generator=torch.Generator(dev).manual_seed(0),
                     device=dev)
    win = xb[:, 1:2]
    ghost = torch.zeros((8, 2, 514, 512), device=dev)[:, 1:2]
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    cases = {}
    for wire in (torch.float32, torch.bfloat16):
        buf = torch.empty(win.shape, dtype=wire, device=dev)
        w = str(wire)[6:]
        for case, src, dst in ((f"pack f32->{w}", win, buf), (f"unpack {w}->f32", buf, ghost)):
            def kernel(src=src, dst=dst):
                return pack_k.copy_convert(src, dst)

            def copy(src=src, dst=dst):
                return dst.copy_(src)

            cases[case] = dict(
                events_ms=events_ms(torch, kernel, flush), device_ms=device_ms(torch, kernel, flush),
                host_us=host_us(torch, kernel),
                copy_events_ms=events_ms(torch, copy, flush), copy_device_ms=device_ms(torch, copy, flush),
            )
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"label": args.label, "card": smi[0] if smi else "not read",
                      "torch": torch.__version__, "window": list(win.shape), "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
