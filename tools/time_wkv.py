"""Time the port's ``wkv_chunked`` kernel at the rwkv6-1.6b serving shapes,
through its public wrapper only.

* prefill: r, k, v, lw ``(1, 2048, 32, 64)`` f32, chunk 64, no state (the
  2048-token prompt of ``chip_smoke.py`` phase D);
* decode: ``(4, 1, 32, 64)`` f32 with a starting state (a decode step at
  four slots).

Inputs are the model's: r, k, v normal, lw = -exp(N(-1, 0.5)), u normal x
0.1, from ``torch.Generator`` seed 11.  Each case is timed as

* ``events_ms``: CUDA events around one call of the wrapper, median of 7
  (the wrapper's host time is inside the window; ``chip_smoke.py``'s
  ``ms``);
* ``batched_ms``: 20 back-to-back calls between one pair of events, / 20,
  median of 5 (the host time of a call overlaps the launches before it;
  ``chip_smoke.py``'s ``ms_batched``);
* ``device_ms``: the kernel's own device time by ``torch.profiler``, mean
  of 7 calls;
* ``host_us``: host time of one wrapper call, mean of 200 calls with no
  synchronize between them;

beside ``err``, the largest difference from ``wkv_plain`` on the same
inputs (y and final state).  ``digests`` holds a SHA-256 of the bytes of y
and the final state at each of ``chip_smoke.py`` phase C's serving shapes
(prefill T of 5, 17, 37, 64, 128 and 2048, bf16 at 2048, decode at four
slots with a state), so two versions' serving outputs can be compared bit
for bit.  The timing helpers are those of
``tools/time_copy_convert.py`` and ``chip_smoke.py``, taken from the
checkout that holds this script.  Run it from a checkout's root on a
machine with a card::

    PYTHONPATH=src python3 tools/time_wkv.py --label change

and, to compare two versions on one card, with ``PYTHONPATH`` set to each
checkout's ``src`` in turns (parent, change, change, parent).  Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

from time_copy_convert import device_ms, events_ms, host_us

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import time_ms_batched  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="name of the version timed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_wkv: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv_chunked, wkv_plain

    _build.build_all(["wkv"])
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)
    H, hd, chunk = 32, 64, 64

    def inputs(B, T, state):
        r, k, v = (torch.randn((B, T, H, hd), generator=gen, device=dev) for _ in range(3))
        lw = -torch.exp(torch.randn((B, T, H, hd), generator=gen, device=dev) * 0.5 - 1.0)
        u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
        S0 = torch.randn((B, H, hd, hd), generator=gen, device=dev) if state else None
        return (r, k, v, lw, u), S0

    cases = {}
    for name, B, T, state in (("prefill (1, 2048, 32, 64) f32", 1, 2048, False),
                              ("decode (4, 1, 32, 64) f32 + state", 4, 1, True)):
        args_, S0 = inputs(B, T, state)

        def call(args_=args_, S0=S0):
            return wkv_chunked(*args_, chunk=chunk, S0=S0)

        y, S = call()
        want_y, want_S = wkv_plain(*args_, chunk=chunk, S0=S0)
        err = max((y - want_y).abs().max().item(), (S - want_S).abs().max().item())
        cases[name] = dict(events_ms=events_ms(torch, call, lambda: None),
                           batched_ms=time_ms_batched(torch, call),
                           device_ms=device_ms(torch, call, lambda: None),
                           host_us=host_us(torch, call), err=err)
    digests = {}
    for name, B, T, dtype, state in (
            *((f"prefill T={T}", 1, T, torch.float32, False) for T in (5, 17, 37, 64, 128, 2048)),
            ("prefill T=2048 bf16", 1, 2048, torch.bfloat16, False),
            ("decode (4, 1) + state", 4, 1, torch.float32, True)):
        args_, S0 = inputs(B, T, state)
        y, S = wkv_chunked(*(a.to(dtype) for a in args_), chunk=chunk, S0=S0)
        h = hashlib.sha256()
        for t in (y, S):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[name] = h.hexdigest()[:16]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"label": args.label, "card": smi[0] if smi else "not read",
                      "torch": torch.__version__, "cases": cases, "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
