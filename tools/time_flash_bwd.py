"""Time the port's ``flash_attention_bwd`` beside SDPA's backward, through
the public wrapper only.

Cases, causal bf16 unless said: stablelm-1.6b's training path ``(1, 4096,
32 heads of 64)``, llama3-8b's GQA ``(1, 2048, 32 on 8 heads of 128)`` and
hubert-xlarge's encoder ``(4, 1000, 16 heads of 80)`` non-causal.  Inputs
normal from ``torch.Generator`` seed 1; the forward's output and row
log-sum-exp come from the port's ``flash_attention``.  Each is timed as

* ``events_ms``: CUDA events around one call, median of 7 (the wrapper's
  host time is inside the window; ``chip_smoke.py``'s ``ms``);
* ``device_ms``: the call's kernels' device time by ``torch.profiler``,
  mean of 7 calls, and ``device_by_kernel`` the same per kernel;
* ``host_us``: host time of one call, mean of 200 calls with no
  synchronize between them;

and the same for ``library``: autograd's backward of
``F.scaled_dot_product_attention`` on ``(B, H, S, D)`` copies (a graph
kept for repeated calls).  Run it from a checkout's root on a machine
with a card::

    PYTHONPATH=src python3 tools/time_flash_bwd.py --label change

and, to compare two versions on one card, with ``PYTHONPATH`` set to each
checkout's ``src`` in turns (parent, change, change, parent).  Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys

from time_copy_convert import device_ms, events_ms, host_us

CASES = (("stablelm-1.6b path (1, 4096, 32, 32, 64) causal", (1, 4096, 32, 32, 64), True),
         ("llama3-8b GQA (1, 2048, 32, 8, 128) causal", (1, 2048, 32, 8, 128), True),
         ("hubert-xlarge (4, 1000, 16, 16, 80) non-causal", (4, 1000, 16, 16, 80), False))


def device_by_kernel(torch, fn, reps: int = 7) -> dict:
    """Mean device ms a call of each kernel ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            out[e.key[:80]] += e.self_device_time_total / reps / 1e3
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="name of the version timed")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.costs import flash_bwd_cost
    from repro_torch.kernels.flash_attention.flash import flash_attention, flash_attention_bwd

    _build.build_all(["flash_attention"])
    dev = torch.device("cuda")
    cases = {}
    for name, (b, s, hq, hkv, d), causal in CASES:
        gen = torch.Generator(dev).manual_seed(1)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        dout = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
        out = flash_attention(q, k, v, causal=causal, lse=lse)
        qt, kt, vt = (t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=hkv != hq)
        dout_t = dout.transpose(1, 2)

        def kernel(q=q, k=k, v=v, out=out, dout=dout, lse=lse, causal=causal):
            return flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)

        def library(sdpa=sdpa, qt=qt, kt=kt, vt=vt, dout_t=dout_t):
            return torch.autograd.grad(sdpa, (qt, kt, vt), dout_t, retain_graph=True)

        flops = flash_bwd_cost(b, s, hq, s, hkv, d, causal=causal, itemsize=2)[0]
        row = {"flops": flops}
        for tag, fn in (("kernel", kernel), ("library", library)):
            row[tag] = dict(events_ms=events_ms(torch, fn, lambda: None),
                            device_ms=device_ms(torch, fn, lambda: None),
                            device_by_kernel=device_by_kernel(torch, fn),
                            host_us=host_us(torch, fn))
        row["kernel"]["tflops_device"] = flops / (row["kernel"]["device_ms"] / 1e3) / 1e12
        cases[name] = row
        del q, k, v, dout, lse, out, qt, kt, vt, sdpa
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"label": args.label, "card": smi[0] if smi else "not read",
                      "torch": torch.__version__, "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
