"""Time the port's ``gather_pack`` and ``stencil27`` kernels at the heat3d
shapes, through their public wrappers only.

* ``gather_pack``: the coalesced layout ``chip_smoke.py`` phase 2b times
  (the one with the most segments, then the most elements, of the
  persistent, partitioned and fused heat3d schedules), gathered from the
  ``(8, 258, 514, 512)`` f32 stacked block into an f32 and a bf16 wire,
  beside ``torch.index_select`` of the same elements.
* ``stencil27``: the heat3d update's input, the x-wrapped ``(8, 258, 514,
  514)`` block in f32 and bf16, into a contiguous ``(8, 256, 512, 512)``
  output (the form every version of the wrapper takes).

Each case is timed as

* ``events_ms``: CUDA events around one call of the wrapper after an L2
  flush, median of 7 (the wrapper's host time is inside the window;
  ``chip_smoke.py``'s ``ms``);
* ``device_ms``: the kernels' own device time by ``torch.profiler``, mean
  of 7 calls, each after a flush (the flush's fill left out);
* ``host_us``: host time of one wrapper call, mean over back-to-back calls
  with no synchronize between them.

Since it calls only ``segment_table``, ``gather_pack`` and ``stencil27``, the
same script times any version of the package.  Run it from a checkout's
root on a machine with a card::

    PYTHONPATH=src python3 tools/time_gather_stencil.py --label change

and, to compare two versions on one card, with ``PYTHONPATH`` set to each
checkout's ``src`` in turns (parent, change, change, parent).  Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

from time_copy_convert import device_ms, events_ms, host_us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="name of the version timed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_gather_stencil: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels.pack import pack as pack_k
    from repro_torch.kernels.stencil27.stencil27 import stencil27
    from repro_torch.stencil import Domain, StrategyConfig, make_driver

    _build.build_all(["pack", "stencil27"])
    dev = torch.device("cuda")
    mesh = make_mesh((4, 2), ("pz", "py"), device=dev)
    dom = Domain(mesh, (1024, 1024, 512), ("pz", "py", None))
    local, ranks = dom.local_ghosted, mesh.size
    x = dom.random(0)
    xb = x.view(ranks, *local)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    cases = {}

    layouts = []
    for name, n_parts in (("persistent", 1), ("partitioned", 4), ("fused", 1)):
        drv = make_driver(StrategyConfig(name=name, n_parts=n_parts, packer="cuda"),
                          mesh, dom.halo_spec, ndim=3)
        layouts += list(drv.wire_layouts(x))
    lay = max(layouts, key=lambda la: (len(la.segments), la.total))
    table = pack_k.segment_table(lay.segments, local, dev)
    for wire in (torch.float32, torch.bfloat16):
        out = torch.empty((ranks, lay.total), dtype=wire, device=dev)

        def gather(out=out):
            return pack_k.gather_pack(xb, table, out)

        cases[f"gather_pack f32->{str(wire)[6:]}"] = dict(
            events_ms=events_ms(torch, gather, flush), device_ms=device_ms(torch, gather, flush),
            host_us=host_us(torch, gather))
    ids = torch.arange(math.prod(local), device=dev).view(local)
    flat_idx = torch.cat([ids[tuple(slice(b, b + n) for b, n in zip(s.src_start, s.shape))]
                          .reshape(-1) for s in lay.segments])
    xflat = xb.reshape(ranks, -1)

    def select():
        return torch.index_select(xflat, 1, flat_idx)

    cases["index_select f32"] = dict(events_ms=events_ms(torch, select, flush),
                                     device_ms=device_ms(torch, select, flush))
    del ids, flat_idx, xflat

    w = torch.randn((3, 3, 3), generator=torch.Generator(dev).manual_seed(5), device=dev)
    xp = torch.cat([xb[..., -1:], xb, xb[..., :1]], dim=-1)
    del x, xb
    for dtype in (torch.float32, torch.bfloat16):
        inp = xp if dtype == torch.float32 else xp.to(dtype)
        out = torch.empty((ranks, *(s - 2 for s in inp.shape[1:])), dtype=dtype, device=dev)

        def stencil(inp=inp, out=out):
            return stencil27(inp, w, out)

        cases[f"stencil27 {str(dtype)[6:]}"] = dict(
            events_ms=events_ms(torch, stencil, flush), device_ms=device_ms(torch, stencil, flush),
            host_us=host_us(torch, stencil, calls=20))
        del inp, out
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"label": args.label, "card": smi[0] if smi else "not read",
                      "torch": torch.__version__, "gather_layout": {
                          "segments": len(lay.segments), "total": lay.total},
                      "stencil_input": list(xp.shape), "cases": cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
