"""Where a sweep cell's run-to-run spread comes from: build one cell's
driver afresh several times, as the sweep does, and time its cycles, the
variants below taken in turns so that drift hits each alike.

    PYTHONPATH=src python3 tools/sweep_noise.py --builds 16
    PYTHONPATH=src python3 tools/sweep_noise.py --builds 2 --cycles 5 --device cpu

Cells: 4 ranks on a (2, 2) mesh, global interior 64^3 f32, packer
``slice``: ``standard`` uncoalesced and ``persistent`` coalesced.
Variants: ``plain`` (timed as ``run_cycles`` times), ``no_gc`` (the
garbage collector off for the timed cycles), ``pinned`` (the process held
to one CPU core), ``pinned_no_gc``.  Prints one JSON line: per cell and
variant the mean step time of each build (host clock, one barrier at the
end), their spread ``(max - min) / median``, and the quartiles of the
single steps' host times within a build (no barrier between steps).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import time

import torch

from repro_torch.core.mesh import make_mesh
from repro_torch.stencil import Domain, StrategyConfig, make_driver

VARIANTS = ("plain", "no_gc", "pinned", "pinned_no_gc")
CELLS = {"standard/uncoalesced": StrategyConfig(name="standard", coalesce=False),
         "persistent/coalesced": StrategyConfig(name="persistent", coalesce=True)}


def time_build(domain: Domain, config: StrategyConfig, x0: torch.Tensor, cycles: int,
               variant: str) -> tuple[float, list[float]]:
    """One fresh driver: init, 3 warm-up cycles, then ``cycles`` timed."""
    cores = os.sched_getaffinity(0)
    if variant.startswith("pinned"):
        os.sched_setaffinity(0, {max(cores)})
    drv = make_driver(config, domain.mesh, domain.halo_spec, ndim=3)
    try:
        x = x0.clone()
        drv.init(x)
        for _ in range(3):
            x = drv.step(x)
        x = drv.wait(x)
        steps = []
        if variant.endswith("no_gc"):
            gc.disable()
        t0 = time.perf_counter()
        for _ in range(cycles):
            t = time.perf_counter()
            x = drv.step(x)
            steps.append((time.perf_counter() - t) * 1e6)
        drv.wait(x)
        mean_us = (time.perf_counter() - t0) / cycles * 1e6
    finally:
        gc.enable()
        drv.free()
        os.sched_setaffinity(0, cores)
    return mean_us, steps


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--builds", type=int, default=16)
    ap.add_argument("--cycles", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    domain = Domain(make_mesh((2, 2), ("px", "py"), device=args.device), (64, 64, 64),
                    ("px", "py", None))
    x0 = domain.random(0)
    out: dict = {"device": str(domain.device), "cores": len(os.sched_getaffinity(0)),
                 "builds": args.builds, "cycles": args.cycles, "cells": {}}
    for name, config in CELLS.items():
        means: dict[str, list[float]] = {v: [] for v in VARIANTS}
        steps: dict[str, list[list[float]]] = {v: [] for v in VARIANTS}
        for _ in range(args.builds):
            for v in VARIANTS:
                m, s = time_build(domain, config, x0, args.cycles, v)
                means[v].append(round(m, 1))
                steps[v].append(s)
        out["cells"][name] = {
            v: {"mean_us": means[v],
                "spread": (max(means[v]) - min(means[v])) / statistics.median(means[v]),
                "step_us_quartiles": [[round(q, 1) for q in statistics.quantiles(s, n=4)]
                                      for s in steps[v]]}
            for v in VARIANTS}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
