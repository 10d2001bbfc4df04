"""Run a recorded sweep's grid again, several times in one process, and
report how much each cell's ``us_per_cycle`` varies from run to run.

    PYTHONPATH=src python3 tools/sweep_spread.py BENCH_torch_stencil_sweep.json --runs 5
    python3 tools/sweep_spread.py --records chiprun_out/BENCH_torch_sweep_spread_*.json

The grid is the file's own config block (``SweepConfig`` fields), so the
committed card grid is re-run as it was recorded, on the card (``--device
cpu`` for a rehearsal; the committed sizes are large).  Each run's records
go to ``<out-dir>/BENCH_torch_sweep_spread_<i>.json``; ``--records``
summarizes such files again without running anything.  Prints one JSON
line: per run the device and clock; over the cells, quantiles of the
relative spread ``(max - min) / median``; per (ranks, message bytes,
mapping, packer, coalesce mode) the ``persistent``-over-``standard`` ratio
(``standard``'s ``us_per_cycle`` over ``persistent``'s) in every run, and
their summary; per (ranks, message bytes, mapping) the fastest cell of
every run (what a trace-driven ``auto`` would pick); and, over every run's
paired cells, how often ``cuda`` beat ``slice`` and coalesced beat
uncoalesced (per strategy and partition count too).
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import sys
import time


def cell_key(r: dict) -> tuple:
    return (r["n_devices"], r["message_bytes"], r["mapping"], r["strategy"], r["packer"],
            r["coalesce"], r["n_parts"])


def summarize_runs(runs: list[list[dict]]) -> dict:
    """The spread, ratio and win counts of several runs of one grid."""
    cells: dict[tuple, list[float]] = {}
    for records in runs:
        for r in records:
            cells.setdefault(cell_key(r), []).append(r["us_per_cycle"])
    spread = sorted((max(v) - min(v)) / statistics.median(v) for v in cells.values())
    q = statistics.quantiles(spread, n=4) if len(spread) > 1 else spread * 3
    ratios = {}
    for (n, mb, m, s, p, c, parts), us in cells.items():
        persistent = cells.get((n, mb, m, "persistent", p, c, parts))
        if s == "standard" and persistent:
            ratios[f"{n}/{mb}/{m}/{p}/c{int(c)}"] = [round(a / b, 3)
                                                     for a, b in zip(us, persistent)]
    every = [v for vs in ratios.values() for v in vs]
    wins: collections.Counter = collections.Counter()
    for records in runs:
        us = {cell_key(r): r["us_per_cycle"] for r in records}
        for (n, mb, m, s, p, c, parts), t in us.items():
            cuda = us.get((n, mb, m, s, "cuda", c, parts))
            if p == "slice" and cuda is not None:
                wins["cuda_faster" if cuda < t else "slice_faster"] += 1
            coalesced = us.get((n, mb, m, s, p, True, parts))
            if c is False and coalesced is not None:
                faster = "coalesced" if coalesced < t else "uncoalesced"
                wins[f"{faster}_faster"] += 1
                wins[f"{s}/p{parts}/{faster}_faster"] += 1
    # each slab's fastest cell in every run: what a trace-driven `auto` picks
    argmin = {}
    for (n, mb, m, s, p, c, parts), us in cells.items():
        for i, t in enumerate(us):
            best = argmin.setdefault(f"{n}/{mb}/{m}", [None] * len(us))
            if best[i] is None or t < best[i][1]:
                best[i] = (f"{s}/{p}/c{int(c)}/p{parts}", t)
    return {
        "cells": len(cells),
        "argmin": {k: [b[0] for b in v] for k, v in argmin.items()},
        "relative_spread": {"p25": q[0], "median": q[1], "p75": q[2], "max": spread[-1]},
        "persistent_over_standard": ratios,
        "persistent_over_standard_summary": {
            "pairs": len(every), "above_1": sum(v > 1 for v in every),
            "min": min(every, default=None), "median": statistics.median(every) if every else None,
            "max": max(every, default=None),
            "per_combination_median": [min(map(statistics.median, ratios.values()), default=None),
                                       max(map(statistics.median, ratios.values()), default=None)],
        },
        "wins": dict(sorted(wins.items())),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("bench", nargs="?", help="a sweep file with a config block")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default="chiprun_out")
    ap.add_argument("--records", nargs="+", metavar="BENCH_JSON",
                    help="summarize these runs' files instead of running the grid")
    args = ap.parse_args(argv)

    if args.records:
        runs = [json.loads(pathlib.Path(f).read_text())["records"] for f in args.records]
        print(json.dumps({"records": args.records, **summarize_runs(runs)}))
        return
    if not args.bench:
        ap.error("name a sweep file to re-run, or --records")

    from repro_torch.stencil import sweep

    _records, block = sweep.read_bench_json(args.bench)
    if not block or "sweep" not in block:
        sys.exit(f"{args.bench} has no config block to re-run")
    config = sweep.SweepConfig.from_json(json.dumps(block["sweep"]))
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(exist_ok=True)
    runs, clock = [], []
    for i in range(args.runs):
        t0 = time.perf_counter()
        records = sweep.run_sweep(config, device=args.device)
        clock.append({"run": i, "device": records[0]["device"],
                      "seconds": time.perf_counter() - t0})
        sweep.write_bench_json(records, str(out_dir / f"BENCH_torch_sweep_spread_{i}.json"),
                               config=sweep.config_block(config, device=args.device))
        runs.append(records)
    print(json.dumps({"bench": args.bench, "runs": clock, **summarize_runs(runs)}))


if __name__ == "__main__":
    main()
