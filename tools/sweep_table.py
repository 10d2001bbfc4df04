"""Summarize a port sweep file (``BENCH_torch_stencil_sweep.json``) as a
markdown table: ``us_per_cycle`` and ``speedup_vs_baseline`` per message
size x strategy (rows) x packer x coalesce mode (columns), each the best
record over the partition counts, the rank counts side by side in a cell.

    python3 tools/sweep_table.py BENCH_torch_stencil_sweep.json
    python3 tools/sweep_table.py chiprun_out/BENCH_torch_sweep_spread_*.json

Given several runs of one grid, a cell is the median of its runs'
``us_per_cycle``, its speedup the median baseline over that median.
Reads only the files (no torch, no card), so the table in ``PERF.md`` can
be re-made from the records.
"""

from __future__ import annotations

import json
import statistics
import sys


def best_cells(records: list[dict]) -> dict[tuple, dict]:
    """(n_devices, message_bytes, mapping, strategy, packer, coalesce) ->
    the record with the lowest ``us_per_cycle`` over the partition counts
    (static records only)."""
    out: dict[tuple, dict] = {}
    for r in records:
        if r.get("selected_by"):
            continue
        key = (r["n_devices"], r["message_bytes"], r["mapping"], r["strategy"], r["packer"],
               bool(r["coalesce"]))
        if key not in out or r["us_per_cycle"] < out[key]["us_per_cycle"]:
            out[key] = r
    return out


def median_records(runs: list[list[dict]]) -> list[dict]:
    """One record per cell of several runs of one grid: the median
    ``us_per_cycle``, and ``speedup_vs_baseline`` as the median of the runs'
    baselines (``us_per_cycle`` x speedup) over it."""
    cells: dict[tuple, list[dict]] = {}
    for records in runs:
        for r in records:
            key = (r["n_devices"], r["message_bytes"], r["mapping"], r["strategy"],
                   r["packer"], bool(r["coalesce"]), r["n_parts"], r.get("selected_by"))
            cells.setdefault(key, []).append(r)
    out = []
    for rs in cells.values():
        us = statistics.median(r["us_per_cycle"] for r in rs)
        base = statistics.median(r["us_per_cycle"] * r["speedup_vs_baseline"] for r in rs)
        out.append(dict(rs[0], us_per_cycle=us, speedup_vs_baseline=base / us))
    return out


def table(records: list[dict]) -> str:
    """Rows: (mapping, face bytes, strategy); columns: packer x coalesce;
    a cell: ``us (speedup pN)`` per rank count, joined by ``; `` (``pN`` =
    the best partition count where it is not 1)."""
    best = best_cells(records)
    counts = sorted({k[0] for k in best})
    meshes = {r["n_devices"]: tuple(r["mesh_shape"]) for r in best.values()}
    cols = sorted({(k[4], k[5]) for k in best}, key=lambda c: (c[0] != "slice", c[0], c[1]))
    mappings = list(dict.fromkeys(r["mapping"] for r in records))
    strategies = list(dict.fromkeys(r["strategy"] for r in records if not r.get("selected_by")))
    head = (["mapping"] if len(mappings) > 1 else []) + ["face bytes", "strategy"] + [
        f"{p}, {'coal.' if c else 'uncoal.'}" for p, c in cols]
    lines = ["ranks (mesh) in a cell: " + "; ".join(f"{n} {meshes[n]}" for n in counts),
             "", "| " + " | ".join(head) + " |", "|" + " --- |" * len(head)]
    for m in mappings:
        for mb in sorted({k[1] for k in best if k[2] == m}):
            for s in strategies:
                cells = []
                for p, c in cols:
                    vals = []
                    for n in counts:
                        r = best.get((n, mb, m, s, p, c))
                        if r is None:
                            vals.append("-")
                            continue
                        parts = f" p{r['n_parts']}" if r["n_parts"] != 1 else ""
                        vals.append(f"{r['us_per_cycle']:.0f} "
                                    f"({r['speedup_vs_baseline']:.2f}{parts})")
                    cells.append("; ".join(vals))
                row = ([m] if len(mappings) > 1 else []) + [str(mb), s] + cells
                lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    runs, config = [], None
    for path in argv or ["BENCH_torch_stencil_sweep.json"]:
        with open(path) as f:
            payload = json.load(f)
        runs.append(payload["records"] if isinstance(payload, dict) else payload)
        config = config or (payload.get("config") if isinstance(payload, dict) else None)
    if config:
        print(f"device {config.get('device')}, torch {config.get('torch')}, "
              f"cuda {config.get('cuda')}")
    if len(runs) > 1:
        print(f"median of {len(runs)} runs a cell")
    print(table(runs[0] if len(runs) == 1 else median_records(runs)))


if __name__ == "__main__":
    main()
