"""Time persistent plans eager (``CommPlan.fn``) against their CUDA graph
(``CommPlan.start``), in turns, on one card.

* ``--sweep``: §VI sweep cells, exchange only, on a ``(4, 2)`` mesh over
  the first two axes: global interiors 64^3, 256^3 and (1024, 1024, 512)
  f32, halo 1, strategies ``persistent``, ``partitioned`` (p1), ``fused``
  and ``overlap``, packers ``slice`` and ``cuda``, coalesced (the card
  grid of ``chip_smoke.py`` phase E), beside ``standard`` (eager, no plan);
* ``--heat3d``: the heat3d cycle (exchange + ``stencil27`` update) at
  (1024, 1024, 512) on the ``(4, 2)`` mesh, packer ``cuda``, coalesced,
  the four plan strategies (``partitioned`` at p4);
* ``--decode MODEL``: one decode step of ``rwkv6-1.6b`` or ``llama3-8b`` at
  full size (random bf16 weights from seed 0) at 4 slots, through the
  serving engine's decode plan after 4 prompts filled the slots.

Each item is timed by host clock (``us``: a window of ``n`` calls ending in
a device synchronize, divided by ``n``; windows in turns eager, graph,
graph, eager, ``--rounds`` times; median, and the spread ``(max - min) /
median`` of each side's windows) and by ``torch.profiler`` over 3 calls
(device busy and window per call, idle share, device activities per
call).  The profiler's window carries its own cost a launch, which swamps
a cycle of tens of microseconds, so ``idle_share_host`` also gives
``1 - busy / us``: the busy time against the unprofiled host clock.  A
stencil plan's row also holds the memory its init left allocated
(``plan_mb``: static input, tables, wire buffers) and reserved
(``plan_reserved_mb``: that and the graph pool), the allocation peak
during init, and whether ``free()`` returned all of both.  Run from a checkout's root on a machine with a card::

    PYTHONPATH=src python3 tools/time_plan_graph.py --sweep --heat3d --decode rwkv6-1.6b

Prints one JSON line per item and, with ``--out``, writes them all to a
JSON file.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from typing import Any, Callable

SWEEP_SIZES = ((64, 64, 64), (256, 256, 256), (1024, 1024, 512))
SWEEP_STRATEGIES = ("persistent", "partitioned", "fused", "overlap")
HEAT3D_STRATEGIES = ("persistent", "partitioned", "fused", "overlap")


def windows(steps: dict[str, Callable[[], Any]], *, n: int, rounds: int = 2) -> dict[str, list]:
    """Host microseconds a call of each step, one window of ``n`` calls
    ending in a synchronize at a time, in turns (a, b, b, a) ``rounds``
    times after one warm-up call of each."""
    import torch

    for step in steps.values():
        step()
    torch.cuda.synchronize()
    labels = list(steps)
    order = [*labels, *reversed(labels)] * rounds
    out: dict[str, list] = {label: [] for label in labels}
    for label in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            steps[label]()
        torch.cuda.synchronize()
        out[label].append((time.perf_counter() - t0) / n * 1e6)
    return out


def eager_vs_graph(eager: Callable[[], Any], graph: Callable[[], Any], *, n: int,
                   rounds: int = 2, trace_calls: int = 3) -> dict:
    """Host time a call (median of the windows and their spread) and the
    ``torch.profiler`` breakdown (``breakdown``, as ``repro_torch.core.
    profiling.device_breakdown`` returns it), for the eager and the graph
    step."""
    from repro_torch.core.profiling import device_breakdown

    host = windows({"eager": eager, "graph": graph}, n=n, rounds=rounds)
    out = {}
    for label, step in (("eager", eager), ("graph", graph)):
        b = device_breakdown(step, n_cycles=trace_calls)
        med = statistics.median(host[label])
        out[label] = dict(
            us=med, spread=(max(host[label]) - min(host[label])) / med,
            windows_us=host[label], busy_us=b["busy_us_per_cycle"],
            window_us=b["window_us_per_cycle"], idle_share=b["idle_share"],
            idle_share_host=max(0.0, 1.0 - b["busy_us_per_cycle"] / med),
            device_activities=sum(k["launches_per_cycle"] for k in b["kernels"]),
            breakdown=b,
        )
    out["graph_over_eager"] = out["eager"]["us"] / out["graph"]["us"]
    return out


def slim(row: dict) -> dict:
    """``row`` with each side's breakdown cut to its six longest kernels."""
    for side in ("eager", "graph"):
        b = row.get(side, {}).pop("breakdown", None)
        if b is not None:
            row[side]["kernels"] = b["kernels"][:6]
    return row


def eager_decode_engine():
    """The serving engine with its decode plan built without example
    arguments, so eager on the card: the comparison run only."""
    from repro_torch.serving.engine import ServingEngine

    class EagerDecodeEngine(ServingEngine):
        def _plan(self, fn, args, *, example_args=None):
            return super()._plan(fn, args)

    return EagerDecodeEngine


def driver_steps(drv, x) -> tuple[Callable, Callable]:
    """Eager and graph steps of an initialized plan driver on one shared
    block (each feeds its output to the next call, as a driver does)."""
    state = [x]
    plan = drv.plan

    def eager():
        state[0] = plan.fn(state[0])

    def graph():
        state[0] = plan.start(state[0])

    return eager, graph


def _stencil_cells(torch, dev, args) -> list[dict]:
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels.stencil27.ref import jacobi_weights
    from repro_torch.stencil import Domain, StrategyConfig, make_driver
    from repro_torch.stencil.heat3d import DOMAIN_AXES, MESH_AXES, heat3d_update

    rows = []
    jobs = []
    if args.sweep:
        for size in SWEEP_SIZES:
            for packer in ("slice", "cuda"):
                jobs += [("sweep", size, name, packer, 1, None) for name in
                         ("standard", *SWEEP_STRATEGIES)]
    if args.heat3d:
        jobs += [("heat3d", (1024, 1024, 512), name, "cuda", 4 if name == "partitioned" else 1,
                  "stencil27") for name in HEAT3D_STRATEGIES]
    dom = None
    for kind, size, name, packer, parts, update in jobs:
        if dom is None or dom.global_interior != size or dom.mesh.axis_names != (
                MESH_AXES if kind == "heat3d" else ("px", "py")):
            dom = (Domain(make_mesh((4, 2), MESH_AXES, device=dev), size, DOMAIN_AXES)
                   if kind == "heat3d" else
                   Domain(make_mesh((4, 2), ("px", "py"), device=dev), size, ("px", "py", None)))
            x0 = dom.random(0)
        upd = heat3d_update(jacobi_weights().numpy(), dev) if update else None
        drv = make_driver(StrategyConfig(name=name, packer=packer, coalesce=True, n_parts=parts),
                          dom.mesh, dom.halo_spec, ndim=3, update_fn=upd)
        n = args.cycles if kind == "sweep" else args.heat3d_cycles
        x = x0.clone()
        row = dict(item=kind, global_interior=list(size), mesh_shape=[4, 2], strategy=name,
                   packer=packer, coalesce=True, n_parts=parts, cycles=n)
        if name == "standard":  # no plan: eager only, the baseline
            host = windows({"eager": lambda: drv.step(x)}, n=n, rounds=args.rounds)["eager"]
            row.update(eager=dict(us=statistics.median(host), windows_us=host))
        else:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated(dev)
            reserved = torch.cuda.memory_reserved(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            drv.init(x)
            row["init_us"] = (time.perf_counter() - t0) * 1e6
            row["plan_mb"] = (torch.cuda.memory_allocated(dev) - before) / 2**20
            row["plan_reserved_mb"] = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
            row["init_peak_mb"] = (torch.cuda.max_memory_allocated(dev) - before) / 2**20
            eager, graph = driver_steps(drv, x)
            row.update(slim(eager_vs_graph(eager, graph, n=n, rounds=args.rounds)))
            del eager, graph
        drv.free()
        if name != "standard":
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            row["free_returns_memory"] = (torch.cuda.memory_allocated(dev) == before
                                          and torch.cuda.memory_reserved(dev) <= reserved)
        del x
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def decode_row(torch, engine, *, n: int, rounds: int) -> dict:
    """Eager against graph for the engine's decode plan on its own cache."""
    plan = next(p for p in engine.plans._plans.values() if p.captured)
    token = torch.zeros((engine.max_slots, 1), dtype=torch.long, device=engine.device)
    cache = engine._cache

    def eager():
        plan.fn(token, cache)

    def graph():
        plan.start(token, cache)

    row = dict(init_us=plan.init_seconds * 1e6)
    row.update(eager_vs_graph(eager, graph, n=n, rounds=rounds))
    return row


def _decode(torch, dev, name: str, args) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(name)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    engine = ServingEngine(model, params, max_slots=4, max_len=2048)
    rng = np.random.default_rng(0)
    for n in (5, 12, 64, 128):
        engine.submit(rng.integers(0, cfg.vocab_size, size=n).tolist(), max_new_tokens=1000)
    engine._fill_slots({})
    engine._decode_once({})  # the decode plan's init: warm-up and capture
    row = dict(item="decode", model=name, slots=4)
    row.update(slim(decode_row(torch, engine, n=args.decode_steps, rounds=args.rounds)))
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true", help="the sweep cells")
    ap.add_argument("--heat3d", action="store_true", help="the heat3d cycle")
    ap.add_argument("--decode", action="append", default=[], choices=("rwkv6-1.6b", "llama3-8b"),
                    help="a decode step of this model (repeatable)")
    ap.add_argument("--cycles", type=int, default=200, help="calls a window, sweep cells")
    ap.add_argument("--heat3d-cycles", type=int, default=20, help="calls a window, heat3d")
    ap.add_argument("--decode-steps", type=int, default=20, help="calls a window, decode")
    ap.add_argument("--rounds", type=int, default=3, help="(eager, graph, graph, eager) rounds")
    ap.add_argument("--out", help="write every row to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_plan_graph: no CUDA device", file=sys.stderr)
        return 2
    import subprocess

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    rows = _stencil_cells(torch, dev, args)
    for name in args.decode:
        rows.append(_decode(torch, dev, name, args))
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "torch": torch.__version__, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
