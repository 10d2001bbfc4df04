"""Continuous-batching serve benchmark: tokens/sec over the transport layer
(PyTorch port of ``src/repro/serving/bench.py``).

Runs the :class:`~repro_torch.serving.engine.ServingEngine` end to end on
a ``(1, 8)`` virtual mesh of stacked ranks with the ring-attention KV
rotation routed through ``Message`` tables (:mod:`repro_torch.core.
transport`), one cell per (packer, coalesce) wire configuration, and emits
``BENCH_*lm_serve*.json`` records in the JAX package's schema: tokens/sec
next to the static wire accounting (message_bytes / wire_bytes /
collective_count from the same tables that drive delivery) and the
plan-cache amortization counters.

    PYTHONPATH=src python -m repro_torch.serving.bench --device cpu --out BENCH_torch_verify.json
    PYTHONPATH=src python -m repro_torch.serving.bench --full --prompt-len 1025,2041 \\
        --max-len 2048 --out BENCH_torch_lm_serve.json            # on the card
    PYTHONPATH=src python -m repro_torch.serving.bench --full --prompt-len 1025,2041 \\
        --max-len 2048 --check BENCH_torch_lm_serve.json

``--check`` is the CI guard: every deterministic field (wire bytes,
collective counts, plan inits/hits, token counts) must match the baseline
exactly; only the wall-clock fields are runner-speed-dependent and are
merely required to be positive.  An ``auto`` cell re-runs the best
exact-packer cell from the trace with ``selected_by`` provenance (the
autotuner's trace tier applied to the serve path).

The defaults are the JAX bench's reduced ``stablelm-1.6b`` (width 64, 2
layers, vocab 512, 6 requests of 9-16 tokens, 2 slots, 8 new tokens);
``--full`` serves the config at its own widths, ``--prompt-len`` and
``--max-len`` size the requests, and ``--device`` (default the card)
chooses where.  ``transport`` is the port's ``"loopback"`` (JAX:
``"ppermute"``), and every rank is stacked in the one process, so the CLI
runs in place where JAX re-executes itself with ``XLA_FLAGS`` for 8
virtual devices.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Sequence

SCHEMA_VERSION = 1
BENCH_NAME = "lm_serve"

#: deterministic record fields --check compares exactly (everything except
#: wall-clock)
STATIC_KEYS = (
    "bench", "schema_version", "strategy", "arch", "n_devices", "n_parts",
    "packer", "transport", "coalesce", "mapping", "seq_bucket",
    "message_bytes", "wire_bytes", "collective_count",
    "tokens_generated", "decode_steps", "prefills",
    "plan_cache_inits", "plan_cache_hits", "selected_by",
)
RECORD_KEYS = STATIC_KEYS + ("tokens_per_sec", "us_per_cycle")

#: the swept wire cells: exact baseline, coalesced exact, compressed wire
CELLS: tuple[tuple[str, bool], ...] = (
    ("slice", False), ("slice", True), ("bf16", True),
)

#: the ring of ranks the KV rotates around (the model axis of the mesh)
RING = 8
#: JAX's prompt lengths, ``[lo, hi)``: every one lands in the 16-bucket
PROMPT_LEN = (9, 17)


def ring_comm_stats(
    *,
    seq_bucket: int,
    ring: int,
    n_layers: int,
    n_kv_heads: int,
    head_dim: int,
    dtype_bytes: int,
    packer: str,
    coalesce: bool,
    n_parts: int,
    batch: int = 1,
) -> dict[str, int]:
    """Static per-prefill wire accounting from the SAME Message tables that
    drive delivery (``ring_size`` explicit — no live mesh needed).

    ``wire_bytes`` takes the packer's wire itemsize for float32 whatever
    ``dtype_bytes`` is, as the JAX function does (ROADMAP, standing
    constraints): for a bf16 KV the ``slice`` wire counts twice the bytes
    it carries."""
    import torch

    from repro_torch.core.ring import ring_kv_messages
    from repro_torch.core.transport import get_packer, scheduled_collective_count

    skv = seq_bucket // ring
    kv_shape = (2, batch, skv, n_kv_heads, head_dim)
    msgs = ring_kv_messages(kv_shape, "model", ring, n_parts=n_parts)
    hops = ring - 1  # rotations per ring pass
    per_hop = scheduled_collective_count([msgs], coalesce=coalesce)
    elems = sum(math.prod(m.shape) for m in msgs)
    wire_itemsize = get_packer(packer).wire_itemsize(torch.float32)
    return {
        "collective_count": per_hop * hops * n_layers,
        "message_bytes": elems * dtype_bytes * hops * n_layers,
        "wire_bytes": elems * wire_itemsize * hops * n_layers,
    }


def bench_config(arch: str = "stablelm-1.6b", *, full: bool = False, width: int = 64,
                 layers: int = 2, vocab: int = 512):
    """The served config: JAX's reduced dense model at ``width``/``layers``/
    ``vocab``, or with ``full`` the registered config at its own widths."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced().with_updates(
            d_model=width, n_layers=layers, vocab_size=vocab, d_ff=width * 3,
            n_heads=max(4, width // 32), n_kv_heads=max(4, width // 32),
            head_dim=32)
    assert cfg.family == "dense", "the serve bench cells are dense"
    return cfg


def bench_prompts(vocab_size: int, requests: int, prompt_len: tuple[int, int],
                  seed: int) -> list[list[int]]:
    """The request mix, drawn as JAX draws it (numpy ``default_rng(seed)``:
    a length in ``[lo, hi)``, then the tokens, request by request)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lo, hi = prompt_len
    return [
        rng.integers(0, vocab_size, size=int(rng.integers(lo, hi))).tolist()
        for _ in range(requests)
    ]


def serve_once(
    *,
    packer: str = "slice",
    coalesce: bool = True,
    n_parts: int = 1,
    arch: str = "stablelm-1.6b",
    width: int = 64,
    layers: int = 2,
    vocab: int = 512,
    requests: int = 6,
    slots: int = 2,
    max_new: int = 8,
    max_len: int = 128,
    seed: int = 0,
    selected_by: str = "",
    full: bool = False,
    prompt_len: tuple[int, int] = PROMPT_LEN,
    device: Any = "cuda",
) -> dict[str, Any]:
    """One serve cell: build the dense model (random weights from seed
    ``seed`` on ``device``), serve the request mix on the (1, 8) mesh with
    ring-attention prefill through the Message path, and return the BENCH
    record."""
    import torch

    from repro_torch.core.compat import torch_dtype
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.context import ParallelContext
    from repro_torch.serving.engine import ServingEngine, _next_pow2

    cfg = bench_config(arch, full=full, width=width, layers=layers, vocab=vocab)
    model = build_model(cfg, device)
    params = model.init(seed)
    mesh = make_mesh((1, RING), ("data", "model"), device=model.device)
    ctx = ParallelContext(mesh=mesh, seq_parallel=True, n_parts=n_parts,
                          comm_packer=packer, comm_coalesce=coalesce)

    # JAX's comment: all prompt lengths land in one ring-divisible bucket,
    # so the whole run inits ONE bucketed prefill plan + ONE decode plan
    prompts = bench_prompts(cfg.vocab_size, requests, prompt_len, seed)
    seq_bucket = _next_pow2(max(len(p) for p in prompts))

    engine = ServingEngine(model, params, max_slots=slots, max_len=max_len, ctx=ctx)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    uids = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    results = engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0

    st = engine.stats
    tokens = sum(len(v) for v in results.values())
    assert set(results) == set(uids)
    stats = ring_comm_stats(
        seq_bucket=seq_bucket, ring=RING, n_layers=cfg.n_layers,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        dtype_bytes=torch_dtype(cfg.dtype).itemsize,
        packer=packer, coalesce=coalesce, n_parts=n_parts)
    return {
        "bench": BENCH_NAME,
        "schema_version": SCHEMA_VERSION,
        "strategy": "ring-messages",
        "arch": cfg.name,
        "n_devices": RING,
        "n_parts": n_parts,
        "packer": packer,
        "transport": "loopback",
        "coalesce": coalesce,
        "mapping": "row-major",
        "seq_bucket": seq_bucket,
        "message_bytes": stats["message_bytes"],
        "wire_bytes": stats["wire_bytes"],
        "collective_count": stats["collective_count"],
        "tokens_generated": tokens,
        "decode_steps": st.decode_steps,
        "prefills": st.prefills,
        "plan_cache_inits": st.plan_inits,
        "plan_cache_hits": st.plan_hits,
        "selected_by": selected_by,
        "tokens_per_sec": tokens / dt if dt > 0 else 0.0,
        "us_per_cycle": dt / max(1, st.decode_steps) * 1e6,
    }


def run_cells(**kw: Any) -> list[dict[str, Any]]:
    return [serve_once(packer=p, coalesce=c, **kw) for p, c in CELLS]


def auto_cell(trace_path: str, **kw: Any) -> dict[str, Any] | None:
    """Re-run the trace's selected cell with ``selected_by="trace"``.

    If the trace already carries a trace-provenance record (a committed
    baseline does), REPLAY that cell — the guard must be deterministic, not
    re-decided from runner-speed-dependent tokens/sec.  Otherwise (initial
    baseline generation) pick the best EXACT-packer cell by tokens/sec;
    lossy packers are never auto-selected."""
    from repro_torch.stencil.sweep import read_bench_json

    if not os.path.exists(trace_path):
        return None
    records, _ = read_bench_json(trace_path)
    records = [r for r in records if r.get("bench") == BENCH_NAME]
    replay = [r for r in records if r.get("selected_by") == "trace"]
    if replay:
        best = replay[0]
    else:
        import torch

        from repro_torch.core.transport import get_packer

        exact = [
            r for r in records
            if not r.get("selected_by")
            and get_packer(r["packer"]).wire_tolerance(torch.float32) == (0.0, 0.0)
        ]
        if not exact:
            return None
        best = max(exact, key=lambda r: r.get("tokens_per_sec", 0.0))
    return serve_once(packer=best["packer"], coalesce=best["coalesce"],
                      n_parts=best["n_parts"], selected_by="trace", **kw)


def check_records(
    records: Sequence[dict], baseline_path: str
) -> list[str]:
    """CI guard: deterministic fields must match the baseline exactly;
    wall-clock fields only have to be positive.  Returns the list of
    failures (empty = pass)."""
    from repro_torch.stencil.sweep import read_bench_json

    base, _ = read_bench_json(baseline_path)
    base_by_cell = {
        (r["packer"], r["coalesce"], r.get("selected_by", "")): r
        for r in base if r.get("bench") == BENCH_NAME
    }
    failures = []
    for r in records:
        cell = (r["packer"], r["coalesce"], r.get("selected_by", ""))
        want = base_by_cell.get(cell)
        if want is None:
            failures.append(f"cell {cell}: not in baseline {baseline_path}")
            continue
        for key in STATIC_KEYS:
            if r.get(key) != want.get(key):
                failures.append(
                    f"cell {cell}: {key} = {r.get(key)!r}, baseline has "
                    f"{want.get(key)!r}")
        if not r.get("tokens_per_sec", 0) > 0:
            failures.append(f"cell {cell}: tokens_per_sec not positive")
    return failures


def card_line(device: Any) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (``"cpu"`` on the
    CPU)."""
    from repro_torch.core.compat import resolve_device

    if resolve_device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _parse_range(text: str) -> tuple[int, int]:
    lo, hi = (int(v) for v in text.split(","))
    return lo, hi


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="")
    ap.add_argument("--check", default="",
                    help="BENCH file of this bench to guard against")
    ap.add_argument("--trace", default="",
                    help="trace for the auto cell (defaults to --check)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="serve the config at its own widths (default: JAX's reduced cell)")
    ap.add_argument("--prompt-len", type=_parse_range, default=PROMPT_LEN,
                    help="prompt lengths LO,HI: drawn in [LO, HI) (default 9,17)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    kw = dict(requests=args.requests, slots=args.slots, max_new=args.max_new,
              full=args.full, prompt_len=args.prompt_len, max_len=args.max_len,
              device=args.device)
    records = run_cells(**kw)
    trace = args.trace or args.check
    if trace:
        tuned = auto_cell(trace, **kw)
        if tuned is not None:
            records.append(tuned)
    for r in records:
        sel = f" selected_by={r['selected_by']}" if r["selected_by"] else ""
        print(f"lm_serve packer={r['packer']} coalesce={r['coalesce']}"
              f" n_parts={r['n_parts']}: {r['tokens_per_sec']:.1f} tok/s,"
              f" {r['us_per_cycle']:.1f} us/cycle,"
              f" wire={r['wire_bytes']}B/prefill,"
              f" collectives={r['collective_count']},"
              f" plans {r['plan_cache_inits']} inits /"
              f" {r['plan_cache_hits']} hits{sel}", flush=True)
    if args.out:
        import torch

        payload = {
            "config": {
                "bench": BENCH_NAME, "schema_version": SCHEMA_VERSION,
                "requests": args.requests, "slots": args.slots,
                "max_new": args.max_new, "full": args.full,
                "prompt_len": list(args.prompt_len), "max_len": args.max_len,
                "device": args.device, "card": card_line(args.device),
                "torch": torch.__version__, "cuda": torch.version.cuda,
            },
            "records": records,
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        print(f"wrote {len(records)} records -> {args.out}")
    if args.check:
        failures = check_records(records, args.check)
        for msg in failures:
            print(f"CHECK FAIL: {msg}", file=sys.stderr)
        if failures:
            return 1
        print(f"check vs {args.check}: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
