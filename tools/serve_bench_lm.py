"""Phase J of ``chip_smoke.py``: the LM serve bench on the card and the
collective accounting of the paper's communication model, on one card.

* J1, the serve bench (``repro_torch.serving.bench``) at the full width of
  ``stablelm-1.6b`` (24 layers, d 2048, 32 heads of 64, vocab 100352,
  random bf16 weights from seed 0, about 3.3 GB): 6 requests of 1025-2040
  prompt tokens (every one buckets to 2048, so each of the 8 ranks of the
  ``(1, 8)`` ring holds 256 KV rows a hop), 2 slots, 8 new tokens,
  ``max_len`` 2048.  Through the bench's CLI, three times: ``--out`` (the
  three ``CELLS``), ``--out --trace`` on that file (adds the ``auto``
  cell, the best exact cell by tokens/s, ``selected_by="trace"``), then
  ``--check`` against it, which must report no failure and whose ``auto``
  cell must replay the trace cell.  Every serve is recorded
  (:func:`recorded_serves`): the tokens of all cells of all runs equal (the
  exact packers, and ``bf16`` on a bf16 KV, deliver the same bits); the
  tokens against a local engine (no ring, flash attention) on the same
  weights, equal or a near tie at the first difference
  (``ring_lm.near_ties``); the pack kernels' launches, counted from 0 at
  each serve: a ``bf16`` cell launches ``gather_pack`` and ``copy_convert``
  layers x 7 hops x rounds a prefill (``ring_lm.expected_pack_launches``),
  the ``slice`` cells none; ``gather_pack`` and each ``copy_convert``
  window held bitwise against their plain versions at the cell's KV hop
  (``ring_lm.kv_kernel_checks``); tokens/s, us a decode step (median,
  host clock) and prefill ms (median of the serve's 6) per cell; the
  local engine's decode step eager (``plan.fn``) and on its graph, in
  turns, with ``torch.profiler``'s breakdown of each.
* J2, the collective count (``repro_torch.core.comm_analysis``):
  ``count_collectives`` around one eager ring prefill of the full-width
  model at 2048 tokens equals each ``CELLS`` entry's ``collective_count``
  (and its wire bytes the KV's own bf16 bytes, ``message_bytes``); around
  one eager step at phase 4's heat3d layout (packer ``cuda``, coalesced,
  ``partitioned`` at 4 parts, the ``stencil27`` update) it equals the
  driver's ``scheduled_collectives`` for every strategy (the plan's eager
  ``plan.fn``; ``standard``'s own step); and ``roofline(..., hw=H100)`` of
  one 2048-token ring prefill, FLOPs and HBM bytes from the shapes, wire
  bytes from the count, beside the prefill's measured time, and the
  ``slice`` coalesced prefill's device breakdown (idle share, the
  exchange kernels' share of busy time).

``chip_smoke.py`` calls :func:`serve_bench_phase` after phase I; it is the
one entry point.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time

import ring_lm
from time_plan_graph import decode_row, slim

ARCH = "stablelm-1.6b"
#: J1's request mix: prompt lengths in [1025, 2041) all bucket to 2048, and
#: 2040 + 8 new tokens end at ``MAX_LEN`` exactly
PROMPT_LEN = (1025, 2041)
REQUESTS, SLOTS, NEW, MAX_LEN = 6, 2, 8, 2048
BUCKET = 2048
FULL_ARGS = ["--full", "--prompt-len", f"{PROMPT_LEN[0]},{PROMPT_LEN[1]}",
             "--max-len", str(MAX_LEN), "--requests", str(REQUESTS), "--slots", str(SLOTS),
             "--max-new", str(NEW), "--device", "cuda"]
#: phase 4's heat3d strategies (packer ``cuda``, coalesced)
HEAT_STRATEGIES = ("standard", "persistent", "partitioned", "fused", "overlap")
#: decode steps a timing window (eager and graph in turns), as phase B's
DECODE_STEPS = 20


@contextlib.contextmanager
def recorded_serves(torch):
    """Record every ``ServingEngine.run`` in the block: its cell (packer,
    coalesce, ``n_parts``), the tokens by request, the kernel launches from
    0 at the run's start, and the host ms of each prefill and each decode
    step (each ends in the engine's own synchronization: the sampled token
    read back)."""
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServingEngine

    runs: list[dict] = []
    current: dict = {}
    real = {n: getattr(ServingEngine, n) for n in ("run", "_prefill_slot", "_decode_once")}

    def run(self):
        _build.reset_launches()
        current.clear()
        current.update(packer=self.ctx.comm_packer, coalesce=self.ctx.comm_coalesce,
                       n_parts=self.ctx.n_parts, prefill_ms=[], decode_ms=[])
        done = real["run"](self)
        current.update(tokens=[done[u] for u in sorted(done)], launches=dict(_build.LAUNCHES))
        runs.append(dict(current))
        return done

    def timed(name, key):
        def method(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](self, *args)
            current[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return method

    ServingEngine.run = run
    ServingEngine._prefill_slot = timed("_prefill_slot", "prefill_ms")
    ServingEngine._decode_once = timed("_decode_once", "decode_ms")
    try:
        yield runs
    finally:
        for name, fn in real.items():
            setattr(ServingEngine, name, fn)


def prefill_flops_bytes(cfg, T: int) -> tuple[float, float]:
    """One prefill of ``T`` tokens from the shapes: FLOPs (2 a
    multiply-add: every layer's projections and MLP on each token, causal
    attention's two products over T^2/2 pairs, the LM head at the last
    position) and HBM bytes (the weights read once)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) + cfg.n_heads * hd * d
    mlp = (3 if cfg.act in ("silu", "geglu") else 2) * d * cfg.d_ff
    flops = (2 * cfg.n_layers * (attn + mlp) * T
             + 2 * 2 * cfg.n_layers * (T * T / 2) * cfg.n_heads * hd
             + 2 * cfg.vocab_size * d)
    return float(flops), float(cfg.param_count() * 2)


def serve_bench_phase(torch, dev, out_dir, dom, update, *, logits_at) -> dict:
    """J1 and J2 (see the module docstring) on ``dev``; ``dom`` and
    ``update`` are phase 4's heat3d domain and update; ``logits_at`` as
    ``ring_lm.near_ties`` takes it.  Raises ``ring_lm.PhaseFailure`` after
    printing everything when a check fails."""
    import numpy as np

    from repro_torch.core.comm_analysis import H100, count_collectives, roofline
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel.context import LOCAL
    from repro_torch.serving import bench
    from repro_torch.serving.engine import ServingEngine, _next_pow2
    from repro_torch.stencil import StrategyConfig, make_driver
    from repro_torch.stencil.sweep import read_bench_json

    fails: list[str] = []
    out: dict = {}
    path = str(out_dir / "BENCH_torch_lm_serve.json")

    # -- J1: the bench's CLI, three times, every serve recorded ---------------
    t0 = time.perf_counter()
    with recorded_serves(torch) as runs:
        rcs = [bench.main([*FULL_ARGS, "--out", path]),
               bench.main([*FULL_ARGS, "--out", path, "--trace", path]),
               bench.main([*FULL_ARGS, "--check", path])]
    out["bench_s"] = time.perf_counter() - t0
    records, config = read_bench_json(path)
    out.update(rcs=rcs, records=records, config=config)
    if rcs != [0, 0, 0]:
        fails.append(f"the bench's --out, --out --trace and --check runs returned {rcs}")
    trace = [r for r in records if r["selected_by"] == "trace"]
    n_cells = len(bench.CELLS)
    # the CLI run of each serve: the cells, then the cells and the auto cell twice
    run_of = [1] * n_cells + [2] * (n_cells + 1) + [3] * (n_cells + 1)
    if len(records) != n_cells + 1 or len(trace) != 1 or len(runs) != len(run_of):
        fails.append(f"{len(records)} records ({len(trace)} by trace), {len(runs)} serves: "
                     f"expected {n_cells} cells + the auto cell, {len(run_of)} serves")
    elif (runs[-1]["packer"], runs[-1]["coalesce"]) != (trace[0]["packer"],
                                                          trace[0]["coalesce"]):
        fails.append(f"the --check run's auto cell served {runs[-1]['packer']}/"
                     f"{runs[-1]['coalesce']}, the trace cell is {trace[0]}")

    cfg = bench.bench_config(ARCH, full=True)
    prompts = bench.bench_prompts(cfg.vocab_size, REQUESTS, PROMPT_LEN, 0)
    buckets = [min(_next_pow2(len(p)), MAX_LEN) for p in prompts]
    want_pack = ring_lm.expected_pack_launches(cfg.n_layers, buckets, 1)
    tokens = runs[0]["tokens"] if runs else []
    cells = []
    for i, r in enumerate(runs):
        pack = {k: r["launches"].get(k, 0) for k in want_pack}
        expected = want_pack if r["packer"] == "bf16" else {k: 0 for k in want_pack}
        cell = dict(run=run_of[i] if i < len(run_of) else None, packer=r["packer"],
                    coalesce=r["coalesce"], pack_launches=pack, expected=expected,
                    prefill_ms=statistics.median(r["prefill_ms"]),
                    decode_ms=statistics.median(r["decode_ms"]),
                    decode_ms_first=r["decode_ms"][0], launches=r["launches"])
        cells.append(cell)
        if pack != expected:
            fails.append(f"serve {i} ({r['packer']}, coalesce={r['coalesce']}): pack launches "
                         f"{pack}, expected {expected}")
        if r["tokens"] != tokens:
            fails.append(f"serve {i} ({r['packer']}, coalesce={r['coalesce']}): tokens differ "
                         f"from the first serve's")
    out["serves"] = cells
    by_cell = {(c["packer"], c["coalesce"]): c for c in cells[-(n_cells + 1):]}
    for r in records:
        c = by_cell.get((r["packer"], r["coalesce"]), {})
        print(f"J1 {ARCH} {r['packer']} coalesce={r['coalesce']}"
              f"{' (auto, by trace)' if r['selected_by'] else ''}: {r['tokens_per_sec']:.2f} "
              f"tok/s, {r['us_per_cycle']:.1f} us/cycle (wall / decode steps), decode "
              f"{c.get('decode_ms', float('nan')) * 1e3:.1f} us a step (median), prefill "
              f"{c.get('prefill_ms', float('nan')):.1f} ms (median of {REQUESTS}, bucket "
              f"{r['seq_bucket']}); collectives {r['collective_count']}, message "
              f"{r['message_bytes']} B, wire {r['wire_bytes']} B a prefill; plans "
              f"{r['plan_cache_inits']} inits / {r['plan_cache_hits']} hits", flush=True)
    keys = ("run", "packer", "coalesce", "pack_launches", "expected", "prefill_ms", "decode_ms")
    print(f"J1 serves of the 3 CLI runs: {json.dumps([{k: c[k] for k in keys} for c in cells])}",
          flush=True)

    ring_mesh = make_mesh((1, bench.RING), ("data", "model"), device=dev)
    checks = ring_lm.kv_kernel_checks(torch, ring_mesh, packers=("bf16",))
    out["kv_kernel_checks"] = checks
    print(f"J1 pack kernels at the bf16 cell's KV hop, bitwise against their plain versions: "
          f"{json.dumps(checks)}", flush=True)
    if len(checks) != 1:
        fails.append(f"{len(checks)} bf16 KV hop plans in the registry, one expected")
    for c in checks:
        if (c["gather_pack_equal"] != c["cells"] or c["copy_convert_windows_equal"]
                != c["windows"] or not c["hop_equal"] or c["kv_shape"]
                != [bench.RING, 2, 1, BUCKET // bench.RING, cfg.n_kv_heads,
                    cfg.resolved_head_dim]):
            fails.append(f"pack kernels at the KV hop {c}: not bitwise equal, or not the "
                         f"cell's hop")

    # the local engine on the same weights (seed 0 on the card)
    model = build_model(cfg, dev)
    params = model.init(0)
    engine = ServingEngine(model, params, max_slots=SLOTS, max_len=MAX_LEN, ctx=LOCAL)
    uids = [engine.submit(p, max_new_tokens=NEW) for p in prompts]
    done = engine.run()
    local = [done[u] for u in uids]
    timing = slim(decode_row(torch, engine, n=DECODE_STEPS, rounds=2))
    out["decode_timing"] = timing
    for side in ("eager", "graph"):
        t = timing[side]
        top = ", ".join(f"{k['name'][:48]} x{k['launches_per_cycle']:g} {k['us_per_cycle']:.0f}us"
                        for k in t["kernels"][:5])
        print(f"J1 local decode step at {SLOTS} slots, {side}: {t['us']:.1f} us (host, median "
              f"of windows of {DECODE_STEPS}), device busy {t['busy_us']:.1f} us, idle share "
              f"{t['idle_share']:.3f}, {t['device_activities']:g} device activities; {top}",
              flush=True)
    del engine
    equal, ties = ring_lm.near_ties(torch, logits_at, model, params, prompts, tokens, local,
                                    MAX_LEN, fails)
    out["local"] = dict(equal_requests=equal, near_ties=ties)
    print(f"J1 ring tokens against the local engine: {equal}/{len(prompts)} equal, near ties "
          f"{json.dumps(ties)}", flush=True)

    # -- J2: count_collectives around one ring prefill a cell ----------------
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, BUCKET)), device=dev)
    true_len = torch.full((1,), BUCKET, dtype=torch.int32, device=dev)
    flops, hbm = prefill_flops_bytes(cfg, BUCKET)
    j2 = []
    for packer, coalesce in bench.CELLS:
        ctx = ring_lm.ring_context(dev, seq_parallel=True, comm_packer=packer,
                                   comm_coalesce=coalesce)
        cache = model.init_cache(1, MAX_LEN)
        model.prefill(params, {"tokens": toks}, cache, ctx=ctx, true_len=true_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = count_collectives(model.prefill, params, {"tokens": toks}, cache, ctx=ctx,
                                  true_len=true_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        want = bench.ring_comm_stats(
            seq_bucket=BUCKET, ring=bench.RING, n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim, dtype_bytes=2,
            packer=packer, coalesce=coalesce, n_parts=1)
        terms = roofline(hlo_flops_per_device=flops / bench.RING,
                         hlo_bytes_per_device=hbm, wire_bytes_per_device=stats.wire_bytes,
                         model_flops_global=flops, n_chips=bench.RING, hw=H100)
        row = dict(packer=packer, coalesce=coalesce, by_op_counts=stats.by_op_counts,
                   wire_bytes=stats.wire_bytes, record=want, prefill_ms_counted=prefill_ms,
                   roofline=dict(compute_s=terms.compute_s, memory_s=terms.memory_s,
                                 collective_s=terms.collective_s,
                                 bottleneck=terms.bottleneck, step_time_s=terms.step_time_s,
                                 mfu_bound=terms.mfu_bound))
        j2.append(row)
        print(f"J2 ring prefill {BUCKET} {packer} coalesce={coalesce}: count "
              f"{stats.summary()} {json.dumps(stats.by_op_counts)}; the record's "
              f"collective_count {want['collective_count']}, message_bytes "
              f"{want['message_bytes']}, wire_bytes {want['wire_bytes']} (float32 itemsize, "
              f"JAX's accounting); roofline on H100 a rank of 8: {json.dumps(row['roofline'])} "
              f"against {prefill_ms:.1f} ms measured for the whole ring", flush=True)
        if stats.by_op_counts != {"collective-permute": want["collective_count"]}:
            fails.append(f"ring prefill {packer}/{coalesce}: counted {stats.by_op_counts}, "
                         f"the record has {want['collective_count']}")
        if stats.wire_bytes != want["message_bytes"]:
            fails.append(f"ring prefill {packer}/{coalesce}: counted wire {stats.wire_bytes} "
                         f"B, the bf16 KV is {want['message_bytes']} B")
    out["ring_counts"] = j2
    from repro_torch.core.profiling import device_breakdown

    ctx = ring_lm.ring_context(dev, seq_parallel=True, comm_packer="slice", comm_coalesce=True)
    cache = model.init_cache(1, MAX_LEN)
    trace = device_breakdown(lambda: model.prefill(params, {"tokens": toks}, cache, ctx=ctx,
                                                   true_len=true_len), n_cycles=1)
    share = ring_lm.exchange_share(trace)
    out["ring_prefill_trace"] = dict(share, kernels=trace["kernels"][:8],
                                     window_us=trace["window_us_per_cycle"])
    top = ", ".join(f"{k['name'][:48]} x{k['launches_per_cycle']:g} {k['us_per_cycle']:.0f}us"
                    for k in trace["kernels"][:5])
    print(f"J2 ring prefill {BUCKET} slice coalesced, traced: window "
          f"{trace['window_us_per_cycle']:.0f} us, device busy {share['busy_us']:.0f} us, idle "
          f"share {share['idle_share']:.3f}, exchange kernels {share['exchange_us']:.0f} us "
          f"({share['share']:.3f} of busy); {top}", flush=True)
    out["prefill_flops"], out["prefill_hbm_bytes"] = flops, hbm
    del model, params
    torch.cuda.empty_cache()

    # -- J2: one eager step a strategy at the heat3d layout -------------------
    heat = []
    x = dom.random(0)
    for name in HEAT_STRATEGIES:
        drv = make_driver(StrategyConfig(name=name, packer="cuda", coalesce=True,
                                         n_parts=4 if name == "partitioned" else 1),
                          dom.mesh, dom.halo_spec, ndim=3, update_fn=update)
        drv.init(x)
        step = drv.step if name == "standard" else drv.plan.fn
        stats = count_collectives(step, x)
        torch.cuda.synchronize()
        scheduled = drv.scheduled_collectives(x)
        heat.append(dict(strategy=name, by_op_counts=stats.by_op_counts,
                         wire_bytes=stats.wire_bytes, scheduled=scheduled))
        print(f"J2 heat3d {name}: counted {json.dumps(stats.by_op_counts)}, wire "
              f"{stats.wire_bytes:.0f} B a rank; scheduled_collectives {scheduled}", flush=True)
        if stats.by_op_counts != {"collective-permute": scheduled}:
            fails.append(f"heat3d {name}: counted {stats.by_op_counts}, scheduled {scheduled}")
        drv.free()
        del drv, step
        torch.cuda.empty_cache()
    out["heat3d_counts"] = heat
    del x
    torch.cuda.empty_cache()

    out["launches"] = {}
    for r in runs:
        for k, v in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
    if fails:
        raise ring_lm.PhaseFailure("; ".join(fails))
    return out
