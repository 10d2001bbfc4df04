#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU: the halo
exchange (heat3d) and llama3-8b serving.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``).  It needs
one CUDA card; without one, or outside a checkout, it exits non-zero and
prints no result.  Every phase that fails ends the run with a non-zero exit.

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: the heat3d layout, a (4, 2) mesh over
   (pz, py) with x whole and a global interior of (1024, 1024, 512) f32, so
   each rank's ghosted block is (258, 514, 512).  Print each kernel's time
   (CUDA events, median), its plain version's time, its bound (bytes over
   3.35 TB/s) and one PyTorch call computing the same function.
3. Exchange matrix at full size: 5 strategies x 4 packers x coalesce on/off
   against the port's ``reference_exchange`` on the card (bitwise for the
   exact packers, within ``wire_tolerance`` for the lossy ones).
4. Heat3d through ``comb_measure`` (the main path): all five strategies,
   packer ``cuda``, coalesced, the ``stencil27`` kernel update.  Launch
   counts are zeroed just before and read just after; each kernel must have
   launched.  The cycles are checked against the same cycles run through
   packer ``slice`` with ``stencil27_ref`` on the card, and ``torch.profiler``
   shows where each strategy's cycle goes (device time by kernel, idle share).
A. ``flash_attention`` against its plain version on the card at the shapes
   the serving path gives it (llama3-8b prefill, causal, bf16, S in
   {8, 128, 1000, 2048}; an MHA head_dim-64 case causal and not; an f32
   case; a strided q), timed at S = 2048 beside the plain version and
   ``F.scaled_dot_product_attention`` (the library yardstick, never on the
   path).
B. Serving llama3-8b at full width and depth (random bf16 weights from
   ``torch.Generator`` seed 0, about 16.1 GB on the card) through
   ``ServingEngine(max_slots=4, max_len=2048)``: 8 requests of 5-2000
   prompt tokens, 16 new tokens each.  Launch counts are zeroed just
   before and read just after: ``flash_attention`` must launch 32 times
   per prefill, and the engine must init one plan per prefill bucket plus
   one decode plan.  The tokens are held against the same engine with the
   plain attention injected: equal, or, where they first differ, a near
   tie in the plain model's logits.  Prints prefill ms per bucket, decode
   ms per step, tokens per second, and the device idle share of a prefill
   and of a decode step (``torch.profiler``).
5. Print the ``kernels`` JSON line, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.  The full record also goes to
   ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: H100 SXM data-sheet HBM3 rate, the bytes bound of every kernel here
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM data-sheet dense bf16 tensor-core rate, the operations bound
BF16_FLOP_PER_S = 989e12
MESH = ((4, 2), ("pz", "py"))
GLOBAL_INTERIOR = (1024, 1024, 512)
#: stated tolerances.  Pack/unpack are elementwise converts: exact.  The
#: stencil rounds each product and sum like its plain version (no FMA), but
#: the check allows FMA-level differences: f32 rtol=1e-5, atol=1e-5; bf16
#: output one bf16 ulp (rtol=2^-7).
STENCIL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-6)}
HEAT_CYCLES, HEAT_REPEATS, VERIFY_CYCLES = 20, 3, 3
#: flash attention against its plain version, as tests/kernels/test_flash.py:
#: bf16 output rtol=atol=2e-2, f32 rtol=atol=2e-5
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
SERVE_LENGTHS = (5, 12, 100, 200, 500, 900, 1500, 2000)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 2048, 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def short_kernel_name(name: str) -> str:
    """``void (anonymous namespace)::stencil27_kernel<float>(...)`` -> ``stencil27_kernel``."""
    if "direct_copy" in name:
        return "direct_copy"
    n = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return n.split("(")[0].split("<")[0].split("::")[-1].strip() or name[:40]


def time_ms(torch, fn, *, reps: int = 7, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events);
    ``flush`` runs before each launch, outside the events (cold L2)."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(torch, fn, *, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` ending in a device synchronize,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def plain_logits_at(torch, model, params, prompt, prefix, max_len):
    """The logits that follow ``prompt + prefix`` in ``model``: a bucketed
    prefill of the prompt, then one decode step per prefix token (batch 1)."""
    from repro_torch.serving.engine import _next_pow2

    dev = model.device
    bucket = min(_next_pow2(len(prompt)), max_len)
    toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    toks[0, :len(prompt)] = torch.as_tensor(prompt, device=dev)
    true_len = torch.full((1,), len(prompt), dtype=torch.int32, device=dev)
    logits, cache = model.prefill(params, {"tokens": toks}, model.init_cache(1, max_len),
                                  true_len=true_len)
    for t in prefix:
        logits, cache = model.decode_step(params, torch.tensor([[t]], device=dev), cache)
    return logits[0, -1].float()


def serve_llama(torch, dev, kernels: dict) -> dict:
    """Phase B: llama3-8b through the serving engine, flash kernel on the
    path, held against the same engine with the plain attention."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("llama3-8b")
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [params["embed"], params["lm_head"], *params["norm_f"].values()]
    leaves += [t for lp in params["layers"] for g in lp.values() for t in g.values()]
    param_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    print(f"llama3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, {param_gb:.3f} GB of "
          f"{params['embed'].dtype} parameters made on the card in {init_s:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_LENGTHS]
    # warm-up outside the counted run (cuBLAS handles, the kernel library)
    model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long, device=dev)},
                  model.init_cache(1, 8))
    torch.cuda.synchronize()

    def serve(m):
        engine = ServingEngine(m, params, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
        uids = [engine.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
        t0 = time.perf_counter()
        out = engine.run()
        torch.cuda.synchronize()
        return engine, [out[u] for u in uids], time.perf_counter() - t0

    _build.reset_launches()
    engine, tokens, serve_s = serve(model)
    launches = dict(_build.LAUNCHES)
    st = engine.stats
    buckets = sorted({engine._prefill_bucket(len(p)) for p in prompts})
    n_tokens = sum(len(t) for t in tokens)
    print(f"serve llama3-8b: {st.prefills} prefills (buckets {buckets}), {st.decode_steps} decode "
          f"steps, {n_tokens} tokens in {serve_s:.3f} s = {n_tokens / serve_s:.1f} tok/s; plans "
          f"{st.plan_inits} inits / {st.plan_hits} hits; launches {json.dumps(launches)}",
          flush=True)
    if st.prefills != len(prompts) or any(len(t) != SERVE_NEW for t in tokens):
        fail(f"served {st.prefills} prefills, token counts {[len(t) for t in tokens]}")
    if launches.get("flash_attention", 0) != cfg.n_layers * st.prefills:
        fail(f"flash_attention launched {launches.get('flash_attention', 0)} times for "
             f"{st.prefills} prefills of {cfg.n_layers} layers")
    if st.plan_inits != len(buckets) + 1:
        fail(f"{st.plan_inits} plan inits for {len(buckets)} prefill buckets + 1 decode plan")
    kernels["flash_attention"]["launches"] = launches["flash_attention"]

    plain_model = build_model(cfg, dev, attention=attention_plain)
    plain_engine, plain_tokens, plain_s = serve(plain_model)
    if _build.LAUNCHES["flash_attention"] != launches["flash_attention"]:
        fail("the plain-attention run launched the flash kernel")
    equal, ties = 0, []
    for prompt, got, want in zip(prompts, tokens, plain_tokens):
        if got == want:
            equal += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        logits = plain_logits_at(torch, plain_model, params, prompt, got[:i], SERVE_MAX_LEN)
        la, lb = logits[got[i]].item(), logits[want[i]].item()
        gap, tol = abs(la - lb), FLASH_TOL["bfloat16"] * (1 + max(abs(la), abs(lb)))
        ties.append(dict(prompt_len=len(prompt), step=i, kernel_token=got[i], plain_token=want[i],
                         logit_gap=gap, tol=tol))
        if gap > tol:
            fail(f"prompt of {len(prompt)}: tokens differ at step {i} ({got[i]} vs {want[i]}) "
                 f"and the plain logits are {gap} apart (tol {tol}): not a near tie")
    print(f"tokens against the plain-attention engine ({plain_s:.3f} s): {equal}/{len(prompts)} "
          f"requests equal; near ties at the first difference: {json.dumps(ties)}", flush=True)

    prefill_ms, prefill_logit_err = {}, {}
    for bucket in buckets:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, bucket)), device=dev)
        cache1 = model.init_cache(1, SERVE_MAX_LEN)
        true_len = torch.full((1,), max(1, bucket - 3), dtype=torch.int32, device=dev)
        prefill_ms[bucket] = host_ms(torch, lambda: model.prefill(
            params, {"tokens": toks}, cache1, true_len=true_len))
        # the same prefill with the plain attention: how far 32 layers carry
        # the kernel's bf16 rounding differences into the logits
        got = model.prefill(params, {"tokens": toks}, cache1, true_len=true_len)[0].float()
        want = plain_model.prefill(params, {"tokens": toks}, cache1, true_len=true_len)[0].float()
        if not torch.isfinite(got).all():
            fail(f"prefill at bucket {bucket}: non-finite logits")
        prefill_logit_err[bucket] = (got - want).abs().max().item()
    print(f"prefill ms by bucket {json.dumps(prefill_ms)}; max |logit kernel - plain| "
          f"{json.dumps(prefill_logit_err)}", flush=True)
    cache = engine._cache
    step_tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=dev)
    decode_ms = host_ms(torch, lambda: model.decode_step(params, step_tok, cache), reps=7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, SERVE_MAX_LEN)), device=dev)
    prefill_trace = device_breakdown(lambda: model.prefill(
        params, {"tokens": toks}, cache1, true_len=true_len), n_cycles=1)
    decode_trace = device_breakdown(lambda: model.decode_step(params, step_tok, cache),
                                    n_cycles=3)
    # host cost of one eager op on the card (a small in-place add)
    scratch = torch.zeros(1024, device=dev)
    op_us = host_ms(torch, lambda: [scratch.add_(1.0) for _ in range(500)]) / 500 * 1e3
    decode_launches = sum(k["launches_per_cycle"] for k in decode_trace["kernels"])
    print(f"decode step: {decode_ms:.2f} ms, {decode_launches:g} device activities per step; "
          f"one eager op costs {op_us:.1f} us of host time", flush=True)
    for label, b in (("prefill 2048", prefill_trace), ("decode step", decode_trace)):
        top = ", ".join(f"{short_kernel_name(k['name'])} x{k['launches_per_cycle']:g} "
                        f"{k['us_per_cycle']:.0f}us" for k in b["kernels"][:5])
        print(f"{label} breakdown: window {b['window_us_per_cycle']:.0f} us, device busy "
              f"{b['busy_us_per_cycle']:.0f} us, idle share {b['idle_share']:.3f}; {top}",
              flush=True)
    out = dict(
        model="llama3-8b", layers=cfg.n_layers, param_gb=param_gb, init_s=init_s,
        slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prompt_lengths=list(SERVE_LENGTHS),
        buckets=buckets, prefills=st.prefills, decode_steps=st.decode_steps,
        plan_inits=st.plan_inits, plan_hits=st.plan_hits, launches=launches,
        tokens=n_tokens, serve_s=serve_s, tokens_per_s=n_tokens / serve_s,
        plain_serve_s=plain_s, equal_requests=equal, near_ties=ties,
        prefill_ms=prefill_ms, prefill_logit_err=prefill_logit_err, decode_ms=decode_ms,
        decode_device_activities=decode_launches, host_us_per_op=op_us,
        prefill_idle_share=prefill_trace["idle_share"], decode_idle_share=decode_trace["idle_share"],
        prefill_trace=prefill_trace, decode_trace=decode_trace,
    )
    print("serving:", json.dumps({k: v for k, v in out.items() if not k.endswith("_trace")}),
          flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.transport import available_packers, get_packer
    from repro_torch.kernels import _build
    from repro_torch.kernels.pack import pack as pack_k
    from repro_torch.kernels.pack.ref import gather_pack_ref, pack_2d_ref, unpack_2d_ref
    from repro_torch.kernels.stencil27.ref import jacobi_weights, stencil27_ref
    from repro_torch.kernels.stencil27.stencil27 import stencil27
    from repro_torch.stencil import (
        Domain,
        StrategyConfig,
        available_strategies,
        comb_measure,
        make_driver,
        reference_exchange,
    )
    from repro_torch.stencil.comb import device_breakdown
    from repro_torch.stencil.heat3d import DOMAIN_AXES, heat3d_update

    record: dict = {}
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    smi = nvidia_smi_line()
    print(f"build: {sorted(libs)} in {build_s:.1f} s; card: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    record.update(build_s=build_s, card=smi, torch=torch.__version__, cuda=torch.version.cuda)

    mesh = make_mesh(*MESH, device=dev)
    dom = Domain(mesh, GLOBAL_INTERIOR, DOMAIN_AXES)
    ranks, local = mesh.size, dom.local_ghosted
    print(f"domain {GLOBAL_INTERIOR} on mesh {mesh.shape}: block {local} per rank, "
          f"faces {dom.face_bytes()} bytes", flush=True)
    x = dom.random(0)
    xb = x.view(ranks, *local)
    l2_flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    flush = l2_flush.zero_
    kernels: dict[str, dict] = {}

    def bound_ms(nbytes: int) -> float:
        return nbytes / HBM_BYTES_PER_S * 1e3

    # -- 2a. copy_convert (pack and unpack of strided face windows) --------
    worst = 0.0
    faces = {"pz": (slice(1, 2), slice(None)), "py": (slice(None), slice(1, 2))}
    for fname, (zs, ys) in faces.items():
        win = xb[:, zs, ys, :]
        for wire, scale in ((torch.float32, 1.0), (torch.bfloat16, 1.0), (torch.bfloat16, 8.0)):
            buf = torch.empty(win.shape, dtype=wire, device=dev)
            pack_k.copy_convert(win, buf, scale=scale)
            want = pack_2d_ref(win, out_dtype=wire, scale=scale)
            back = torch.zeros_like(xb)
            ghost = back[:, zs, ys, :]
            pack_k.copy_convert(buf, ghost, scale=1.0 / scale if scale != 1.0 else 1.0)
            want_back = unpack_2d_ref(want, out_dtype=torch.float32, scale=scale)
            torch.cuda.synchronize()
            err = max((buf.float() - want.float()).abs().max().item(),
                      (ghost - want_back).abs().max().item())
            if not (torch.equal(buf, want) and torch.equal(ghost, want_back)):
                fail(f"copy_convert {fname} {wire} scale={scale}: max err {err}")
            worst = max(worst, err)
            print(f"copy_convert {fname} face {tuple(win.shape)} f32->{str(wire)[6:]} "
                  f"scale={scale}: exact", flush=True)
            del back
    # timed case: the pz face f32 pack, as the main path packs it
    win = xb[:, 1:2, :, :]
    buf = torch.empty(win.shape, dtype=torch.float32, device=dev)
    nbytes = 2 * win.numel() * 4
    kernels["copy_convert"] = dict(
        name="copy_convert", route="cuda", source="src/repro_torch/kernels/csrc/pack.cu",
        replaces="src/repro/kernels/pack/pack.py:60", max_abs_err=worst,
        ms=time_ms(torch, lambda: pack_k.copy_convert(win, buf), flush=flush),
        plain_ms=time_ms(torch, lambda: buf.copy_(pack_2d_ref(win, out_dtype=torch.float32)), flush=flush),
        bound_ms=bound_ms(nbytes), bound_by="bytes",
        library_ms=time_ms(torch, lambda: buf.copy_(win.to(torch.float32)), flush=flush),
        shape=list(win.shape),
    )
    print("copy_convert:", json.dumps(kernels["copy_convert"]), flush=True)

    # -- 2b. gather_pack over the main path's coalesced layouts ------------
    worst, layouts = 0.0, []
    for name, n_parts in (("persistent", 1), ("partitioned", 4), ("fused", 1)):
        drv = make_driver(StrategyConfig(name=name, n_parts=n_parts, packer="cuda"),
                          mesh, dom.halo_spec, ndim=3)
        layouts += list(drv.wire_layouts(x))
    for lay in layouts:
        table = pack_k.segment_table(lay.segments, local, dev)
        for wire in (torch.float32, torch.bfloat16):
            out = torch.empty((ranks, lay.total), dtype=wire, device=dev)
            pack_k.gather_pack(xb, table, out)
            want = gather_pack_ref(xb, lay.segments, total=lay.total, out_dtype=wire)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            if not torch.equal(out, want):
                fail(f"gather_pack {lay.hops and lay.hops[0][0]} total={lay.total} {wire}: err {err}")
            worst = max(worst, err)
    print(f"gather_pack: {len(layouts)} layouts x (f32, bf16) wire exact", flush=True)
    lay = max(layouts, key=lambda la: (len(la.segments), la.total))
    table = pack_k.segment_table(lay.segments, local, dev)
    out = torch.empty((ranks, lay.total), dtype=torch.float32, device=dev)
    ids = torch.arange(math.prod(local), device=dev).view(local)
    flat_idx = torch.cat([
        ids[tuple(slice(b, b + n) for b, n in zip(s.src_start, s.shape))].reshape(-1)
        for s in lay.segments
    ])
    del ids
    xflat = xb.reshape(ranks, -1)
    torch.cuda.synchronize()
    if not torch.equal(torch.index_select(xflat, 1, flat_idx), gather_pack_ref(xb, lay.segments, total=lay.total)):
        fail("gather_pack library yardstick gathers other elements")
    kernels["gather_pack"] = dict(
        name="gather_pack", route="cuda", source="src/repro_torch/kernels/csrc/pack.cu",
        replaces="src/repro/kernels/pack/pack.py:112", max_abs_err=worst,
        ms=time_ms(torch, lambda: pack_k.gather_pack(xb, table, out), flush=flush),
        plain_ms=time_ms(torch, lambda: gather_pack_ref(xb, lay.segments, total=lay.total), flush=flush),
        bound_ms=bound_ms(2 * ranks * lay.total * 4), bound_by="bytes",
        library_ms=time_ms(torch, lambda: torch.index_select(xflat, 1, flat_idx), flush=flush),
        segments=len(lay.segments), total=lay.total,
    )
    print("gather_pack:", json.dumps(kernels["gather_pack"]), flush=True)

    # -- 2c. stencil27 at the heat3d update's shapes ------------------------
    w = jacobi_weights(device=dev)
    wr = torch.randn((3, 3, 3), generator=torch.Generator(dev).manual_seed(5), device=dev)
    worst = 0.0
    xp = torch.cat([xb[..., -1:], xb, xb[..., :1]], dim=-1)  # (8, 258, 514, 514)
    cases = [("update f32", xp, wr), ("update bf16", xp.to(torch.bfloat16), wr),
             ("z shell f32", xp[:, :3].contiguous(), wr),
             ("y shell f32", xp[:, :, :3].contiguous(), wr),
             ("jacobi f32", xp, w)]
    for label, inp, weights in cases:
        outk = torch.empty((ranks, *(s - 2 for s in inp.shape[1:])), dtype=inp.dtype, device=dev)
        stencil27(inp, weights, outk)
        want = stencil27_ref(inp, weights)
        torch.cuda.synchronize()
        rtol, atol = STENCIL_TOL[str(inp.dtype)[6:]]
        err = (outk.float() - want.float()).abs().max().item()
        if not torch.isfinite(outk.float()).all() or not torch.allclose(
                outk.float(), want.float(), rtol=rtol, atol=atol):
            fail(f"stencil27 {label} {tuple(inp.shape)}: max abs err {err}")
        worst = max(worst, err)
        print(f"stencil27 {label} {tuple(inp.shape)}: max abs err {err} "
              f"(bitwise {torch.equal(outk, want)})", flush=True)
        del outk, want
    outk = torch.empty((ranks, *(s - 2 for s in xp.shape[1:])), dtype=xp.dtype, device=dev)
    conv_w = wr.view(1, 1, 3, 3, 3)
    xp5 = xp.unsqueeze(1)
    conv = F.conv3d(xp5, conv_w)
    torch.cuda.synchronize()
    conv_err = (conv.view_as(outk) - stencil27_ref(xp, wr)).abs().max().item()
    del conv
    kernels["stencil27"] = dict(
        name="stencil27", route="cuda", source="src/repro_torch/kernels/csrc/stencil27.cu",
        replaces="src/repro/kernels/stencil27/stencil27.py:67", max_abs_err=worst,
        ms=time_ms(torch, lambda: stencil27(xp, wr, outk)),
        plain_ms=time_ms(torch, lambda: stencil27_ref(xp, wr), reps=3),
        bound_ms=bound_ms((xp.numel() + outk.numel()) * 4), bound_by="bytes",
        library_ms=time_ms(torch, lambda: F.conv3d(xp5, conv_w), reps=3),
        library_max_abs_err=conv_err, shape=list(xp.shape),
    )
    print("stencil27:", json.dumps(kernels["stencil27"]), flush=True)
    del xp, xp5, outk, cases, x, xb
    torch.cuda.empty_cache()

    # -- 3. exchange matrix at full size ------------------------------------
    interior = torch.randn(GLOBAL_INTERIOR, generator=torch.Generator(dev).manual_seed(1), device=dev)
    want = reference_exchange(dom, interior)
    cells = 0
    for name in available_strategies():
        for packer in available_packers():
            for coalesce in (True, False):
                drv = make_driver(StrategyConfig(name=name, packer=packer, coalesce=coalesce,
                                                 n_parts=4 if name == "partitioned" else 1),
                                  mesh, dom.halo_spec, ndim=3)
                got = drv.wait(drv.step(dom.from_global_interior(interior)))
                drv.free()
                rtol, atol = get_packer(packer).wire_tolerance(dom.dtype)
                ok = (torch.equal(got, want) if rtol == atol == 0.0
                      else bool(torch.isclose(got, want, rtol=rtol, atol=atol).all()))
                if not ok:
                    fail(f"exchange {name} {packer} coalesce={coalesce} differs from reference_exchange")
                cells += 1
                del got
    print(f"exchange matrix: {cells} cells (5 strategies x {len(available_packers())} packers "
          f"x coalesce) equal reference_exchange (bitwise for exact packers)", flush=True)
    del want
    torch.cuda.empty_cache()

    # -- 4. heat3d through comb_measure: the main path ----------------------
    weights = jacobi_weights().numpy()
    update = heat3d_update(weights, dev)
    strategies = ("standard", "persistent", "partitioned", "fused", "overlap")
    _build.reset_launches()
    results, per_cycle = {}, {}
    for name in strategies:
        before = dict(_build.LAUNCHES)
        res = comb_measure(dom, strategies=(StrategyConfig(
            name=name, packer="cuda", coalesce=True, n_parts=4 if name == "partitioned" else 1),),
            update_fn=update, n_cycles=HEAT_CYCLES, repeats=HEAT_REPEATS, seed=0)
        (label, r), = res.items()
        cycles = 3 + HEAT_CYCLES * HEAT_REPEATS  # run_cycles' warmup + timed
        per_cycle[name] = {k: (v - before.get(k, 0)) / cycles for k, v in _build.LAUNCHES.items()}
        results[label] = r
        print(f"heat3d {label}: us_per_cycle={r.us_per_cycle:.1f} init_us={r.init_us:.1f} "
              f"collective_count={r.collective_count} launches/cycle={per_cycle[name]} "
              f"checksum={r.checksum!r} device={r.device}", flush=True)
    launches = dict(_build.LAUNCHES)
    print("launches on the heat3d path:", json.dumps(launches), flush=True)
    for kname in ("copy_convert", "gather_pack", "stencil27"):
        if launches.get(kname, 0) <= 0:
            fail(f"kernel {kname} was not launched on the main path")
        kernels[kname]["launches"] = launches[kname]
    ref_sum = next(iter(results.values())).checksum
    for label, r in results.items():
        if not math.isfinite(r.checksum) or abs(r.checksum - ref_sum) >= 1e-3 + 1e-3 * abs(ref_sum):
            fail(f"heat3d {label} checksum {r.checksum} diverged from {ref_sum}")

    # the same cycles through packer `slice` and the plain stencil
    plain = make_driver(StrategyConfig(name="persistent", packer="slice"), mesh, dom.halo_spec,
                        ndim=3, update_fn=heat3d_update(weights, dev, stencil=stencil27_ref))
    ref_x = dom.random(2)
    for _ in range(VERIFY_CYCLES):
        ref_x = plain.step(ref_x)
    ref_x = plain.wait(ref_x)
    plain.free()
    rtol, atol = STENCIL_TOL["float32"]
    breakdown = {}
    for name in strategies:
        drv = make_driver(StrategyConfig(name=name, packer="cuda", n_parts=4 if name == "partitioned" else 1),
                          mesh, dom.halo_spec, ndim=3, update_fn=update)
        y = dom.random(2)
        for _ in range(VERIFY_CYCLES):
            y = drv.step(y)
        y = drv.wait(y)
        if not torch.isfinite(y).all() or not torch.allclose(y, ref_x, rtol=rtol, atol=atol):
            fail(f"heat3d {name}: {VERIFY_CYCLES} cycles differ from the slice + stencil27_ref cycles "
                 f"(max abs err {(y - ref_x).abs().max().item()})")
        print(f"heat3d {name}: {VERIFY_CYCLES} cycles match slice + stencil27_ref "
              f"(max abs err {(y - ref_x).abs().max().item()})", flush=True)
        # where the cycle's time goes (torch.profiler, 3 traced cycles)
        b = breakdown[name] = device_breakdown(drv, y)
        drv.free()
        del y
        top = ", ".join(f"{short_kernel_name(k['name'])} x{k['launches_per_cycle']:g} "
                        f"{k['us_per_cycle']:.0f}us"
                        for k in b["kernels"][:6])
        print(f"heat3d {name} breakdown: window {b['window_us_per_cycle']:.0f} us/cycle, "
              f"device busy {b['busy_us_per_cycle']:.0f} us, idle share {b['idle_share']:.3f}; "
              f"{top}", flush=True)

    # -- A. flash_attention against its plain version ------------------------
    del drv, plain, ref_x, interior, weights, update, dom, mesh
    torch.cuda.empty_cache()
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    gen = torch.Generator(dev).manual_seed(7)

    def qkv(b, s, hq, hkv, d, dtype, strided=False):
        q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype) for _ in range(2))
        return (q if strided else q.contiguous()), k, v

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"llama3-8b prefill S={s}", (1, s, 32, 8, 128), bf16, True, False)
             for s in (8, 128, 1000, 2048)]
    cases += [("MHA d=64 causal", (1, 512, 32, 32, 64), bf16, True, False),
              ("MHA d=64 non-causal", (1, 512, 32, 32, 64), bf16, False, False),
              ("GQA f32 causal", (1, 256, 32, 8, 128), f32, True, False),
              ("strided q, ragged, non-causal", (2, 100, 4, 2, 64), bf16, False, True)]
    worst = 0.0
    for label, shape, dtype, causal, strided in cases:
        q, k, v = qkv(*shape, dtype, strided)
        got = flash_attention(q, k, v, causal=causal)
        want = attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype)[6:]]
        err = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got.float()).all() or not torch.allclose(
                got.float(), want.float(), rtol=tol, atol=tol):
            fail(f"flash_attention {label} q {tuple(q.shape)} {dtype}: max abs err {err}")
        worst = max(worst, err)
        print(f"flash_attention {label} q {tuple(q.shape)} kv {tuple(k.shape)} {str(dtype)[6:]}: "
              f"max abs err {err} (tol {tol})", flush=True)
    q, k, v = qkv(1, 2048, 32, 8, 128, bf16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    torch.cuda.synchronize()
    sdpa_err = (sdpa.transpose(1, 2).float() - attention_plain(q, k, v).float()).abs().max().item()
    flops = 2 * q.shape[0] * q.shape[2] * q.shape[1] * k.shape[1] * q.shape[3]
    nbytes = 2 * (q.numel() + k.numel() + v.numel()) * q.element_size()
    kernels["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash.py:127", max_abs_err=worst,
        ms=time_ms(torch, lambda: flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(torch, lambda: attention_plain(q, k, v, causal=True)),
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        library_max_abs_err=sdpa_err, flops=flops, flop_convention="2*B*Hq*Sq*Skv*D (causal)",
        bytes=nbytes, shape=[list(q.shape), list(k.shape)],
    )
    print("flash_attention:", json.dumps(kernels["flash_attention"]), flush=True)
    del q, k, v, qt, kt, vt, sdpa, got, want
    torch.cuda.empty_cache()

    # -- B. serving llama3-8b at full width: the second main path ------------
    record["serving"] = serve_llama(torch, dev, kernels)

    # -- 5. results -----------------------------------------------------------
    record.update(
        kernels=list(kernels.values()),
        heat3d={label: r.record() for label, r in results.items()},
        launches_per_cycle=per_cycle, exchange_cells=cells, breakdown=breakdown,
    )
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in kernels.values()]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
