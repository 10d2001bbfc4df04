"""Phase M of ``chip_smoke.py``: every family trains on one card.

* M1, the WKV backward kernel ``wkv_chunked_bwd`` against its plain
  version ``wkv_bwd_plain`` in float64 on the same inputs: at rwkv6-1.6b's
  training shape (1, 4096, 32 heads of 64, chunk 64), at head sizes 8, 16
  and 32 with chunk 16, with ``T = c`` (64, and 40: a chunk that is not a
  multiple of 16), with a given ``S0`` and a non-zero gradient on the final
  state, and in bf16.  Through :class:`~repro_torch.kernels.wkv.wkv.
  WkvChunkedFn` (the forward writing its chunk-entry states, then the
  backward: one launch each), every output (dr, dk, dv, dlw, du, dS0)
  within ``WKV_BWD_TOL`` relative L2 by dtype.  At the training shape:
  three calls bitwise equal; the backward alone timed by CUDA events and
  by ``torch.profiler`` beside ``wkv_bwd_plain`` and autograd's backward
  through ``wkv_plain`` (no PyTorch call computes the WKV backward), its
  bound from its operation count (f32 on the CUDA cores, as the forward's
  row) and its bytes, and the forward with and without the states.
* M2, rwkv6-1.6b at full width and depth (24 layers, 1.596 B parameters,
  random bf16 weights from seed 0, f32 AdamW moments) through the port's
  ``Trainer``: 6 steps of 2 x 4096 tokens in the config's 2 microbatches
  (TRAIN_4K's batch of 256 cut to what one card holds, as phase L2).
  Launch counts zeroed just before and read just after:
  ``wkv_chunked_bwd`` exactly layers x microbatches = 48 times a step,
  ``wkv_chunked`` twice that (every block is recomputed in the backward:
  the config's remat, as JAX's).  Every loss finite.  Prints ms a step
  (median of steps 2-5) against its floor (``model_flops_per_token(4096)``
  x 8192 tokens over 989 TFLOP/s), ``max_memory_allocated``, the idle
  share of a traced step and the WKV forward and backward device ms a
  step.  Then, on a fresh state after one step (which moves ``w_lora_b``
  off its zero init, so ``w_lora_a`` has a gradient), one microbatch's
  gradients must be finite and non-zero on every parameter leaf (``u``,
  ``w_base``, ``w_lora_a``/``w_lora_b`` and ``mu`` among them).
* M3, the other families, 3 steps each of 2 x 4096 tokens in the
  config's microbatches (cut to divide the batch): hubert-xlarge at full
  width and 12 of 48 layers, zamba2-1.2b at full width and 12 of 38
  layers (both cut for the script's time); phi3.5-moe at full
  width and 2 of 32 layers (about 16 bytes a parameter with the f32
  moments and accumulators: 2 layers and the embeddings are 2.9 B
  parameters, 46 GB, where 3 would be 67 GB before activations);
  llama-3.2-vision-11b at full width and one group (its 4 self layers and
  one cross layer of 1601 vision tokens), the gates opened to 0.5 (they
  start at zero, where the cross layers get no gradient).  Every loss
  finite; the flash forward and backward launched by the attention layers
  a step (the forward twice where the config's remat recomputes the
  layer); every leaf's gradient finite and non-zero on one microbatch
  after the steps, but for MoE experts that received no token, whose
  zero gradient is reported.  One more step is traced (``torch.profiler``):
  its idle share, busy time, the flash kernels' device ms and the top
  kernels.

``chip_smoke.py`` calls :func:`families_train_phase` after phase L;
alone::

    PYTHONPATH=src python3 tools/train_families_lm.py [--phases M1,M2,M3]
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import re
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from train_lm import (  # noqa: E402  (the tools' own directory, above)
    BF16_FLOP_PER_S,
    FLASH_KERNELS,
    HBM_BYTES_PER_S,
    TRAIN_BATCH,
    TRAIN_SEQ,
    PhaseFailure,
    events_ms,
    grad_norms,
    kernel_device_ms,
    rel_err,
    train_full_width,
)

#: H100 SXM data-sheet f32 rate outside the tensor cores (the WKV kernels'
#: arithmetic)
F32_FLOP_PER_S = 67e12
RWKV = "rwkv6-1.6b"
FAMILY_STEPS = 3
NAMES = ("dr", "dk", "dv", "dlw", "du", "dS0")
#: (label, (B, T, H, hd), chunk, dtype, a given S0 and dS_fin)
BWD_CASES = (
    ("rwkv6-1.6b training shape", (1, 4096, 32, 64), 64, "float32", False),
    ("hd 8, chunk 16", (2, 1024, 16, 8), 16, "float32", False),
    ("hd 16, chunk 16", (2, 1024, 16, 16), 16, "float32", False),
    ("hd 32, chunk 16", (2, 1024, 16, 32), 16, "float32", False),
    ("T = c = 64", (4, 64, 32, 64), 64, "float32", True),
    ("T = c = 40, a ragged chunk", (4, 40, 32, 64), 64, "float32", True),
    ("given S0, non-zero dS_fin", (2, 2048, 32, 64), 64, "float32", True),
    ("bf16", (1, 2048, 32, 64), 64, "bfloat16", True),
)
PATH_SHAPE, PATH_CHUNK = (1, 4096, 32, 64), 64
#: M1's calls between a pair of CUDA events when the profiler lost records
BACK_TO_BACK = 20
#: the name substring of every kernel a ``wkv_chunked_bwd`` call launches
#: (``wkv_bwd_state_kernel``, ``wkv_bwd_scan_kernel``, ``wkv_bwd_chunk_kernel``)
BWD_KERNELS = "wkv_bwd_"
#: M3: (config, updates, what was cut)
FAMILIES = (
    ("hubert-xlarge", {"n_layers": 12},
     "depth 48 -> 24 layers when phase N joined, -> 12 when phase O joined (the script's "
     "time)"),
    ("zamba2-1.2b", {"n_layers": 12},
     "depth 38 -> 19 layers, then 12 (two groups of 6), when phase O joined (the script's "
     "time)"),
    ("phi3.5-moe-42b-a6.6b", {"n_layers": 2},
     "depth 32 -> 2 layers (the state one card holds: about 16 bytes a parameter)"),
    ("llama-3.2-vision-11b", {"n_layers": 5, "n_cross_layers": 1},
     "depth 40 -> one group of 5 (4 self layers and one cross layer)"),
)


def _device_ms(torch, fn, kernel: str, fails: list, reps: int = 5) -> dict:
    """Device time of one call of ``fn``, summed over the launches of
    ``kernel`` (a substring of their names) that the call makes, averaged
    over ``reps`` calls by ``core/profiling.device_breakdown``, with those
    launches a call and the device ms a call of each kernel by its name from
    ``kernel`` on.  A complete trace without the kernel is a failure: NaN,
    in ``fails``.  When every session the profiler traced lost device
    records, the device time is that of ``BACK_TO_BACK`` calls between a
    pair of CUDA events, a call's share (the card never waits on the host
    there), without the split by kernel, and ``device_ms_source`` says so."""
    from repro_torch.core.profiling import device_breakdown

    try:
        trace = device_breakdown(fn, n_cycles=reps)
        lost = trace["missing_records"] and (f"{trace['missing_records']} launch calls without "
                                             f"a device record in {trace['sessions']} sessions")
    except RuntimeError as exc:  # no device record in any session
        lost = str(exc)
    if not lost:
        t = kernel_device_ms(trace, {"k": (kernel,)})
        if not t["k_launches"]:
            fails.append(f"M1: the profiler's trace of {reps} calls holds no {kernel} launch")
            return dict(device_ms=math.nan, device_launches_a_call=0.0, device_ms_by_kernel={},
                        device_ms_source="torch.profiler")
        by = {}
        for k in trace["kernels"]:
            if kernel in k["name"]:
                name = re.match(r"\w+", k["name"][k["name"].index(kernel):]).group(0)
                by[name] = by.get(name, 0.0) + k["us_per_cycle"] / 1e3
        return dict(device_ms=t["k_ms"], device_launches_a_call=t["k_launches"],
                    device_ms_by_kernel=by, device_ms_source="torch.profiler")
    print(f"M1: the profiler lost device records ({lost}); the device time is CUDA events "
          f"over {BACK_TO_BACK} back-to-back calls", file=sys.stderr, flush=True)
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(BACK_TO_BACK):
        fn()
    end.record()
    end.synchronize()
    return dict(device_ms=start.elapsed_time(end) / BACK_TO_BACK, device_launches_a_call=None,
                device_ms_by_kernel={},
                device_ms_source=f"CUDA events over {BACK_TO_BACK} back-to-back calls ({lost})")


def wkv_backward_checks(torch, dev, fails: list) -> dict:
    """M1; appends to ``fails``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import wkv, wkv_bwd_plain, wkv_plain
    from repro_torch.kernels.wkv.ref import BWD_TOL, bwd_check_inputs
    from repro_torch.kernels.costs import wkv_bwd_cost
    from repro_torch.kernels.wkv.wkv import bwd_workspace_floats, wkv_chunked, wkv_chunked_bwd

    out: dict = {"cases": [], "max_abs_err": 0.0}
    for label, (B, T, H, hd), chunk, dtname, with_state in BWD_CASES:
        dtype = getattr(torch, dtname)
        r, k, v, lw, u, S0, dy, dS_fin = bwd_check_inputs(B, T, H, hd, dtype=dtype, device=dev)
        S0, dS_fin = (S0, dS_fin) if with_state else (None, None)
        leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
        s0 = None if S0 is None else S0.clone().requires_grad_()
        _build.reset_launches()
        y, S = wkv(*leaves, chunk=chunk, S0=s0)  # grad enabled: WkvChunkedFn
        obj = (y.float() * dy.float()).sum() + (0 if dS_fin is None else (S * dS_fin).sum())
        got = torch.autograd.grad(obj, leaves + ([] if s0 is None else [s0]))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want = wkv_bwd_plain(*(t.double() for t in (r, k, v, lw, u, dy)), chunk=chunk,
                             S0=None if S0 is None else S0.double(),
                             dS_fin=None if dS_fin is None else dS_fin.double())
        errs = {n: rel_err(g.float(), w) for n, g, w in zip(NAMES, got, want)}
        abs_err = max((g.double() - w).abs().max().item() for g, w in zip(got, want))
        out["max_abs_err"] = max(out["max_abs_err"], abs_err)
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        tol = BWD_TOL[dtname]
        ok = finite and all(e <= tol for e in errs.values())
        if launches != {"wkv_chunked": 1, "wkv_chunked_bwd": 1}:
            ok = False
            fails.append(f"M1 {label}: launches {launches}")
        case = dict(label=label, shape=[B, T, H, hd], chunk=min(chunk, T), dtype=dtname,
                    with_state=with_state, rel_err=errs, max_abs_err=abs_err, tol=tol,
                    finite=finite, ok=ok)
        print(f"M1 {label} {case['shape']} chunk {case['chunk']} {dtname}: {json.dumps(case)}",
              flush=True)
        if not ok:
            fails.append(f"M1 {label}: {errs}, finite {finite}")
        out["cases"].append(case)
        del r, k, v, lw, u, S0, dy, dS_fin, leaves, s0, y, S, obj, got, want
        torch.cuda.empty_cache()

    # the backward alone at the training path's shape
    B, T, H, hd = PATH_SHAPE
    r, k, v, lw, u, _, dy, _ = bwd_check_inputs(B, T, H, hd, device=dev, seed=1)
    states = torch.empty((B, H, T // PATH_CHUNK, hd, hd), device=dev)
    y, S_fin = wkv_chunked(r, k, v, lw, u, chunk=PATH_CHUNK, states=states)

    def kernel():
        return wkv_chunked_bwd(r, k, v, lw, u, dy, states, chunk=PATH_CHUNK)

    first, *more = (kernel()[:5] for _ in range(3))  # dS0 is None: no starting state
    repeatable = all(torch.equal(a, b) for again in more for a, b in zip(first, again))
    del first, more
    if not repeatable:
        fails.append("M1: three backward calls on the same inputs differ")
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
    yp, _ = wkv_plain(*leaves, chunk=PATH_CHUNK)
    flops, nbytes = wkv_bwd_cost(B, T, H, hd, PATH_CHUNK, itemsize=4, u_numel=u.numel())
    t_ops, t_bytes = flops / F32_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    ms = [events_ms(torch, kernel)]
    plain_ms = events_ms(torch, lambda: wkv_bwd_plain(r, k, v, lw, u, dy, chunk=PATH_CHUNK),
                         reps=3)
    autograd_ms = events_ms(torch, lambda: torch.autograd.grad(yp, leaves, dy, retain_graph=True),
                            reps=3)
    ms.append(events_ms(torch, kernel))
    fwd = lambda: wkv_chunked(r, k, v, lw, u, chunk=PATH_CHUNK)  # noqa: E731
    fwd_states = lambda: wkv_chunked(r, k, v, lw, u, chunk=PATH_CHUNK, states=states)  # noqa: E731
    out["path"] = dict(
        shape=list(PATH_SHAPE), chunk=PATH_CHUNK, dtype="float32",
        ms=statistics.median(ms), ms_turns=ms, **_device_ms(torch, kernel, BWD_KERNELS, fails),
        scratch_bytes_a_call=4 * bwd_workspace_floats(B, T, H, hd, PATH_CHUNK),
        plain_ms=plain_ms, autograd_plain_ms=autograd_ms,
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops > t_bytes else "bytes",
        flops=flops, bytes=nbytes,
        flop_convention="per (row, chunk): 8*c*hd^2 + hd*(11*P_diag + 6*P_off) + 2*hd*c(c+1) "
                        "+ 6*c*hd; P_diag the strictly lower pairs inside 16-row sub-blocks, "
                        "P_off the rest",
        forward_ms=events_ms(torch, fwd), forward_with_states_ms=events_ms(torch, fwd_states),
        bitwise_repeatable=repeatable,
        timing="CUDA events around one call, median of 5 (plain: 3) after a warm-up; the "
               "kernel before and after the plain versions; device_ms a call's kernels "
               "(wkv_bwd_*) summed, the mean of a torch.profiler trace of 5 calls "
               "(device_breakdown; device_ms_source says when it lost records and CUDA "
               "events over back-to-back calls stood in); plain_ms wkv_bwd_plain in f32, autograd_plain_ms "
               "autograd's backward through wkv_plain's graph")
    out["path"]["device_over_bound"] = out["path"]["device_ms"] / out["path"]["bound_ms"]
    p = out["path"]
    print(f"M1 backward at the training path's shape: {json.dumps(p)}", flush=True)
    print(f"M1 path backward ms {p['ms']:.4f} (turns {p['ms_turns']}), device {p['device_ms']:.4f} "
          f"a call over its {p['device_launches_a_call']} kernels "
          f"{json.dumps(p['device_ms_by_kernel'])} ({p['device_ms_source']}), scratch "
          f"{p['scratch_bytes_a_call'] / 1e6:.1f} MB a call", flush=True)
    print(f"M1 path plain ms {p['plain_ms']:.4f}, autograd through wkv_plain "
          f"{p['autograd_plain_ms']:.4f}", flush=True)
    print(f"M1 path bound ms {p['bound_ms']:.4f} ({p['bound_by']}), device "
          f"{p['device_over_bound']:.1f}x the bound", flush=True)
    print(f"M1 forward ms {p['forward_ms']:.4f}, with the states {p['forward_with_states_ms']:.4f}",
          flush=True)
    print(f"M1 bitwise repeatable over three calls {repeatable}", flush=True)
    return out


def _short(kernel: dict) -> str:
    """One kernel of a trace as ``name: ms a step (launches)``."""
    return (f"{kernel['name'][:60]}: {kernel['us_per_cycle'] / 1e3:.1f} ms "
            f"({kernel['launches_per_cycle']:.0f})")


def rwkv_training(torch, dev, fails: list) -> dict:
    """M2; appends to ``fails``."""
    def launches_a_step(cfg, micro):  # a layer's scan a microbatch
        recompute = 2 if cfg.remat != "none" else 1
        return {"wkv_chunked": recompute * cfg.n_layers * micro,
                "wkv_chunked_bwd": cfg.n_layers * micro}

    return train_full_width(
        torch, dev, fails, tag="M2", config=RWKV, launches_a_step=launches_a_step,
        layer0=("u", "w_base", "w_lora_a", "w_lora_b", "mu", "mu_c"),
        groups={"fwd": ("wkv_chunk_kernel",), "bwd": (BWD_KERNELS,)})


def _attention_sites(cfg) -> tuple[int, int]:
    """(flash forward calls, flash backward calls) a microbatch: each
    attention layer once forward and once backward, and once more forward
    where ``cfg.remat`` recomputes it (the dense-style blocks of the moe,
    vlm self and audio layers; not zamba2's shared block or the VLM's cross
    layers, as in JAX)."""
    again = 2 if cfg.remat != "none" else 1
    if cfg.family == "hybrid":
        n = cfg.n_layers // cfg.attn_every
        return n, n
    if cfg.family == "vlm":
        n_self = cfg.n_layers - cfg.n_cross_layers
        return again * n_self + cfg.n_cross_layers, cfg.n_layers
    return again * cfg.n_layers, cfg.n_layers


def family_training(torch, dev, fails: list) -> dict:
    """M3; appends to ``fails``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, ShapeConfig
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import init_state, make_train_step, microbatches_of

    out: dict = {}
    opt = OptimizerConfig()
    for name, upd, cut in FAMILIES:
        t_fam = time.perf_counter()
        cfg = get_config(name).with_updates(**upd) if upd else get_config(name)
        model = build_model(cfg, dev)
        micro = microbatches_of(cfg, ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train"))
        state = init_state(model, opt, 0)
        if cfg.family == "vlm":  # open the gates: closed, the cross layers get no gradient
            with torch.no_grad():
                for cp in state["params"]["cross"]:
                    for g in ("gate_attn", "gate_ffn"):
                        cp["xattn"][g].fill_(0.5)
        n_params = sum(p.numel() for _, p in tree_leaves(state["params"]))
        data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        step = make_train_step(model, opt, microbatches=micro)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses, secs = [], []
        for i in range(FAMILY_STEPS):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()}
            t0 = time.perf_counter()
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            secs.append(time.perf_counter() - t0)
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        trace = device_breakdown(lambda: step(state, batch), n_cycles=1)  # two more steps
        fwd, bwd = _attention_sites(cfg)
        want = {"flash_attention": fwd * micro * FAMILY_STEPS,
                "flash_attention_bwd": 3 * bwd * micro * FAMILY_STEPS}
        tokens = TRAIN_SEQ * TRAIN_BATCH
        flops = cfg.model_flops_per_token(TRAIN_SEQ) * tokens
        step_ms = statistics.median(secs[1:]) * 1e3
        norms, slots_zero = grad_norms(torch, model, state["params"],
                                        {k: v[:TRAIN_BATCH // micro] for k, v in batch.items()})
        expert_zero = {k: n for k, n in slots_zero.items() if n}
        bad = sorted(k for k, v in norms.items() if not (math.isfinite(v) and v > 0))
        rec = dict(
            config=name, family=cfg.family, cut=cut, params=n_params, seq=TRAIN_SEQ,
            batch=TRAIN_BATCH, microbatches=micro, steps=FAMILY_STEPS, remat=cfg.remat,
            losses=losses, step_ms_each=[s * 1e3 for s in secs], step_ms=step_ms,
            tokens_per_s=tokens / (step_ms / 1e3), floor_ms=flops / BF16_FLOP_PER_S * 1e3,
            max_memory_allocated=peak, launches=launches, launches_want=want,
            grad_leaves=len(norms), grad_norm_min=min(norms.values()),
            experts_without_tokens=expert_zero, idle_share=trace["idle_share"],
            busy_ms=trace["busy_us_per_cycle"] / 1e3, window_ms=trace["window_us_per_cycle"] / 1e3,
            trace_sessions=trace["sessions"],
            flash_per_step=kernel_device_ms(trace, FLASH_KERNELS),
            top_kernels=trace["kernels"][:8],
            timing="host clock around each step, ending with the loss read back; step_ms the "
                   "median of steps 2-3")
        if not all(math.isfinite(x) for x in losses):
            fails.append(f"M3 {name}: losses {losses}")
        if any(launches.get(k, 0) != n for k, n in want.items()):
            fails.append(f"M3 {name}: launches {launches}, want {want}")
        if bad:
            fails.append(f"M3 {name}: leaves without a finite non-zero gradient: {bad[:8]}")
        rec["family_s"] = time.perf_counter() - t_fam
        print(f"M3 {name} ({cut}): {json.dumps(rec)}", flush=True)
        print(f"M3 {name}: {n_params / 1e9:.3f} B parameters, {micro} microbatches, step ms "
              f"{step_ms:.1f} (floor {rec['floor_ms']:.1f}), idle {rec['idle_share']:.3f} of a "
              f"traced step, flash {json.dumps(rec['flash_per_step'])}, top kernel "
              f"{_short(trace['kernels'][0])}, peak {peak / 1e9:.1f} GB, losses "
              f"{losses}, flash {launches.get('flash_attention', 0)} + backward "
              f"{launches.get('flash_attention_bwd', 0)}, expert slots without a token "
              f"{sum(expert_zero.values())}", flush=True)
        out[name] = rec
        del model, state, step, batch, data
        torch.cuda.empty_cache()
    return out


def families_train_phase(torch, dev, phases=("M1", "M2", "M3")) -> dict:
    """Phase M; raises :class:`PhaseFailure` after printing everything
    when a check fails."""
    import gc

    fails: list[str] = []
    out: dict = {}
    steps = {"M1": wkv_backward_checks, "M2": rwkv_training, "M3": family_training}
    for name in phases:
        t0 = time.perf_counter()
        out[name] = steps[name](torch, dev, fails)
        out[name]["phase_s"] = time.perf_counter() - t0
        print(f"phase {name} took {out[name]['phase_s']:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    out["failures"] = fails
    if fails:
        raise PhaseFailure("; ".join(fails))
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="M1,M2,M3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_families_lm: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s; card {torch.cuda.get_device_name(0)}",
          flush=True)
    try:
        out = families_train_phase(torch, torch.device("cuda", 0), tuple(args.phases.split(",")))
    except PhaseFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    out_dir = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "train_families_lm.json").write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
