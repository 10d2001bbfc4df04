"""Phase L of ``chip_smoke.py``: training on one card.

* L1, the flash-attention backward against its plain version: at
  stablelm-1.6b's training shape (2, 4096, 32 heads of 64, causal, bf16),
  llama3-8b's GQA (1, 2048, 32 on 8 heads of 128, causal, bf16),
  hubert-xlarge's encoder (4, 1000, 16 heads of 80, non-causal, bf16), and
  in f32 (the CUDA-core forward route) a ragged ``Sq != Skv`` causal case
  and one with no key at all, whose rows see nothing (``lse`` is ``-inf``,
  the gradients must be zeros, never NaN).  ``dq``, ``dk``, ``dv`` by
  :class:`~repro_torch.kernels.flash_attention.flash.FlashAttentionFn`
  against autograd through ``attention_plain`` in f32 on the same inputs,
  relative L2 within ``BWD_REL_TOL`` by dtype; the forward's ``lse``
  against ``logsumexp`` of the plain scores within ``LSE_TOL``.  Timed at
  the training path's shape (1, 4096, 32, 64): the backward alone (CUDA
  events around ``flash_attention_bwd``) beside autograd's backward of the
  plain version and of ``F.scaled_dot_product_attention`` (the library
  yardstick, never on the path), and forward+backward against SDPA's at
  each checked shape.
* L2, stablelm-1.6b trains at full width and depth (24 layers, 1.645 B
  parameters, random bf16 weights from seed 0, f32 AdamW moments): the
  port's ``Trainer`` at ``RunConfig(shape=ShapeConfig("chip", 4096, 2,
  "train"), steps=6)`` with the config's ``train_microbatches=2`` (one
  sequence a microbatch, f32 gradient accumulators).  Launch counts are
  zeroed just before and read just after: ``flash_attention`` must launch
  layers x microbatches times a step, ``flash_attention_bwd`` three times
  that (its pre-pass, the one pass and dQ's rounding).  Prints ms a step
  (median of steps 2-5), tokens/s, the step's share of its floor
  (``model_flops_per_token(4096)`` x 8192 tokens over 989 TFLOP/s dense
  bf16), ``torch.cuda.max_memory_allocated``, the device idle share of one
  step (``core/profiling.py``) and the flash forward and backward device ms
  a step.  Every loss must be finite, and one microbatch's gradients on a
  fresh state (its bytes and the batch's, ``torch.cuda.memory_allocated``
  of them alone, recorded for phase O3) after one step (``torch.autograd.grad`` of ``Model.loss``)
  must have a finite, non-zero norm on every parameter leaf,
  ``wq``/``wk``/``wv`` included.  :func:`train_full_width` does the same
  for rwkv6-1.6b in phase M (``tools/train_families_lm.py``).
* L3, restart on the card: stablelm-1.6b's width with 2 layers, 6 steps,
  a checkpoint every 4 (5.1 GB each, the latest one kept, in a temporary
  directory under ``build/`` removed after), an
  injected failure at step 4; the restarted run restores step 4 (so it
  logs 6 losses), finishes, and its losses are within 1e-3 relative of an
  uninterrupted run's; whether they and the final checksum are bitwise
  equal is printed (the flash backward adds dQ in a fixed order).
* L4, the kernels still without a backward refuse a gradient: the pack
  kernels ``copy_convert`` and ``gather_pack``, ``stencil27``, and the bare
  ``flash_attention`` wrapper (its backward runs through
  ``FlashAttentionFn``) each raise ``NotImplementedError`` on an input that
  requires grad, instead of returning an output without a graph; each
  runs under ``torch.no_grad``.  (rwkv trains: the WKV scan's backward is
  ``wkv_chunked_bwd``, phase M.)

``chip_smoke.py`` calls :func:`train_phase` last, after phase G; alone::

    PYTHONPATH=src python3 tools/train_lm.py [--phases L1,L2,L3,L4]
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import pathlib
import shutil
import statistics
import sys
import tempfile
import time

#: ||kernel - plain|| / ||plain|| per gradient against autograd through the
#: plain attention in f32: the bf16 route's inputs and outputs round to
#: bf16 (2^-8), the f32 route sums in another order
BWD_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: max |lse - logsumexp(plain scores)|
LSE_TOL = 1e-3
#: H100 SXM data-sheet dense bf16 tensor-core rate and HBM3 rate
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
STABLELM = "stablelm-1.6b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 6
#: L3: a checkpoint every 4 steps (every 2 until phase N joined: two 5.1 GB
#: saves fewer), the failure at step 4 restores step 4's
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 2, 6, 4, 4
#: (label, (B, Sq, Hq, Hkv, D, Skv), dtype, causal); Skv None: Sq
BWD_CASES = (
    ("stablelm-1.6b training shape", (2, 4096, 32, 32, 64, None), "bfloat16", True),
    ("llama3-8b GQA", (1, 2048, 32, 8, 128, None), "bfloat16", True),
    ("hubert-xlarge encoder, D=80, non-causal", (4, 1000, 16, 16, 80, None), "bfloat16", False),
    ("ragged Sq != Skv, GQA (CUDA-core forward)", (2, 300, 8, 4, 64, 200), "float32", True),
    ("ragged Sq != Skv, GQA, tensor cores", (2, 300, 8, 4, 64, 200), "bfloat16", True),
    ("ragged Sq < Skv, MQA, D=128, non-causal, tensor cores", (1, 77, 4, 1, 128, 130),
     "bfloat16", False),
    ("no key: every row fully masked (CUDA-core forward)", (1, 70, 4, 2, 64, 0), "float32",
     True),
)
#: the training path's attention shape, one sequence a microbatch
PATH_SHAPE = (1, 4096, 32, 32, 64)
#: (B, S, Hq, Hkv, D) where three backward calls must give the same bits:
#: the path's shape and llama3-8b's GQA, many kv tiles adding into each
#: query tile's dQ
REPEAT_SHAPES = (PATH_SHAPE, (1, 2048, 32, 8, 128))
#: the flash kernels' names in a trace: the forward (either route's kernel)
#: and the backward's (the bf16 route's three, the f32 route's)
FLASH_KERNELS = {"fwd": ("flash_tc_kernel", "flash_kernel"),
                 "bwd": ("bwd_prep_kernel", "bwd_tc_kernel", "bwd_finish_kernel", "delta_kernel",
                         "dkdv_kernel", "dq_kernel")}


class PhaseFailure(RuntimeError):
    """A check of phase L failed (``chip_smoke.py`` exits non-zero)."""


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    den = want.norm().item()
    return (got - want).norm().item() / den if den else (got - want).norm().item()


def events_ms(torch, fn, *, reps: int = 5) -> float:
    """Median device time of ``fn`` between a pair of CUDA events, after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _qkv(torch, dev, b, sq, hq, hkv, d, skv, dtype, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    skv = sq if skv is None else skv
    q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype)
    return q, k, v, dout


def backward_checks(torch, dev, fails: list) -> dict:
    """L1; appends to ``fails``."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.costs import flash_bwd_cost
    from repro_torch.kernels.flash_attention.flash import FlashAttentionFn, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import attention_plain

    out: dict = {"cases": [], "max_abs_err": 0.0}
    for label, (b, sq, hq, hkv, d, skv), dtname, causal in BWD_CASES:
        dtype = getattr(torch, dtname)
        q, k, v, dout = _qkv(torch, dev, b, sq, hq, hkv, d, skv, dtype)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        _build.reset_launches()
        o = FlashAttentionFn.apply(qg, kg, vg, causal, None)
        lse = o.grad_fn.saved_tensors[4]
        o.backward(dout)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        q32, k32, v32 = (t.float().detach().requires_grad_() for t in (q, k, v))
        want = attention_plain(q32, k32, v32, causal=causal)
        want.backward(dout.float())
        pairs = {"dq": (qg.grad, q32.grad), "dk": (kg.grad, k32.grad), "dv": (vg.grad, v32.grad)}
        errs = {"out": rel_err(o.float(), want.float()),
                **{k: rel_err(g.float(), w) for k, (g, w) in pairs.items()}}
        abs_err = max(((g.float() - w).abs().max().item() if g.numel() else 0.0)
                      for g, w in pairs.values())
        out["max_abs_err"] = max(out["max_abs_err"], abs_err)
        del want
        lse_err = _lse_err(torch, q32.detach(), k32.detach(), lse, causal)
        finite = all(bool(torch.isfinite(t).all()) for t in (o, qg.grad, kg.grad, vg.grad))
        tol = BWD_REL_TOL[dtname]
        ok = finite and all(e <= tol for e in errs.values()) and lse_err <= LSE_TOL
        if skv == 0:  # no key: zero output and gradients, lse -inf
            ok = ok and not qg.grad.any() and bool((lse == float("-inf")).all())
        # the backward's three kernels; the middle one skipped with no key
        if launches != {"flash_attention": 1, "flash_attention_bwd": 2 + (skv != 0)}:
            ok = False
            fails.append(f"L1 {label}: launches {launches}")
        case = dict(label=label, shape=[b, sq, hq, hkv, d, sq if skv is None else skv],
                    dtype=dtname, causal=causal, rel_err=errs, grad_max_abs_err=abs_err,
                    lse_max_abs_err=lse_err, tol=tol,
                    finite=finite, ok=ok)
        if sq >= 1000:  # forward+backward against SDPA's at the same shape
            case.update(_fwd_bwd_times(torch, F, FlashAttentionFn, q, k, v, dout, causal))
        print(f"L1 {label} {case['shape']} {dtname} causal={causal}: {json.dumps(case)}",
              flush=True)
        if not ok:
            fails.append(f"L1 {label}: {errs}, lse {lse_err}, finite {finite}")
        out["cases"].append(case)
        del q, k, v, dout, qg, kg, vg, o, q32, k32, v32, lse
        torch.cuda.empty_cache()

    # the backward alone at the training path's shape
    b, s, hq, hkv, d = PATH_SHAPE
    q, k, v, dout = _qkv(torch, dev, b, s, hq, hkv, d, None, torch.bfloat16, seed=1)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = FlashAttentionFn.apply(qg, kg, vg, True, None)
    lse = o.grad_fn.saved_tensors[4]
    od = o.detach()
    qp, kp, vp = (t.detach().clone().requires_grad_() for t in (q, k, v))
    plain = attention_plain(qp, kp, vp, causal=True)
    qt, kt, vt = (t.detach().transpose(1, 2).clone().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dout_t = dout.transpose(1, 2)
    flops, nbytes = flash_bwd_cost(b, s, hq, s, hkv, d, causal=True, itemsize=q.element_size())

    def kernel():
        return flash_attention_bwd(q, k, v, od, dout, lse, causal=True)

    def library():
        return torch.autograd.grad(sdpa, (qt, kt, vt), dout_t, retain_graph=True)

    # in turns: kernel, SDPA, SDPA, kernel
    ms = [events_ms(torch, kernel)]
    lib_ms = [events_ms(torch, library), events_ms(torch, library)]
    ms.append(events_ms(torch, kernel))
    out["path"] = dict(
        shape=list(PATH_SHAPE), dtype="bfloat16", causal=True,
        ms=statistics.median(ms), ms_turns=ms,
        plain_ms=events_ms(torch, lambda: torch.autograd.grad(plain, (qp, kp, vp), dout,
                                                              retain_graph=True), reps=3),
        library_ms=statistics.median(lib_ms), library_ms_turns=lib_ms,
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        flops=flops, bytes=nbytes, tflops=flops / (min(ms) / 1e3) / 1e12,
        flop_convention="5 products x 2*B*Hq*Sq*Skv*D, halved (causal): "
                        "kernels/costs.flash_bwd_cost",
        timing="CUDA events around one call, median of 5 (plain: 3) after a warm-up, in turns "
               "kernel, SDPA, SDPA, kernel; ms the kernel alone, plain_ms and library_ms "
               "autograd's backward of attention_plain and of F.scaled_dot_product_attention "
               "on (B, H, S, D) copies; tflops on the 5 products at the faster turn")
    del plain, sdpa
    out["path"]["bitwise_repeatable"] = _repeatable(torch, dev, flash_attention_bwd)
    if not all(out["path"]["bitwise_repeatable"].values()):
        fails.append(f"L1: three backward calls on the same inputs differ: "
                     f"{out['path']['bitwise_repeatable']}")
    p = out["path"]
    print(f"L1 backward at the training path's shape: {json.dumps(p)}", flush=True)
    print(f"L1 path backward ms {p['ms']:.4f} (turns {p['ms_turns']})", flush=True)
    print(f"L1 path SDPA backward ms {p['library_ms']:.4f} (turns {p['library_ms_turns']})",
          flush=True)
    print(f"L1 path bound ms {p['bound_ms']:.4f} ({p['bound_by']})", flush=True)
    print(f"L1 path TFLOP/s on the 5 products {p['tflops']:.1f}", flush=True)
    print(f"L1 bitwise repeatable over three calls {json.dumps(p['bitwise_repeatable'])}",
          flush=True)
    return out


def _repeatable(torch, dev, flash_attention_bwd) -> dict:
    """Whether three backward calls on the same inputs give the same bits,
    at each of ``REPEAT_SHAPES`` (causal bf16)."""
    from repro_torch.kernels.flash_attention.flash import flash_attention

    out = {}
    for b, s, hq, hkv, d in REPEAT_SHAPES:
        q, k, v, dout = _qkv(torch, dev, b, s, hq, hkv, d, None, torch.bfloat16, seed=2)
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
        o = flash_attention(q, k, v, causal=True, lse=lse)
        first, *more = (flash_attention_bwd(q, k, v, o, dout, lse, causal=True)
                        for _ in range(3))
        out[str([b, s, hq, hkv, d])] = all(torch.equal(x, y) for again in more
                                           for x, y in zip(first, again))
        del q, k, v, dout, lse, o, first, more
    return out


def _lse_err(torch, q32, k32, lse, causal: bool) -> float:
    """max |lse - logsumexp of the plain version's scaled, masked scores|,
    one batch row at a time (the scores of a stablelm row are 2.1 GB)."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF

    b, sq, hq, d = q32.shape
    skv, hkv = k32.shape[1], k32.shape[2]
    worst = 0.0
    for i in range(b):
        if skv == 0:
            want = torch.full((hq, sq), float("-inf"), device=q32.device)
        else:
            kf = k32[i].repeat_interleave(hq // hkv, dim=1)
            s = torch.einsum("qhd,khd->hqk", q32[i], kf) / math.sqrt(d)
            if causal:
                mask = (torch.arange(sq, device=s.device)[:, None]
                        >= torch.arange(skv, device=s.device)[None, :])
                s = s.masked_fill(~mask, NEG_INF)
            want = torch.logsumexp(s, dim=-1)
            del s
        got = lse[i]
        same_inf = (got == want) & torch.isinf(want)
        diff = torch.where(same_inf, torch.zeros_like(got), (got - want).abs())
        worst = max(worst, diff.max().item() if diff.numel() else 0.0)
    return worst


def _fwd_bwd_times(torch, F, FlashAttentionFn, q, k, v, dout, causal: bool) -> dict:
    """Forward+backward ms of the kernels and of SDPA at one shape, in turns
    (kernel, SDPA, SDPA, kernel), CUDA events."""
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    qt, kt, vt = (t.detach().transpose(1, 2).clone().requires_grad_() for t in (q, k, v))
    dout_t = dout.transpose(1, 2)
    enable_gqa = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}

    def kernel():
        torch.autograd.grad(FlashAttentionFn.apply(qg, kg, vg, causal, None), (qg, kg, vg), dout)

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **enable_gqa)
        torch.autograd.grad(o, (qt, kt, vt), dout_t)

    first = events_ms(torch, kernel, reps=3)
    lib = [events_ms(torch, sdpa, reps=3), events_ms(torch, sdpa, reps=3)]
    second = events_ms(torch, kernel, reps=3)
    return {"fwd_bwd_ms": statistics.median([first, second]),
            "sdpa_fwd_bwd_ms": statistics.median(lib)}


def kernel_device_ms(trace: dict, groups: dict) -> dict:
    """Device ms and launches a step (``{tag}_ms``, ``{tag}_launches``) of
    each group of kernel names (substrings), from a ``device_breakdown``
    trace."""
    out = {}
    for tag, names in groups.items():
        ks = [k for k in trace["kernels"] if any(n in k["name"] for n in names)]
        out[f"{tag}_ms"] = sum(k["us_per_cycle"] for k in ks) / 1e3
        out[f"{tag}_launches"] = sum(k["launches_per_cycle"] for k in ks)
    return out


def grad_norms(torch, model, params, batch) -> tuple[dict, dict]:
    """Each parameter leaf's gradient norm (by path) of ``Model.loss`` on
    ``batch``, and for each MoE expert stack ``(slots, in, out)`` the number
    of slots whose gradient is zero (experts that received no token)."""
    from repro_torch.train.optimizer import tree_leaves

    leaves = [(path, p.requires_grad_(True)) for path, p in tree_leaves(params)]
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    norms, slots_zero = {}, {}
    for (path, _), g in zip(leaves, grads):
        key = "/".join(map(str, path))
        norms[key] = g.float().norm().item()
        if "/moe/w_" in key:
            slots_zero[key] = int((g.flatten(1).float().norm(dim=1) == 0).sum())
    del grads, loss
    return norms, slots_zero


def train_full_width(torch, dev, fails: list, *, tag: str, config: str, launches_a_step,
                     layer0: tuple, groups: dict) -> dict:
    """Trains ``config`` at full width and depth through the port's
    ``Trainer`` (L2, and phase M's M2); appends to ``fails``.
    ``launches_a_step(cfg, microbatches)`` gives the launches of each kernel
    a step; ``layer0`` names layer 0's leaves whose gradient norms are
    printed; ``groups`` the kernels (name substrings) whose device ms a step
    a traced step reports."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import Trainer, init_state, make_train_step

    cfg = get_config(config)
    model = build_model(cfg, dev)
    opt = OptimizerConfig()
    run_cfg = RunConfig(model=cfg, shape=ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
                        optimizer=opt, steps=TRAIN_STEPS, log_every=1)
    trainer = Trainer(model, run_cfg)
    micro = trainer.microbatches
    if micro != cfg.train_microbatches:
        fails.append(f"{tag}: the Trainer took {micro} microbatches, the config says "
                     f"{cfg.train_microbatches}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()  # what earlier work left allocated
    _build.reset_launches()
    t0 = time.perf_counter()
    result = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops = cfg.model_flops_per_token(TRAIN_SEQ) * tokens
    step_ms = statistics.median(result.step_seconds[1:5]) * 1e3
    floor_ms = flops / BF16_FLOP_PER_S * 1e3
    want = {k: n * TRAIN_STEPS for k, n in launches_a_step(cfg, micro).items()}
    out = dict(
        config=config, params=cfg.param_count(), seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        microbatches=micro, steps=TRAIN_STEPS, remat=cfg.remat, losses=result.losses,
        step_ms_each=[s * 1e3 for s in result.step_seconds], step_ms=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3), model_flops=flops, floor_ms=floor_ms,
        floor_share=floor_ms / step_ms, max_memory_allocated=peak,
        allocated_at_start=at_start, wall_s=wall,
        launches=launches, launches_want=want,
        launches_a_step={k: launches.get(k, 0) / TRAIN_STEPS for k in want},
        timing="host clock around each Trainer step, ending with the loss read back; "
               "step_ms the median of steps 2-5 (1-based)")
    if not all(math.isfinite(x) for x in result.losses) or len(result.losses) != TRAIN_STEPS:
        fails.append(f"{tag}: losses {result.losses}")
    if any(launches.get(k, 0) != n for k, n in want.items()):
        fails.append(f"{tag}: launches {launches}, want {want}")
    print(f"{tag} {config} Trainer, {TRAIN_STEPS} steps: {json.dumps(out)}", flush=True)
    del trainer, result

    # one fresh state and one step (which moves a leaf with a zero init, as
    # rwkv's w_lora_b, off it), then every leaf's gradient on one
    # microbatch, and one more step's device trace
    gc.collect()  # what the run left in reference cycles goes before the count
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = init_state(model, opt, run_cfg.seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ).batch_at(0).items()}
    # the placed state and batch alone, as the dry-run's argument bytes (phase O3)
    out["state_batch_allocated"] = torch.cuda.memory_allocated() - before
    step = make_train_step(model, opt, microbatches=micro)
    state, _ = step(state, batch)
    norms, _ = grad_norms(torch, model, state["params"], {k: v[:1] for k, v in batch.items()})
    bad = {k: v for k, v in norms.items() if not (math.isfinite(v) and v > 0)}
    out["grad_leaves"] = len(norms)
    out["grad_norm_min"] = min(norms.values())
    out["grad_norms_layer0"] = {n: norms[f"layers/0/{n}"] for n in layer0}
    if bad:
        fails.append(f"{tag}: leaves without a finite non-zero gradient: {sorted(bad)[:8]}")
    trace = device_breakdown(lambda: step(state, batch), n_cycles=1)
    out["idle_share"] = trace["idle_share"]
    out["trace_sessions"] = trace["sessions"]
    out["busy_ms"] = trace["busy_us_per_cycle"] / 1e3
    out["window_ms"] = trace["window_us_per_cycle"] / 1e3
    out["kernels_per_step"] = kernel_device_ms(trace, groups)
    out["top_kernels"] = trace["kernels"][:12]
    print(f"{tag} gradients and one traced step: grads on {len(norms)} leaves, min norm "
          f"{out['grad_norm_min']:.3e}, layer 0 {json.dumps(out['grad_norms_layer0'])}; idle "
          f"share {out['idle_share']:.4f}, {json.dumps(out['kernels_per_step'])}", flush=True)
    print(f"{tag} step ms {step_ms:.1f} (floor {floor_ms:.1f}, share {out['floor_share']:.3f}), "
          f"peak {peak / 1e9:.1f} GB, launches a step {json.dumps(out['launches_a_step'])}",
          flush=True)
    del state, batch, step
    return out


def full_width_training(torch, dev, fails: list) -> dict:
    """L2; appends to ``fails``."""
    return train_full_width(
        torch, dev, fails, tag="L2", config=STABLELM,
        # a call of each a layer a microbatch; the backward launches 3 a call
        launches_a_step=lambda cfg, micro: {"flash_attention": cfg.n_layers * micro,
                                            "flash_attention_bwd": 3 * cfg.n_layers * micro},
        layer0=("attn/wq", "attn/wk", "attn/wv"), groups=FLASH_KERNELS)


def restart_on_card(torch, dev, fails: list) -> dict:
    """L3; appends to ``fails``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.train.fault_tolerance import FailureInjector
    from repro_torch.train.train_loop import Trainer

    cfg = get_config(STABLELM).with_updates(n_layers=RESTART_LAYERS)
    model = build_model(cfg, dev)
    build = pathlib.Path(__file__).resolve().parents[1] / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_lm_restart_", dir=build)
    try:
        base = RunConfig(model=cfg, shape=ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
                         optimizer=OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=100),
                         steps=RESTART_STEPS, log_every=1)
        clean = Trainer(model, base).run()
        faulty_cfg = dataclasses.replace(base, checkpoint_dir=root,
                                         checkpoint_every=RESTART_EVERY, keep_checkpoints=1)
        t0 = time.perf_counter()
        faulty = Trainer(model, faulty_cfg,
                         injector=FailureInjector(fail_at_steps=(RESTART_FAIL,))).run()
        faulty_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # restored at step 4: steps 0-3 ran, then 4 and 5 again from the checkpoint
    rel = (max(abs(a - b) / abs(b) for a, b in zip(faulty.losses, clean.losses))
           if len(faulty.losses) == len(clean.losses) else math.inf)
    out = dict(layers=RESTART_LAYERS, steps=RESTART_STEPS, fail_at=RESTART_FAIL,
               every=RESTART_EVERY, clean_losses=clean.losses, faulty_losses=faulty.losses,
               restarts=faulty.restarts, max_rel_diff=rel,
               bitwise=faulty.losses == clean.losses and faulty.checksum == clean.checksum,
               checksum_clean=clean.checksum, checksum_faulty=faulty.checksum,
               faulty_run_s=faulty_s)
    if faulty.restarts != 1 or rel > 1e-3:
        fails.append(f"L3: {out}")
    print(f"L3 restart on the card: {json.dumps(out)}", flush=True)
    return out


def kernels_without_backward_refuse(torch, dev, fails: list) -> dict:
    """L4; appends to ``fails``."""
    from repro_torch.kernels.flash_attention.flash import flash_attention
    from repro_torch.kernels.pack.pack import copy_convert, gather_pack, segment_table
    from repro_torch.kernels.stencil27.stencil27 import stencil27

    blk = torch.randn((1, 6, 6, 6), device=dev, requires_grad=True)
    q = torch.randn((1, 8, 2, 64), device=dev, requires_grad=True)
    table = segment_table(((0, (0, 0, 0), (1, 6, 6)),), (6, 6, 6), dev)  # one x-face
    calls = {
        "copy_convert": lambda: copy_convert(blk, torch.empty((1, 6, 6, 6), device=dev)),
        "gather_pack": lambda: gather_pack(blk, table, torch.empty((1, 36), device=dev)),
        "stencil27": lambda: stencil27(blk, torch.ones((3, 3, 3), device=dev),
                                       torch.empty((1, 4, 4, 4), device=dev)),
        "flash_attention": lambda: flash_attention(q, q, q),
    }
    out = {}
    for what, call in calls.items():
        try:
            call()
            out[what] = "returned"
            fails.append(f"L4: {what} returned an output without a graph instead of raising")
        except NotImplementedError as e:
            out[what] = str(e)
        with torch.no_grad():  # serving and the exchanges: the kernel alone
            call()
    print(f"L4 kernels without a backward refuse a gradient: {json.dumps(out)}", flush=True)
    return out


def train_phase(torch, dev, phases=("L1", "L2", "L3", "L4")) -> dict:
    """Phase L; raises :class:`PhaseFailure` after printing everything
    when a check fails."""
    fails: list[str] = []
    out: dict = {}
    steps = {"L1": backward_checks, "L2": full_width_training, "L3": restart_on_card,
             "L4": kernels_without_backward_refuse}
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
    ap.add_argument("--phases", default="L1,L2,L3,L4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_lm: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
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
        out = train_phase(torch, torch.device("cuda", 0), tuple(args.phases.split(",")))
    except PhaseFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    out_dir = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "train_lm.json").write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
