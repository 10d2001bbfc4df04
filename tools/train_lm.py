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
  that (its delta pre-pass, dK/dV and dQ kernels).  Prints ms a step (median of steps 2-5), tokens/s, the step's share
  of its floor (``model_flops_per_token(4096)`` x 8192 tokens over 989
  TFLOP/s dense bf16), ``torch.cuda.max_memory_allocated``, the device idle
  share of one step (``core/profiling.py``) and the flash forward and
  backward device ms a step.  Every loss must be finite, and one
  microbatch's gradients on a fresh state (``torch.autograd.grad`` of
  ``Model.loss``) must have a finite, non-zero norm on every parameter
  leaf, ``wq``/``wk``/``wv`` included.
* L3, restart on the card: stablelm-1.6b's width with 2 layers, 6 steps,
  a checkpoint every 2 (5.1 GB each, the latest one kept, in a temporary
  directory under ``build/`` removed after), an
  injected failure at step 4; the restarted run restores step 4 (so it
  logs 6 losses), finishes, and its losses are within 1e-3 relative of an
  uninterrupted run's; whether they and the final checksum are bitwise
  equal is printed (the flash backward has no atomics).
* L4, rwkv6-1.6b refuses: ``Model.loss`` raises ``NotImplementedError``,
  and ``logits`` with parameters that require grad raises in the
  ``wkv_chunked`` wrapper, instead of returning a graph without the WKV
  edges.

``chip_smoke.py`` calls :func:`train_phase` last, after phase G; alone::

    PYTHONPATH=src python3 tools/train_lm.py [--phases L1,L2,L3,L4]
"""

from __future__ import annotations

import argparse
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
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 2, 6, 2, 4
#: (label, (B, Sq, Hq, Hkv, D, Skv), dtype, causal); Skv None: Sq
BWD_CASES = (
    ("stablelm-1.6b training shape", (2, 4096, 32, 32, 64, None), "bfloat16", True),
    ("llama3-8b GQA", (1, 2048, 32, 8, 128, None), "bfloat16", True),
    ("hubert-xlarge encoder, D=80, non-causal", (4, 1000, 16, 16, 80, None), "bfloat16", False),
    ("ragged Sq != Skv, GQA (CUDA-core forward)", (2, 300, 8, 4, 64, 200), "float32", True),
    ("no key: every row fully masked (CUDA-core forward)", (1, 70, 4, 2, 64, 0), "float32",
     True),
)
#: the training path's attention shape, one sequence a microbatch
PATH_SHAPE = (1, 4096, 32, 32, 64)


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


def bwd_flops(b: int, sq: int, hq: int, skv: int, d: int, causal: bool) -> float:
    """Operations of the backward counted from shapes: five products of
    ``2 * B * Hq * Sq * Skv * D`` (P recomputed, dV, dP, dK, dQ), half of the
    tiles where causal."""
    return 5 * 2 * b * hq * sq * skv * d * (0.5 if causal else 1.0)


def backward_checks(torch, dev, fails: list) -> dict:
    """L1; appends to ``fails``."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
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
        # the backward's delta pre-pass, dK/dV and dQ; dK/dV skipped with no key
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
    flops = bwd_flops(b, s, hq, s, d, True)
    nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
    out["path"] = dict(
        shape=list(PATH_SHAPE), dtype="bfloat16", causal=True,
        ms=events_ms(torch, lambda: flash_attention_bwd(q, k, v, od, dout, lse, causal=True)),
        plain_ms=events_ms(torch, lambda: torch.autograd.grad(plain, (qp, kp, vp), dout,
                                                              retain_graph=True), reps=3),
        library_ms=events_ms(torch, lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dout_t,
                                                                retain_graph=True)),
        bound_ms=max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S else "bytes",
        flops=flops, bytes=nbytes,
        flop_convention="5 products x 2*B*Hq*Sq*Skv*D, halved (causal)",
        timing="CUDA events around one call, median of 5 (plain: 3) after a warm-up; ms the "
               "kernel alone, plain_ms and library_ms autograd's backward of attention_plain "
               "and of F.scaled_dot_product_attention on (B, H, S, D) copies")
    del plain, sdpa
    dq, dk, dv = flash_attention_bwd(q, k, v, od, dout, lse, causal=True)
    dq2, dk2, dv2 = flash_attention_bwd(q, k, v, od, dout, lse, causal=True)
    out["path"]["bitwise_repeatable"] = bool(torch.equal(dq, dq2) and torch.equal(dk, dk2)
                                             and torch.equal(dv, dv2))
    if not out["path"]["bitwise_repeatable"]:
        fails.append("L1: two backward calls on the same inputs differ")
    print(f"L1 backward at the training path's shape: {json.dumps(out['path'])}", flush=True)
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


def _flash_device_ms(trace: dict) -> dict:
    """Device ms a step of the flash forward (either route's kernel) and of
    the backward's three kernels, from a ``device_breakdown`` trace."""
    fwd = ("flash_tc_kernel", "flash_kernel")
    bwd = ("delta_kernel", "dkdv_tc_kernel", "dq_tc_kernel", "dkdv_kernel", "dq_kernel")
    out = {"fwd_ms": 0.0, "bwd_ms": 0.0, "fwd_launches": 0.0, "bwd_launches": 0.0}
    for k in trace["kernels"]:
        for tag, names in (("fwd", fwd), ("bwd", bwd)):
            if any(n in k["name"] for n in names):
                out[f"{tag}_ms"] += k["us_per_cycle"] / 1e3
                out[f"{tag}_launches"] += k["launches_per_cycle"]
    return out


def full_width_training(torch, dev, fails: list) -> dict:
    """L2; appends to ``fails``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import Trainer, init_state, make_train_step

    cfg = get_config(STABLELM)
    model = build_model(cfg, dev)
    opt = OptimizerConfig()
    run_cfg = RunConfig(model=cfg, shape=ShapeConfig("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
                        optimizer=opt, steps=TRAIN_STEPS, log_every=1)
    trainer = Trainer(model, run_cfg)
    micro = trainer.microbatches
    if micro != cfg.train_microbatches:
        fails.append(f"L2: the Trainer took {micro} microbatches, the config says "
                     f"{cfg.train_microbatches}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    want = cfg.n_layers * micro * TRAIN_STEPS  # calls of each; the backward launches 3 a call
    out = dict(
        config=STABLELM, params=cfg.param_count(), seq=TRAIN_SEQ, batch=TRAIN_BATCH,
        microbatches=micro, steps=TRAIN_STEPS, losses=result.losses,
        step_ms_each=[s * 1e3 for s in result.step_seconds], step_ms=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3), model_flops=flops, floor_ms=floor_ms,
        floor_share=floor_ms / step_ms, max_memory_allocated=peak, wall_s=wall,
        launches=launches, launches_want=want,
        timing="host clock around each Trainer step, ending with the loss read back; "
               "step_ms the median of steps 2-5 (1-based)")
    if not all(math.isfinite(x) for x in result.losses) or len(result.losses) != TRAIN_STEPS:
        fails.append(f"L2: losses {result.losses}")
    if (launches.get("flash_attention") != want
            or launches.get("flash_attention_bwd") != 3 * want):
        fails.append(f"L2: launches {launches}, want {want} forward and {3 * want} backward "
                     f"(delta, dK/dV, dQ a call)")
    print(f"L2 stablelm-1.6b Trainer, 6 steps: {json.dumps(out)}", flush=True)

    # one fresh state: every leaf's gradient, and one step's device trace
    state = init_state(model, opt, run_cfg.seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ).batch_at(0).items()}
    leaves = [(path, p.requires_grad_(True)) for path, p in tree_leaves(state["params"])]
    loss = model.loss(state["params"], {k: v[:1] for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    norms = {"/".join(map(str, path)): g.float().norm().item()
             for (path, _), g in zip(leaves, grads)}
    del grads, loss
    bad = {k: v for k, v in norms.items() if not (math.isfinite(v) and v > 0)}
    out["grad_leaves"] = len(norms)
    out["grad_norm_min"] = min(norms.values())
    out["grad_norm_wq_wk_wv_layer0"] = [norms[f"layers/0/attn/{w}"] for w in ("wq", "wk", "wv")]
    if bad:
        fails.append(f"L2: leaves without a finite non-zero gradient: {sorted(bad)[:8]}")
    step = make_train_step(model, opt, microbatches=micro)
    trace = device_breakdown(lambda: step(state, batch), n_cycles=1)
    out["idle_share"] = trace["idle_share"]
    out["trace_sessions"] = trace["sessions"]
    out["busy_ms"] = trace["busy_us_per_cycle"] / 1e3
    out["window_ms"] = trace["window_us_per_cycle"] / 1e3
    out["flash_per_step"] = _flash_device_ms(trace)
    out["top_kernels"] = trace["kernels"][:12]
    print(f"L2 gradients and one traced step: grads on {len(norms)} leaves, min norm "
          f"{out['grad_norm_min']:.3e}; idle share {out['idle_share']:.4f}, "
          f"{json.dumps(out['flash_per_step'])}", flush=True)
    del state, batch, leaves, step
    return out


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


def rwkv_refuses(torch, dev, fails: list) -> dict:
    """L4; appends to ``fails``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import tree_leaves

    model = build_model(get_config("rwkv6-1.6b").reduced(), dev)
    params = model.init(0)
    for _, p in tree_leaves(params):
        p.requires_grad_(True)
    tokens = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    out = {}
    for what, call in (("loss", lambda: model.loss(params, {"tokens": tokens, "labels": tokens})),
                       ("logits with grad", lambda: model.logits(params, {"tokens": tokens}))):
        try:
            call()
            out[what] = "returned"
            fails.append(f"L4: rwkv6-1.6b {what} returned instead of raising")
        except NotImplementedError as e:
            out[what] = str(e)
    with torch.no_grad():  # serving stays on the kernel
        out["logits_no_grad_shape"] = list(model.logits(params, {"tokens": tokens}).shape)
    print(f"L4 rwkv6-1.6b refuses: {json.dumps(out)}", flush=True)
    return out


def train_phase(torch, dev, phases=("L1", "L2", "L3", "L4")) -> dict:
    """Phase L; raises :class:`PhaseFailure` after printing everything
    when a check fails."""
    import gc

    fails: list[str] = []
    out: dict = {}
    steps = {"L1": backward_checks, "L2": full_width_training, "L3": restart_on_card,
             "L4": rwkv_refuses}
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
