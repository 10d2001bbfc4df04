"""Phase O of ``chip_smoke.py``: the dry-run against the card.

* O1, the meta routes of the four LM kernels against the kernels on the
  card, through the same calls (``ops.attention`` and ``ops.wkv`` under
  grad: ``FlashAttentionFn``, ``WkvChunkedFn``): the flash forward and
  backward at stablelm-1.6b's training shape (1, 4096, 32, 64) causal,
  llama3-8b's GQA (1, 2048, 32 on 8 heads of 128) causal and
  hubert-xlarge's D = 80 (4, 1000, 16, 80) non-causal, bf16; the WKV
  forward and backward at rwkv6-1.6b's (1, 4096, 32, 64) f32, chunk 64.
  The meta outputs (the saved LSE and chunk-entry states included) must
  have the real outputs' shapes and dtypes, the meta run must launch
  nothing, and the FLOPs it counts must equal the bound's
  (``kernels/costs.py``).  Since the meta routes and the bounds share
  ``kernels/costs.py``, that equality checks the shapes a route hands its
  cost function; the table's own figures (``BOUND_FLOPS``, literals: the
  flash backward's 171,798,691,840 and the WKV backward's 7,335,837,696
  at the training shapes, ``PERF.md`` §6) are held exactly too.
* O2, ``dryrun.run_cell("stablelm-1.6b", "train_4k", False)`` on the
  ``(16, 16)`` meta mesh: the record, its H100 roofline terms
  (``comm_analysis.roofline(hw=H100)``) and the seconds it took.
* O3, the dry-run of phase L2's own configuration (one device, 2 x 4096
  tokens in 2 microbatches, bf16 weights, f32 moments, the ``Trainer``'s
  step without a mesh) against L2's measurements: the argument bytes,
  each leaf rounded up to the caching allocator's 512-byte blocks, equal
  to ``torch.cuda.memory_allocated()`` of L2's placed state and batch,
  exactly; the predicted peak (arguments + the most bytes live at once
  of what the step made) within ``OWN_PEAK_TOL`` of L2's own peak (its
  ``max_memory_allocated`` less what earlier phases left allocated when
  it started) and within ``PEAK_TOL`` of the whole ``max_memory_allocated``;
  the roofline step time printed beside L2's ms a step (not held).

``chip_smoke.py`` calls :func:`dryrun_phase` after phase N, handing it
L2's record; alone (it runs L2 first)::

    PYTHONPATH=src python3 tools/dryrun_lm.py [--phases O1,O2,O3]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import train_lm
from train_lm import PhaseFailure

#: O3: |predicted peak - L2's own peak| / L2's own peak, L2's own peak
#: being its max_memory_allocated less what was allocated when it started.
#: Sound runs read 1.1e-6 to 1.7e-3 (NVIDIA H100 80GB HBM3, 700 W); 1 % of
#: L2's 39.8 GB is 0.4 GB, an eighth of one bf16 copy of its 1.644 B weights
OWN_PEAK_TOL = 0.01
#: O3: the same against the whole max_memory_allocated, where earlier
#: phases' tensors (5.8 GB when L2 starts in chip_smoke.py) count too
PEAK_TOL = 0.25
#: the caching allocator's smallest block: every allocation is a multiple
ALLOC_BLOCK = 512
#: O1: (label, kernel, shape, causal); flash (B, S, Hq, Hkv, D), wkv (B, T, H, hd, chunk)
ROUTE_CASES = (
    ("flash (1, 4096, 32, 64) causal bf16", "flash", (1, 4096, 32, 32, 64), True),
    ("flash GQA (1, 2048, 32/8, 128) causal bf16", "flash", (1, 2048, 32, 8, 128), True),
    ("flash D=80 (4, 1000, 16, 80) non-causal bf16", "flash", (4, 1000, 16, 16, 80), False),
    ("wkv (1, 4096, 32, 64) f32 chunk 64", "wkv", (1, 4096, 32, 64, 64), None),
)
#: O1: the bound's FLOPs at the training shapes, as PERF.md §2 and §6 give them
BOUND_FLOPS = {"flash (1, 4096, 32, 64) causal bf16": {"flash_attention_bwd": 171_798_691_840},
               "wkv (1, 4096, 32, 64) f32 chunk 64": {"wkv_chunked_bwd": 7_335_837_696}}


def _signature(tensors) -> list:
    return [(tuple(t.shape), str(t.dtype)) for t in tensors]


def _flash_run(torch, dev, shape, causal, seed=0):
    """The flash forward (through ``ops.attention`` under grad) and its
    backward on ``dev``: [out, lse, dq, dk, dv]."""
    from repro_torch.kernels.flash_attention.ops import attention

    b, s, hq, hkv, d = shape
    if dev.type == "meta":
        mk = lambda *sh: torch.empty(sh, dtype=torch.bfloat16, device=dev)  # noqa: E731
    else:
        gen = torch.Generator(dev).manual_seed(seed)
        mk = lambda *sh: torch.randn(sh, generator=gen, device=dev).bfloat16()  # noqa: E731
    q, k, v = (mk(b, s, h, d).requires_grad_() for h in (hq, hkv, hkv))
    dout = mk(b, s, hq, d)
    out = attention(q, k, v, causal=causal)
    lse = out.grad_fn.saved_tensors[4]
    return [out, lse, *torch.autograd.grad(out, (q, k, v), dout)]


def _wkv_run(torch, dev, shape, seed=0):
    """The WKV forward (through ``ops.wkv`` under grad) and its backward on
    ``dev``: [y, S_fin, states, dr, dk, dv, dlw, du]."""
    from repro_torch.kernels.wkv.ops import wkv

    b, T, h, hd, c = shape
    if dev.type == "meta":
        mk = lambda *sh: torch.empty(sh, device=dev)  # noqa: E731
    else:
        gen = torch.Generator(dev).manual_seed(seed)
        mk = lambda *sh: torch.randn(sh, generator=gen, device=dev) * 0.5  # noqa: E731
    r, k, v = (mk(b, T, h, hd).requires_grad_() for _ in range(3))
    lw = (-torch.exp(mk(b, T, h, hd))).detach().requires_grad_()
    u = mk(h, hd).requires_grad_()
    y, S = wkv(r, k, v, lw, u, chunk=c)
    states = y.grad_fn.saved_tensors[5]
    return [y, S, states, *torch.autograd.grad(y, (r, k, v, lw, u), mk(b, T, h, hd))]


def meta_routes(torch, dev, fails: list) -> dict:
    """O1; appends to ``fails``."""
    from repro_torch.core.comm_analysis import count_cost
    from repro_torch.kernels import _build, costs

    out: dict = {}
    meta = torch.device("meta")
    for label, kind, shape, causal in ROUTE_CASES:
        if kind == "flash":
            b, s, hq, hkv, d = shape
            real = _flash_run(torch, dev, shape, causal)
            _build.reset_launches()
            st = count_cost(_flash_run, torch, meta, shape, causal)
            want = {"flash_attention": costs.flash_cost(b, s, hq, s, hkv, d, causal=causal,
                                                        itemsize=2, lse=True)[0],
                    "flash_attention_bwd": costs.flash_bwd_cost(b, s, hq, s, hkv, d,
                                                                causal=causal, itemsize=2)[0]}
        else:
            b, T, h, hd, c = shape
            real = _wkv_run(torch, dev, shape)
            _build.reset_launches()
            st = count_cost(_wkv_run, torch, meta, shape)
            want = {"wkv_chunked": costs.wkv_cost(b, T, h, hd, c, itemsize=4, u_numel=h * hd,
                                                  states=True)[0],
                    "wkv_chunked_bwd": costs.wkv_bwd_cost(b, T, h, hd, c, itemsize=4,
                                                          u_numel=h * hd)[0]}
        torch.cuda.synchronize()
        got = {k: v["flops"] for k, v in st.kernels.items()}
        case = dict(shape=list(shape), outputs=_signature(real),
                    meta_outputs=_signature(st.result),
                    meta_devices=sorted({t.device.type for t in st.result}),
                    meta_launches=dict(_build.LAUNCHES), counted_flops=got, bound_flops=want,
                    calls={k: v["calls"] for k, v in st.kernels.items()},
                    counted_bytes={k: v["bytes"] for k, v in st.kernels.items()})
        table = BOUND_FLOPS.get(label, {})
        case["table_flops"] = table
        ok = (case["outputs"] == case["meta_outputs"] and case["meta_devices"] == ["meta"]
              and not case["meta_launches"] and got == want
              and all(got[k] == v for k, v in table.items()))
        case["ok"] = ok
        if not ok:
            fails.append(f"O1 {label}: {json.dumps(case)}")
        print(f"O1 {label}: {json.dumps(case)}", flush=True)
        out[label] = case
        del real, st
        torch.cuda.empty_cache()
    return out


def production_cell(torch, dev, fails: list) -> dict:
    """O2; appends to ``fails``."""
    from repro_torch.configs import get_config
    from repro_torch.core.comm_analysis import H100, roofline
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_cell("stablelm-1.6b", "train_4k", False)
    seconds = time.perf_counter() - t0
    cfg = get_config("stablelm-1.6b")
    full = rec["full"]
    terms = roofline(hlo_flops_per_device=full["flops"], hlo_bytes_per_device=full["bytes"],
                     wire_bytes_per_device=full["wire_bytes"],
                     model_flops_global=cfg.model_flops_per_token(4096) * 256 * 4096,
                     n_chips=rec["n_devices"], hw=H100)
    out = dict(record=rec, seconds=seconds, roofline=dict(
        compute_s=terms.compute_s, memory_s=terms.memory_s, collective_s=terms.collective_s,
        bottleneck=terms.bottleneck, step_time_s=terms.step_time_s,
        useful_flops_ratio=terms.useful_flops_ratio, mfu_bound=terms.mfu_bound, hw=H100.name))
    if not (full["flops"] > 0 and full["bytes"] > 0 and rec["n_devices"] == 256):
        fails.append(f"O2: record {json.dumps(full)}")
    print(f"O2 stablelm-1.6b train_4k on the (16, 16) meta mesh: {json.dumps(rec)}", flush=True)
    print(f"O2 H100 roofline a device: {json.dumps(out['roofline'])}; the cell took "
          f"{seconds:.1f} s", flush=True)
    return out


def l2_config(torch, dev, fails: list, l2: dict) -> dict:
    """O3; appends to ``fails``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig, ShapeConfig
    from repro_torch.core.comm_analysis import H100, count_cost, roofline
    from repro_torch.models.api import batch_spec, build_model
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import init_state, make_train_step

    cfg = get_config(train_lm.STABLELM)
    model = build_model(cfg, "meta")
    opt = OptimizerConfig()
    state = init_state(model, opt, "meta")
    batch = batch_spec(cfg, ShapeConfig("chip", train_lm.TRAIN_SEQ, train_lm.TRAIN_BATCH,
                                        "train"))
    micro = l2.get("microbatches", cfg.train_microbatches)
    t0 = time.perf_counter()
    st = count_cost(make_train_step(model, opt, microbatches=micro), state, batch)
    seconds = time.perf_counter() - t0
    leaves = [t for _, t in tree_leaves(state)] + list(batch.values())
    argument = sum(t.numel() * t.element_size() for t in leaves)
    allocated = sum(-(-t.numel() * t.element_size() // ALLOC_BLOCK) * ALLOC_BLOCK
                    for t in leaves)
    peak = argument + st.peak_bytes
    tokens = train_lm.TRAIN_SEQ * train_lm.TRAIN_BATCH
    terms = roofline(hlo_flops_per_device=st.flops, hlo_bytes_per_device=st.bytes,
                     wire_bytes_per_device=0.0,
                     model_flops_global=cfg.model_flops_per_token(train_lm.TRAIN_SEQ) * tokens,
                     n_chips=1, hw=H100)
    out = dict(
        microbatches=micro, seconds=seconds, flops=st.flops, bytes=st.bytes,
        kernels=st.kernels, argument=argument, argument_allocated=allocated,
        l2_state_batch_allocated=l2.get("state_batch_allocated"), temp=st.peak_bytes,
        peak=peak, l2_max_memory_allocated=l2.get("max_memory_allocated"),
        roofline_step_ms=terms.step_time_s * 1e3, compute_ms=terms.compute_s * 1e3,
        memory_ms=terms.memory_s * 1e3, bottleneck=terms.bottleneck,
        useful_flops_ratio=terms.useful_flops_ratio, l2_step_ms=l2.get("step_ms"))
    l2_peak = out["l2_max_memory_allocated"]
    out["peak_rel_err"] = abs(peak - l2_peak) / l2_peak if l2_peak else None
    # beside it, L2's own peak: what earlier phases left allocated taken out
    at_start = l2.get("allocated_at_start")
    out["l2_allocated_at_start"] = at_start
    out["l2_own_peak_rel_err"] = (abs(peak - (l2_peak - at_start)) / (l2_peak - at_start)
                                  if l2_peak and at_start is not None else None)
    if allocated != out["l2_state_batch_allocated"]:
        fails.append(f"O3: argument bytes {allocated} (allocator blocks; {argument} exact), "
                     f"L2's placed state and batch {out['l2_state_batch_allocated']}")
    if out["l2_own_peak_rel_err"] is None or out["l2_own_peak_rel_err"] > OWN_PEAK_TOL:
        fails.append(f"O3: predicted peak {peak}, L2's own {l2_peak} - {at_start} "
                     f"(tol {OWN_PEAK_TOL})")
    if out["peak_rel_err"] is None or out["peak_rel_err"] > PEAK_TOL:
        fails.append(f"O3: predicted peak {peak}, L2's {l2_peak} (tol {PEAK_TOL})")
    print(f"O3 the dry-run of L2's configuration: {json.dumps(out)}", flush=True)
    print(f"O3 arguments {allocated} bytes in allocator blocks ({argument} exact) against L2's "
          f"{out['l2_state_batch_allocated']}; peak {peak / 1e9:.2f} GB predicted against "
          f"L2's {l2_peak / 1e9 if l2_peak else float('nan'):.2f} GB "
          f"(rel {out['peak_rel_err']}; {at_start} bytes allocated before L2, rel to L2's own "
          f"{out['l2_own_peak_rel_err']}); roofline step {out['roofline_step_ms']:.1f} ms "
          f"({out['bottleneck']}) beside L2's {out['l2_step_ms']} ms", flush=True)
    return out


def dryrun_phase(torch, dev, l2: dict, phases=("O1", "O2", "O3")) -> dict:
    """Phase O; raises :class:`train_lm.PhaseFailure` after printing
    everything when a check fails."""
    import gc

    fails: list[str] = []
    out: dict = {}
    steps = {"O1": meta_routes, "O2": production_cell,
             "O3": lambda t, d, f: l2_config(t, d, f, l2)}
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
    ap.add_argument("--phases", default="O1,O2,O3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dryrun_lm: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
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
    dev = torch.device("cuda", 0)
    phases = tuple(args.phases.split(","))
    try:
        l2 = (train_lm.train_phase(torch, dev, ("L2",))["L2"] if "O3" in phases else {})
        out = dryrun_phase(torch, dev, l2, phases)
    except PhaseFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    out_dir = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "dryrun_lm.json").write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
