"""Phase A's head dims 16 and 32 in ``chip_smoke.py``: the flash kernels
(``flash_attention`` and ``flash_attention_bwd``) on the 64-wide tile
zero-filled past D, against their plain version, and timed.

* Checks, at D = 16 and 32, bf16 (the tensor-core route) and f32 (the
  CUDA-core route), causal and not, at a ragged ``(2, 300 queries, 200
  keys)`` and a square ``(2, 256)`` shape with GQA 4 query heads on 2 kv
  heads, at every shape phase P gives the kernel at that head dim
  (``PATH_SHAPES``) and at the long timed one (2 x 4096 tokens, 8 heads
  on 4): the forward within ``FWD_TOL`` (rtol = atol) of ``attention_plain`` on
  the same inputs, ``dq``, ``dk``, ``dv`` (through ``FlashAttentionFn``)
  within relative L2 ``BWD_TOL`` of autograd through ``attention_plain``
  in f32 on the same inputs (the tolerances of phase A's other rows and of
  ``tests/test_torch_train_cuda.py``).
* Timed, bf16 causal, per dim: the main path's shape (D = 16: the
  quickstart example's training attention, a microbatch of 2 x 32 tokens,
  4 heads on 2; D = 32: serve_batched's prefill bucket of 32 tokens, 4
  heads) and a long
  one (2 x 4096 tokens, 8 heads on 4): CUDA events around one call (median
  of 7, the wrapper's host time inside; ``ms``), the plain version's,
  ``F.scaled_dot_product_attention``'s (its backward by autograd, a graph
  kept) and the bound from ``kernels/costs.flash_cost`` /
  ``flash_bwd_cost`` at the card's bf16 peak and HBM rate.

``chip_smoke.py`` calls :func:`head_dim_phase` in phase A; alone::

    PYTHONPATH=src python3 tools/flash_head_dims.py
"""

from __future__ import annotations

import json
import pathlib
import sys

from time_copy_convert import events_ms

HEAD_DIMS = (16, 32)
FWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: (b, sq, skv, hq, hkv) checked at each head dim besides the ones below:
#: a ragged shape and a square one
CHECK_SHAPES = ((2, 300, 200, 4, 2), (2, 256, 256, 4, 2))
#: (b, s, hq, hkv) of every flash call phase P makes, by head dim (the
#: examples at their defaults): D = 16, quickstart's 8-token prefill
#: bucket and its training microbatch, long_context_ring's zamba2 loss at
#: 512 and 4096 tokens (4 sequences of a quarter); D = 32, serve_batched's
#: prefill buckets of 8, 16 and 32 tokens.  ``tests/test_torch_examples.py``
#: holds this list against the calls the examples make.
PATH_SHAPES = {16: ((1, 8, 4, 2), (2, 32, 4, 2), (4, 128, 4, 4), (4, 1024, 4, 4)),
               32: ((1, 8, 4, 4), (1, 16, 4, 4), (1, 32, 4, 4))}
LONG = (2, 4096, 8, 4)
#: per head dim: the main path's shape and a long one, (b, s, hq, hkv)
TIMED = {16: {"path": (2, 32, 4, 2), "long": LONG}, 32: {"path": (1, 32, 4, 4), "long": LONG}}
BF16_FLOP_PER_S, HBM_BYTES_PER_S = 989e12, 3.35e12


def _rel(torch, got, want) -> float:
    den = want.double().norm().item()
    err = (got.double() - want.double()).norm().item()
    return err / den if den else err


def _bound(flops: int, nbytes: int) -> tuple[float, str]:
    ops, mem = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(ops, mem) * 1e3, "operations" if ops > mem else "bytes"


def checked_shapes(d: int) -> tuple:
    """(b, sq, skv, hq, hkv) of every check at head dim ``d``."""
    return CHECK_SHAPES + tuple((b, s, s, hq, hkv) for b, s, hq, hkv in (*PATH_SHAPES[d], LONG))


def checks(torch, dev, fails: list) -> dict:
    """The forward and backward against the plain version; appends to
    ``fails``."""
    from repro_torch.kernels.flash_attention import attention, attention_plain, flash_attention

    gen = torch.Generator(dev).manual_seed(11)
    cases, worst_fwd, worst_bwd = [], 0.0, 0.0
    for d in HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            for b, sq, skv, hq, hkv in checked_shapes(d):
                for causal in (True, False):
                    q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype)
                    k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=dev).to(dtype)
                            for _ in range(2))
                    dout = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dtype)
                    got = flash_attention(q, k, v, causal=causal)
                    want = attention_plain(q, k, v, causal=causal)
                    fwd_err = (got.float() - want.float()).abs().max().item()
                    fwd_ok = bool(torch.isfinite(got.float()).all()) and torch.allclose(
                        got.float(), want.float(), rtol=FWD_TOL[name], atol=FWD_TOL[name])
                    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                    grads = torch.autograd.grad(attention(qg, kg, vg, causal=causal),
                                                (qg, kg, vg), dout)
                    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
                    ref = torch.autograd.grad(attention_plain(q32, k32, v32, causal=causal),
                                              (q32, k32, v32), dout.float())
                    torch.cuda.synchronize()
                    bwd = [_rel(torch, g.float(), r) for g, r in zip(grads, ref)]
                    bwd_ok = all(torch.isfinite(g.float()).all() for g in grads) and max(
                        bwd) <= BWD_TOL[name]
                    case = dict(d=d, dtype=name, shape=[b, sq, skv, hq, hkv], causal=causal,
                                fwd_max_abs_err=fwd_err, fwd_tol=FWD_TOL[name],
                                bwd_rel_l2={"dq": bwd[0], "dk": bwd[1], "dv": bwd[2]},
                                bwd_tol=BWD_TOL[name], ok=bool(fwd_ok and bwd_ok))
                    print(f"A flash D={d} {name} {case['shape']} causal={causal}: "
                          f"{json.dumps(case)}", flush=True)
                    if not case["ok"]:
                        fails.append(f"flash D={d}: {case}")
                    worst_fwd, worst_bwd = max(worst_fwd, fwd_err), max(worst_bwd, *bwd)
                    cases.append(case)
    return dict(cases=cases, fwd_max_abs_err=worst_fwd, bwd_max_rel_l2=worst_bwd)


def timings(torch, dev) -> dict:
    """bf16 causal timings per head dim (module docstring)."""
    import torch.nn.functional as F

    from repro_torch.kernels.costs import flash_bwd_cost, flash_cost
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.flash_attention.flash import flash_attention, flash_attention_bwd

    def none():
        return None

    gen = torch.Generator(dev).manual_seed(12)
    out: dict = {}
    for d in HEAD_DIMS:
        for tag, (b, s, hq, hkv) in TIMED[d].items():
            q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
            k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).bfloat16()
                    for _ in range(2))
            dout = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
            lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
            o = flash_attention(q, k, v, causal=True, lse=lse)
            qt, kt, vt = (t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=hq != hkv)
            dout_t = dout.transpose(1, 2)
            q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
            plain = attention_plain(q32, k32, v32, causal=True)

            with torch.no_grad():
                fwd = dict(
                    ms=events_ms(torch, lambda: flash_attention(q, k, v, causal=True), none),
                    plain_ms=events_ms(torch, lambda: attention_plain(q, k, v, causal=True),
                                       none),
                    library_ms=events_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=hq != hkv), none))
            flops, nbytes = flash_cost(b, s, hq, s, hkv, d, causal=True, itemsize=2)
            fwd["bound_ms"], fwd["bound_by"] = _bound(flops, nbytes)
            bwd = dict(
                ms=events_ms(torch, lambda: flash_attention_bwd(q, k, v, o, dout, lse,
                                                                causal=True), none),
                plain_ms=events_ms(torch, lambda: torch.autograd.grad(
                    plain, (q32, k32, v32), dout.float(), retain_graph=True), none),
                library_ms=events_ms(torch, lambda: torch.autograd.grad(
                    sdpa, (qt, kt, vt), dout_t, retain_graph=True), none))
            bflops, bbytes = flash_bwd_cost(b, s, hq, s, hkv, d, causal=True, itemsize=2)
            bwd["bound_ms"], bwd["bound_by"] = _bound(bflops, bbytes)
            out[f"d{d}_{tag}"] = dict(shape=[b, s, hq, hkv, d], causal=True, dtype="bfloat16",
                                      forward=fwd, backward=bwd, flops=flops,
                                      bwd_flops=bflops)
            print(f"A flash D={d} {tag} (B, S, Hq, Hkv) = {(b, s, hq, hkv)}: "
                  f"{json.dumps(out[f'd{d}_{tag}'])}", flush=True)
            del q, k, v, dout, lse, o, qt, kt, vt, sdpa, q32, k32, v32, plain
            torch.cuda.empty_cache()
    out["timing"] = ("CUDA events around one call, median of 7 (the wrapper's host time "
                     "inside); library: F.scaled_dot_product_attention on (B, H, S, D) copies, "
                     "its backward by autograd with the graph kept; plain: attention_plain in "
                     "bf16 forward, autograd through it in f32 backward")
    return out


def head_dim_phase(torch, dev) -> dict:
    """The checks and the timings; a failed check raises ``RuntimeError``
    after everything is printed."""
    fails: list[str] = []
    out = dict(checks=checks(torch, dev, fails), timed=timings(torch, dev))
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_head_dims: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    _build.build_all(["flash_attention"])
    try:
        out = head_dim_phase(torch, torch.device("cuda", 0))
    except RuntimeError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    print(json.dumps({k: v for k, v in out.items() if k != "checks"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
