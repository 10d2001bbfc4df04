"""Phase H of ``chip_smoke.py``: the partitioned pipeline on the LM side,
sequence-parallel llama3-8b and rwkv6-1.6b on a virtual ring of 8 ranks on
one card, at full width and depth (random weights from seed 0).

* H1, llama3-8b serving under ``ParallelContext(mesh=(1, 8) over ("data",
  "model"), seq_parallel=True, comm_packer="cuda", comm_coalesce=True)``
  at ``n_parts`` 1 and 4: every prefill is ring attention, its KV hops
  through ``gather_pack`` (the coalesced K+V wire buffer) and
  ``copy_convert`` (K and V unpacked in place), counted against layers x
  (ring - 1) x rounds; tokens against the local (flash) engine, equal or a
  near tie at the first difference; both pack kernels bitwise against
  their plain versions at every KV hop the serves ran
  (:func:`kv_kernel_checks`); the 2048-token prefill's logits with packer
  ``cuda`` bitwise equal to packer ``slice``'s, and against the local
  prefill within ``RING_REL_TOL`` (relative L2 norm), which a planted
  fault (one KV block left out) must exceed; prefill times (host clock,
  in turns, the KV hop's kept plan beside one built each call) and the
  exchange's share of the ring prefill's device time (``torch.profiler``).
* H2, llama3-8b ``logits`` with ``tp_mode="ring"`` (the ring all-gather
  matmul MLP and its matmul-reduce-scatter) on a 512-token prompt against
  the local logits within ``TP_RING_REL_TOL``, which a planted fault (a
  partial product left out of every block's sum) must exceed.
* H3, rwkv6-1.6b ``logits`` at T = 2048 over the 8 ranks with
  ``state_method`` ``ring`` and ``tree`` against the local model: held in
  f32 within ``RWKV_F32_REL_TOL``, which a planted fault (no state passed
  between the segments) must exceed, reported in bf16; the same with slow
  decays (:func:`slow_decay_params`: a segment's D is O(1), where the
  random decays make it underflow), where dropping D must exceed it;
  ``state_passing`` alone at the model's state shape against a sequential
  f64 composition (:func:`state_passing_check`); ``wkv_chunked``
  launched twice a layer a call (segment operator, then the scan from the
  incoming state, every rank folded into the kernel's batch); and
  ``message_all_to_all`` bitwise against ``partitioned_all_to_all`` for
  packers ``slice`` and ``cuda``, coalesced or not, ``n_parts`` 1 and 4.

``chip_smoke.py`` calls :func:`llama_ring` inside phase B and
:func:`rwkv_ring` inside phase D, on the weights already on the card; it
is the one entry point.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time

RING = 8
H_PARTS = (1, 4)
PREFILL_LEN = 2048
TP_LEN = 512
#: H1: ||ring - local|| / ||local|| of the 2048-token prefill's last-position
#: logits (bf16 model).  The ring rounds each block's scores to bf16 before
#: its softmax, as JAX's ``_attend_block`` does, where the flash kernel
#: keeps them in f32: 32 layers carry that into the logits.  A KV block
#: left out of the last rank's attention in every layer must read above it.
RING_REL_TOL = 0.1
#: H2: ||ring TP - local|| / ||local|| of all 512 positions' logits (bf16):
#: the ring sums the 8 ranks' partial products of the down projection in
#: bf16, one rounding a hop (JAX's accumulation in the activation dtype).
#: 2.5x the sound reading of 0.0189 (NVIDIA H100 80GB HBM3, 700 W), about
#: the bf16 rounding that 32 layers carry (H1's flash against plain
#: attention reads 0.0199); a partial product left out of every block's sum
#: must read above it
TP_RING_REL_TOL = 0.05
#: H3: f32 weights, ||sequence-parallel - local|| / ||local|| of all 2048
#: positions' logits: the state composed across 8 segments (C, D products
#: and sums in f32) against one scan
RWKV_F32_REL_TOL = 1e-3
#: H3, slow decays: each channel decays at a rate drawn in this range a
#: token, so a 256-token segment's D = exp(sum lw) lies in about (0.21,
#: 0.88) and every predecessor's state reaches a segment, weighted by D
SLOW_DECAY_RATES = (5e-4, 6e-3)
#: H3, ``state_passing`` alone at rwkv6-1.6b's state, D drawn in (0.2, 1):
#: ||got - sequential f64|| / ||sequential f64|| of the incoming states
#: (f32 products and sums of at most 8 terms)
STATE_REL_TOL = 1e-5
#: a near tie of two tokens in the local engine's bf16 logits (phase B's)
TIE_TOL = 2e-2
#: exchange kernels of a ring prefill in a profiler trace
EXCHANGE_KERNELS = ("copy_convert", "gather_pack", "indexSelect")


class PhaseFailure(RuntimeError):
    """A check of phase H failed (``chip_smoke.py`` exits non-zero)."""


def ring_context(dev, **kw):
    """The ``(1, RING)`` context over ``("data", "model")`` on ``dev``."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.parallel.context import ParallelContext

    return ParallelContext(mesh=make_mesh((1, RING), ("data", "model"), device=dev), **kw)


def ring_rounds(skv: int, n_parts: int) -> int:
    """Delivery rounds a KV hop takes: the non-empty partitions of a block
    of ``skv`` rows (all-padding tail partitions are elided)."""
    from repro_torch.core.transport import Partitioner

    if n_parts <= 1:
        return 1
    return sum(1 for _, width in Partitioner(n_parts).slices(skv) if width > 0)


def expected_pack_launches(layers: int, buckets, n_parts: int) -> dict:
    """``gather_pack``/``copy_convert`` launches of coalesced ``cuda`` ring
    prefills at ``buckets``: a round packs K and V with one gather and
    unpacks each with one copy; layers x (ring - 1) hops x rounds."""
    rounds = sum(layers * (RING - 1) * ring_rounds(b // RING, n_parts) for b in buckets)
    return {"gather_pack": rounds, "copy_convert": 2 * rounds}


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def host_ms_turns(torch, fns: dict, *, rounds: int = 2) -> dict:
    """Median host ms of one call ending in a synchronize, each function
    called in turns (a, b, ..., ..., b, a) ``rounds`` times after a
    warm-up call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times: dict = {k: [] for k in fns}
    order = [*fns, *reversed(list(fns))] * rounds
    for name in order:
        t0 = time.perf_counter()
        fns[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def exchange_share(trace: dict) -> dict:
    """Device time of the exchange kernels (pack, unpack, the rank gather
    of each move) against the device-busy time of a traced call."""
    ex = sum(k["us_per_cycle"] for k in trace["kernels"]
             if any(n in k["name"] for n in EXCHANGE_KERNELS))
    return {"exchange_us": ex, "busy_us": trace["busy_us_per_cycle"],
            "share": ex / trace["busy_us_per_cycle"], "idle_share": trace["idle_share"]}


def near_ties(torch, logits_at, model, params, prompts, got_tokens, want_tokens, max_len,
              fails, labels=("ring", "local")) -> tuple:
    """Requests equal, and at each first difference the reference logits'
    gap between the two tokens (a failure above ``TIE_TOL * (1 +
    |logit|)``); ``logits_at(torch, model, params, prompt, prefix,
    max_len)`` gives the reference model's logits after ``prompt +
    prefix``; ``labels`` name the two runs (got, want)."""
    equal, ties = 0, []
    for prompt, got, want in zip(prompts, got_tokens, want_tokens):
        if got == want:
            equal += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        logits = logits_at(torch, model, params, prompt, got[:i], max_len)
        la, lb = logits[got[i]].item(), logits[want[i]].item()
        gap, tol = abs(la - lb), TIE_TOL * (1 + max(abs(la), abs(lb)))
        ties.append({"prompt_len": len(prompt), "step": i, f"{labels[0]}_token": got[i],
                     f"{labels[1]}_token": want[i], "logit_gap": gap, "tol": tol})
        if gap > tol:
            fails.append(f"prompt of {len(prompt)}: {labels[0]} tokens differ at step {i} and the "
                         f"{labels[1]} logits are {gap} apart (tol {tol}): not a near tie")
    return equal, ties


def skipped_block_fault(sq_block: int):
    """A ring block function that leaves the sequence's first KV block
    (rank 0's) out of every other rank's attention: the planted fault."""
    import torch

    from repro_torch.core import ring as ring_mod

    real = ring_mod._attend_block

    def attend(q, k, v, m, l, acc, q_off, kv_off, *, causal, scale):
        m2, l2, acc2 = real(q, k, v, m, l, acc, q_off, kv_off, causal=causal, scale=scale)
        skip = (kv_off < sq_block) & (q_off > 0)  # (R,)
        s = skip.view(-1, 1, 1, 1)
        return (torch.where(s, m, m2), torch.where(s, l, l2),
                torch.where(skip.view(-1, 1, 1, 1, 1), acc, acc2))

    return attend


def exchange_kernel_checks(torch, prepared, x, y) -> dict:
    """``gather_pack`` of every coalesced cell of the ``cuda``
    ``PreparedExchange`` ``prepared`` on the block ``x`` against
    ``gather_pack_ref``, and each of its windows unpacked by
    ``copy_convert`` into a copy of the block ``y`` against
    ``unpack_2d_ref`` (the block's other elements untouched), bitwise."""
    from repro_torch.core.transport import window
    from repro_torch.kernels.pack.pack import copy_convert, gather_pack
    from repro_torch.kernels.pack.ref import gather_pack_ref, unpack_2d_ref

    cells = packs = windows = unpacks = 0
    for cell in (c for group in prepared._groups for r in group for c in r):
        lay = cell.layout
        wire = gather_pack(x, cell.table, torch.empty_like(cell.send))
        cells += 1
        packs += torch.equal(wire, gather_pack_ref(x, lay.segments, total=lay.total,
                                                   out_dtype=wire.dtype))
        for seg in lay.segments:
            windows += 1
            buf = wire[:, seg.offset:seg.offset + seg.numel].unflatten(1, seg.shape)
            got, want = y.clone(), y.clone()
            copy_convert(buf, window(got, seg.dst_start, seg.shape))
            window(want, seg.dst_start, seg.shape).copy_(unpack_2d_ref(buf, out_dtype=y.dtype))
            unpacks += torch.equal(got, want)
    return dict(cells=cells, gather_pack_equal=packs, windows=windows,
                copy_convert_windows_equal=unpacks)


def kv_kernel_checks(torch, mesh, packers=("cuda",)) -> list[dict]:
    """``gather_pack`` and ``copy_convert`` held bitwise against their plain
    versions at the shapes the ring prefills gave them: for every coalesced
    KV hop plan of a packer in ``packers`` (the pack kernels' ``cuda``, or
    ``bf16`` on a bf16 KV, where its wire is the KV's own dtype) on
    ``mesh`` in the plan registry (one a served bucket and ``n_parts``),
    :func:`exchange_kernel_checks` on random bf16 K and V, and the whole
    hop against the ring shift of the block (rank i + 1 gets rank i's)."""
    from repro_torch.core.plan import PLANS

    g = torch.Generator(mesh.device).manual_seed(21)
    rows = []
    for key in PLANS.keys():
        if key[0] != "ring_kv" or key[1] != mesh or key[6].name not in packers or not key[8]:
            continue
        plan = PLANS._plans[key]
        ex = plan.exchange
        shape = (ex.ranks, *ex.local_shape)
        x, y = (torch.randn(shape, generator=g, device=mesh.device).to(key[4]) for _ in range(2))
        checks = exchange_kernel_checks(torch, ex, x, y)
        hop = x.clone()
        plan.start(hop)
        rows.append(dict(kv_shape=list(shape), n_parts=key[5], packer=key[6].name, **checks,
                         hop_equal=bool(torch.equal(hop, torch.roll(x, 1, 0)))))
    return rows


@contextlib.contextmanager
def kv_exchange_built_each_call():
    """Ring attention as it ran before its KV hop became a persistent plan:
    a new ``PreparedExchange`` (routes, tables, buffers) every call, for a
    timing in turns against the kept plan."""
    import types

    from repro_torch.core import ring as ring_mod
    from repro_torch.core.transport import PreparedExchange

    def build(mesh, axis_name, kv_shape, dtype, *, n_parts, packer, transport, coalesce):
        msgs = ring_mod.ring_kv_messages(kv_shape, axis_name, ring_mod.axis_size(mesh, axis_name),
                                         n_parts=n_parts)
        prepared = PreparedExchange((msgs,), mesh=mesh, local_shape=kv_shape, dtype=dtype,
                                    packer=packer, transport=transport, coalesce=coalesce)
        return types.SimpleNamespace(start=prepared.run)

    kept = ring_mod.ring_kv_plan
    ring_mod.ring_kv_plan = build
    try:
        yield
    finally:
        ring_mod.ring_kv_plan = kept


def dropped_partial_fault(x, w, mesh, axis_name, *, accum_dtype=None, transport="loopback"):
    """``ring_matmul_reduce_scatter`` with a planted fault: every block's
    sum leaves out its owner's own partial product (one of the ring's)."""
    import torch

    from repro_torch.core import partitioned as part

    t = part.resolve_transport(transport)
    k = part.axis_size(mesh, axis_name)
    dtype = accum_dtype or x.dtype
    xb = x.unflatten(1, (k, x.shape[1] // k))
    idx, rows, perm = part.axis_positions(mesh, axis_name), part._rows(mesh), part.ring_perm(k)
    acc = torch.matmul(xb[rows, (idx - 1) % k], w).to(dtype)
    for s in range(1, k):
        acc = t.permute(acc, mesh, axis_name, perm)
        if s < k - 1:
            acc = acc + torch.matmul(xb[rows, (idx - 1 - s) % k], w).to(dtype)
    return acc


def llama_ring(torch, dev, model, params, prompts, local_tokens, *, slots: int, max_len: int,
               new_tokens: int, logits_at) -> dict:
    """H1 and H2 on llama3-8b's weights already on the card (``logits_at``:
    see :func:`near_ties`); raises :class:`PhaseFailure` after printing
    everything when a check fails."""
    import numpy as np

    from repro_torch.core import ring as ring_mod
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import build_model
    from repro_torch.models import layers as layers_mod
    from repro_torch.serving.engine import ServingEngine

    cfg = model.cfg
    fails: list[str] = []
    out: dict = {"ring": RING, "n_parts": list(H_PARTS), "serve": {}}
    ctxs = {n: ring_context(dev, seq_parallel=True, n_parts=n, comm_packer="cuda",
                            comm_coalesce=True) for n in H_PARTS}
    launches_total: dict = {}
    for n, ctx in ctxs.items():
        engine = ServingEngine(model, params, max_slots=slots, max_len=max_len, ctx=ctx)
        uids = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
        _build.reset_launches()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        tokens = [done[u] for u in uids]
        buckets = [engine._prefill_bucket(len(p)) for p in prompts]
        want = expected_pack_launches(cfg.n_layers, buckets, n)
        got = {k: launches.get(k, 0) for k in want}
        st = engine.stats
        captured = [p.name for p in engine.plans._plans.values() if p.captured]
        equal, ties = near_ties(torch, logits_at, model, params, prompts, tokens, local_tokens,
                                max_len, fails)
        n_tok = sum(len(t) for t in tokens)
        row = dict(serve_s=serve_s, tokens_per_s=n_tok / serve_s, launches=launches,
                   expected=want, buckets=buckets, prefills=st.prefills,
                   plan_inits=st.plan_inits, captured=captured, equal_requests=equal,
                   near_ties=ties)
        out["serve"][n] = row
        for k, v in launches.items():
            launches_total[k] = launches_total.get(k, 0) + v
        print(f"H1 ring n_parts={n}: {st.prefills} prefills (buckets {buckets}), "
              f"{st.decode_steps} decode steps, {n_tok} tokens in {serve_s:.3f} s; plans "
              f"{st.plan_inits} inits, captured {captured}; launches {json.dumps(launches)}, "
              f"expected {json.dumps(want)} = {cfg.n_layers} layers x {RING - 1} hops x rounds "
              f"{[ring_rounds(b // RING, n) for b in buckets]} (gather_pack 1, copy_convert 2 "
              f"a round); tokens against the local engine: {equal}/{len(prompts)} equal, near "
              f"ties {json.dumps(ties)}", flush=True)
        if got != want:
            fails.append(f"n_parts={n}: pack launches {got}, expected {want}")
        if launches.get("flash_attention", 0):
            fails.append(f"n_parts={n}: flash_attention launched under the ring context")
        if st.prefills != len(prompts) or any(len(t) != new_tokens for t in tokens):
            fails.append(f"n_parts={n}: {st.prefills} prefills, token counts "
                         f"{[len(t) for t in tokens]}")
        if st.plan_inits != len(set(buckets)) + 1 or captured != ["decode_fn"]:
            fails.append(f"n_parts={n}: {st.plan_inits} plan inits, captured {captured}")
        del engine
    out["launches"] = launches_total
    checks = kv_kernel_checks(torch, ctxs[H_PARTS[0]].mesh)
    out["kv_kernel_checks"] = checks
    print(f"H1 pack kernels at the served KV hops, bitwise against their plain versions: "
          f"{json.dumps(checks)}", flush=True)
    if len(checks) != sum(len(set(out["serve"][n]["buckets"])) for n in H_PARTS):
        fails.append(f"{len(checks)} cuda KV hop plans checked, one a served bucket and n_parts "
                     f"expected")
    for c in checks:
        if (c["gather_pack_equal"] != c["cells"] or c["copy_convert_windows_equal"]
                != c["windows"] or not c["hop_equal"]):
            fails.append(f"pack kernels at the KV hop {c}: not bitwise equal")

    # the 2048-token prefill: ring against local, a planted fault against both
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, PREFILL_LEN)), device=dev)
    cache = model.init_cache(1, max_len)
    true_len = torch.full((1,), PREFILL_LEN, dtype=torch.int32, device=dev)

    def prefill(ctx=None, m=model):
        kw = {} if ctx is None else {"ctx": ctx}
        return m.prefill(params, {"tokens": toks}, cache, true_len=true_len, **kw)[0].float()

    local = prefill()
    plain = prefill(m=build_model(cfg, dev, attention=attention_plain))
    ring_logits = {n: prefill(ctx) for n, ctx in ctxs.items()}
    errs = {f"ring n_parts={n}": rel_err(got, local) for n, got in ring_logits.items()}
    # both packers are exact: the cuda kernels' hops equal the slice copies'
    slice_equal = {n: bool(torch.equal(prefill(ring_context(
        dev, seq_parallel=True, n_parts=n, comm_packer="slice", comm_coalesce=True)), got))
        for n, got in ring_logits.items()}
    out["prefill_cuda_equals_slice"] = slice_equal
    print(f"H1 prefill {PREFILL_LEN}: packer cuda logits bitwise equal to packer slice's: "
          f"{json.dumps(slice_equal)}", flush=True)
    if not all(slice_equal.values()):
        fails.append(f"ring prefill: packer cuda differs from packer slice {slice_equal}")
    errs["local flash vs plain attention"] = rel_err(local, plain)
    real_attend = ring_mod._attend_block
    ring_mod._attend_block = skipped_block_fault(PREFILL_LEN // RING)
    try:
        errs["fault: rank 0's block skipped"] = rel_err(prefill(ctxs[1]), local)
    finally:
        ring_mod._attend_block = real_attend
    finite = all(bool(torch.isfinite(got).all()) for got in ring_logits.values())
    del ring_logits
    print(f"H1 prefill {PREFILL_LEN}: relative L2 error of the last-position logits against the "
          f"local prefill (tol {RING_REL_TOL}): {json.dumps(errs)}; finite {finite}", flush=True)
    for n in H_PARTS:
        if not errs[f"ring n_parts={n}"] < RING_REL_TOL:
            fails.append(f"ring prefill n_parts={n}: relative error {errs[f'ring n_parts={n}']}")
    if not errs["fault: rank 0's block skipped"] > RING_REL_TOL:
        fails.append(f"the check cannot see a skipped KV block: {errs}")
    if not finite:
        fails.append("ring prefill: non-finite logits")
    out["prefill_rel_err"] = errs
    fns = {"local": prefill, **{f"ring n_parts={n}": (lambda c=c: prefill(c))
                                 for n, c in ctxs.items()}}

    def built_each_call(c=ctxs[H_PARTS[-1]]):
        with kv_exchange_built_each_call():
            return prefill(c)

    fns[f"ring n_parts={H_PARTS[-1]}, KV exchange built each call"] = built_each_call
    # one round of turns (two calls each): the ring prefills take 0.3-1.1 s
    out["prefill_ms"] = host_ms_turns(torch, fns, rounds=1)
    out["exchange"] = {}
    for n, ctx in ctxs.items():
        trace = device_breakdown(lambda c=ctx: prefill(c), n_cycles=1)
        out["exchange"][n] = exchange_share(trace)
        top = ", ".join(f"{k['name'][:40]} x{k['launches_per_cycle']:g} {k['us_per_cycle']:.0f}us"
                        for k in trace["kernels"][:5])
        print(f"H1 ring prefill {PREFILL_LEN} n_parts={n} breakdown: busy "
              f"{trace['busy_us_per_cycle']:.0f} us, idle share {trace['idle_share']:.3f}, "
              f"exchange {out['exchange'][n]['exchange_us']:.0f} us = "
              f"{out['exchange'][n]['share']:.4f} of busy; {top}", flush=True)
    print(f"H1 prefill {PREFILL_LEN} ms (host clock, in turns): {json.dumps(out['prefill_ms'])}",
          flush=True)

    # H2: the ring collective-matmul MLP
    toks2 = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, TP_LEN)), device=dev)
    tp_ctx = ring_context(dev, tp_mode="ring")
    local2 = model.logits(params, {"tokens": toks2}).float()
    _build.reset_launches()
    ring2 = model.logits(params, {"tokens": toks2}, ctx=tp_ctx).float()
    tp_launches = dict(_build.LAUNCHES)
    tp_err = rel_err(ring2, local2)
    real_rs = layers_mod.ring_matmul_reduce_scatter
    layers_mod.ring_matmul_reduce_scatter = dropped_partial_fault
    try:
        tp_fault = rel_err(model.logits(params, {"tokens": toks2}, ctx=tp_ctx).float(), local2)
    finally:
        layers_mod.ring_matmul_reduce_scatter = real_rs
    del local2, ring2
    tp_ms = host_ms_turns(torch, {
        "local": lambda: model.logits(params, {"tokens": toks2}),
        "tp ring": lambda: model.logits(params, {"tokens": toks2}, ctx=tp_ctx)})
    out["tp_ring"] = dict(rel_err=tp_err, fault_rel_err=tp_fault, tol=TP_RING_REL_TOL, ms=tp_ms,
                          launches=tp_launches)
    print(f"H2 tp_mode=ring logits at {TP_LEN} tokens: relative L2 error {tp_err} (tol "
          f"{TP_RING_REL_TOL}), fault (each block's own partial product left out) {tp_fault}; "
          f"ms {json.dumps(tp_ms)}; launches {json.dumps(tp_launches)}", flush=True)
    if not tp_err < TP_RING_REL_TOL:
        fails.append(f"tp_mode=ring logits: relative error {tp_err}")
    if not tp_fault > TP_RING_REL_TOL:
        fails.append(f"the tp_mode=ring check cannot see a partial product left out: {tp_fault}")
    out["tolerances"] = dict(ring_rel=RING_REL_TOL, tp_ring_rel=TP_RING_REL_TOL, tie=TIE_TOL)
    out["failures"] = fails
    if fails:
        raise PhaseFailure("; ".join(fails))
    return out


def slow_decay_params(torch, params32, rates=SLOW_DECAY_RATES, seed: int = 13):
    """``params32`` with every layer's ``w_base`` replaced by ``log(rate)``,
    each channel's rate drawn uniformly in ``rates`` (the decay lora starts
    at zero, so ``lw = -rate`` a token); the other leaves are shared."""
    g = torch.Generator(params32["embed"].device).manual_seed(seed)
    lo, hi = rates
    layers = []
    for lp in params32["layers"]:
        w = lp["w_base"]
        rate = lo + (hi - lo) * torch.rand(w.shape, generator=g, device=w.device)
        layers.append({**lp, "w_base": torch.log(rate).to(w.dtype)})
    return {**params32, "layers": layers}


def state_passing_check(torch, mesh, state_shape, fails) -> dict:
    """``state_passing`` alone on the card, C random and D drawn in (0.2, 1)
    broadcast over the value dim: ``ring`` and ``tree`` against the
    sequential composition ``s_{i+1} = D_i s_i + C_i`` in f64, within
    ``STATE_REL_TOL``, which the same call with D dropped (D = 1) must
    exceed."""
    from repro_torch.core.ring import state_passing

    g = torch.Generator(mesh.device).manual_seed(14)
    C = torch.randn(state_shape, generator=g, device=mesh.device)
    D = 0.2 + 0.8 * torch.rand((*state_shape[:-1], 1), generator=g, device=mesh.device)
    want = [torch.zeros_like(C[0], dtype=torch.float64)]
    for i in range(state_shape[0] - 1):
        want.append(D[i].double() * want[-1] + C[i].double())
    want = torch.stack(want)
    errs = {}
    for method in ("ring", "tree"):
        errs[method] = rel_err(state_passing(C, D, mesh, "model", method=method), want)
        errs[f"{method} fault: D dropped"] = rel_err(
            state_passing(C, torch.ones_like(D), mesh, "model", method=method), want)
        if not errs[method] < STATE_REL_TOL:
            fails.append(f"state_passing {method}: relative error {errs[method]}")
        if not errs[f"{method} fault: D dropped"] > STATE_REL_TOL:
            fails.append(f"the state_passing check cannot see D dropped: {errs}")
    return errs


def rwkv_ring(torch, dev, model, params, params32) -> dict:
    """H3 on rwkv6-1.6b's weights on the card (bf16 ``params`` and their f32
    copy ``params32``); raises :class:`PhaseFailure` after printing
    everything when a check fails."""
    import numpy as np

    from repro_torch.core.partitioned import message_all_to_all, partitioned_all_to_all
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.models import rwkv as rwkv_mod

    cfg = model.cfg
    fails: list[str] = []
    out: dict = {"ring": RING, "T": PREFILL_LEN}
    rng = np.random.default_rng(11)
    toks = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, PREFILL_LEN)),
                                      device=dev)}
    ctxs = {m: ring_context(dev, seq_parallel=True, state_method=m) for m in ("ring", "tree")}
    model32 = build_model(cfg.with_updates(dtype="float32", param_dtype="float32"), dev)
    launches, errs = {}, {}
    for label, m, p in (("bf16", model, params), ("f32", model32, params32)):
        _build.reset_launches()
        local = m.logits(p, toks).float()
        launches[f"{label} local"] = _build.LAUNCHES["wkv_chunked"]
        for method, ctx in ctxs.items():
            _build.reset_launches()
            got = m.logits(p, toks, ctx=ctx).float()
            launches[f"{label} {method}"] = _build.LAUNCHES["wkv_chunked"]
            errs[f"{label} {method}"] = rel_err(got, local)
            if not torch.isfinite(got).all():
                fails.append(f"rwkv {label} {method}: non-finite logits")
        del local, got
    # the planted fault: every segment scans from a zero state (no state
    # passed), f32
    passing = rwkv_mod.state_passing
    rwkv_mod.state_passing = lambda C, D, mesh, axis, **kw: torch.zeros_like(C)
    try:
        local = model32.logits(params32, toks).float()
        errs["f32 fault: no state passed"] = rel_err(
            model32.logits(params32, toks, ctx=ctxs["ring"]).float(), local)
    finally:
        rwkv_mod.state_passing = passing
    if not errs["f32 fault: no state passed"] > RWKV_F32_REL_TOL:
        fails.append(f"the rwkv check cannot see a state left unpassed: {errs}")
    # slow decays: D of a segment is O(1), so every predecessor's state and
    # the D factors of the composition reach the logits; the fault drops D
    slow = slow_decay_params(torch, params32)
    seg_D = []
    operator = rwkv_mod.wkv_segment_operator

    def recording_operator(*a, **kw):
        C, D = operator(*a, **kw)
        seg_D.append(D.float())
        return C, D

    rwkv_mod.wkv_segment_operator = recording_operator
    try:
        local = model32.logits(slow, toks).float()
        for method, ctx in ctxs.items():
            errs[f"f32 slow decay {method}"] = rel_err(model32.logits(slow, toks, ctx=ctx).float(),
                                                       local)
    finally:
        rwkv_mod.wkv_segment_operator = operator
    d_all = torch.cat([d.flatten() for d in seg_D])
    out["slow_decay_D"] = dict(min=d_all.min().item(), median=d_all.median().item(),
                               max=d_all.max().item())
    del seg_D, d_all
    rwkv_mod.state_passing = lambda C, D, mesh, axis, **kw: passing(C, torch.ones_like(D), mesh,
                                                                     axis, **kw)
    try:
        for method, ctx in ctxs.items():
            errs[f"f32 slow decay {method} fault: D dropped"] = rel_err(
                model32.logits(slow, toks, ctx=ctx).float(), local)
    finally:
        rwkv_mod.state_passing = passing
    del local, slow
    for method in ctxs:
        if not errs[f"f32 slow decay {method}"] < RWKV_F32_REL_TOL:
            fails.append(f"rwkv f32 slow decay {method}: relative error "
                         f"{errs[f'f32 slow decay {method}']}")
        if not errs[f"f32 slow decay {method} fault: D dropped"] > RWKV_F32_REL_TOL:
            fails.append(f"the rwkv check cannot see D dropped ({method}): {errs}")
    H, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    state_errs = state_passing_check(torch, ctxs["ring"].mesh, (RING, 1, H, hd, hd), fails)
    out["state_passing"] = dict(shape=[RING, 1, H, hd, hd], rel_err=state_errs, tol=STATE_REL_TOL)
    print(f"H3 state_passing alone at {(RING, 1, H, hd, hd)} f32, D in (0.2, 1), against the "
          f"sequential f64 composition: relative L2 {json.dumps(state_errs)} (tol "
          f"{STATE_REL_TOL}); the slow-decay model's segment D {json.dumps(out['slow_decay_D'])}",
          flush=True)
    out.update(launches=launches, rel_err=errs, tol_f32=RWKV_F32_REL_TOL)
    print(f"H3 rwkv6-1.6b logits at T={PREFILL_LEN} over {RING} ranks: relative L2 error against "
          f"the local model {json.dumps(errs)} (f32 held at {RWKV_F32_REL_TOL}, bf16 reported); "
          f"wkv_chunked launches a call {json.dumps(launches)} (2 x {cfg.n_layers} layers "
          f"sequence-parallel, {cfg.n_layers} local)", flush=True)
    for method in ctxs:
        if not errs[f"f32 {method}"] < RWKV_F32_REL_TOL:
            fails.append(f"rwkv f32 {method}: relative error {errs[f'f32 {method}']}")
    for label in ("bf16", "f32"):
        if launches[f"{label} local"] != cfg.n_layers or any(
                launches[f"{label} {m}"] != 2 * cfg.n_layers for m in ctxs):
            fails.append(f"wkv_chunked launches {launches}")
    out["logits_ms"] = host_ms_turns(torch, {
        "local": lambda: model.logits(params, toks),
        **{f"seq {m}": (lambda c=c: model.logits(params, toks, ctx=c)) for m, c in ctxs.items()}})
    print(f"H3 logits ms at T={PREFILL_LEN} (bf16, host clock, in turns): "
          f"{json.dumps(out['logits_ms'])}", flush=True)
    del model32

    # message_all_to_all against the native all-to-all, bitwise, on the card
    mesh = ctxs["ring"].mesh
    g = torch.Generator(dev).manual_seed(12)
    x = torch.randn((RING, RING, 64, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    a2a, a2a_launches = [], {}
    for n_parts in (1, 4):
        kw = dict(split_axis=0, concat_axis=0, n_parts=n_parts)
        want = partitioned_all_to_all(x, mesh, "model", **kw)
        for packer in ("slice", "cuda"):
            for coalesce in (True, False):
                _build.reset_launches()
                got = message_all_to_all(x, mesh, "model", packer=packer, coalesce=coalesce, **kw)
                cell = f"{packer} coalesce={coalesce} n_parts={n_parts}"
                a2a_launches[cell] = dict(_build.LAUNCHES)
                a2a.append(dict(cell=cell, equal=bool(torch.equal(got, want))))
                if not a2a[-1]["equal"]:
                    fails.append(f"message_all_to_all {cell} differs from the native all-to-all")
                if packer == "cuda" and not _build.LAUNCHES.get("copy_convert", 0):
                    fails.append(f"message_all_to_all {cell} launched no copy_convert")
    out.update(all_to_all=a2a, all_to_all_launches=a2a_launches,
               all_to_all_shape=list(x.shape))
    print(f"H3 message_all_to_all of {tuple(x.shape)} bf16 over {RING} ranks against "
          f"partitioned_all_to_all: {sum(c['equal'] for c in a2a)}/{len(a2a)} cells bitwise "
          f"equal; launches {json.dumps(a2a_launches)}", flush=True)
    out["failures"] = fails
    if fails:
        raise PhaseFailure("; ".join(fails))
    return out
