"""Phase I of ``chip_smoke.py``: the MoE model on one card, phi3.5-moe
served at full width and expert-parallel on a virtual ring of 16 ranks,
and one grok-1 MoE FFN at full width with its hidden-split slots (random
weights from seed 0).

* I1, phi3.5-moe (d_model 4096, 32 heads on 8 KV heads, 16 experts top-2
  of d_ff 6400, vocab 32064; ``PHI_LAYERS`` = 8 of its 32 layers: 21 GB
  in bf16) through
  ``ServingEngine(max_slots=4, max_len=2048)`` under the local context
  (``moe_mode="dense"``): phase B's 8 requests (5-2000 prompt tokens, 16
  new each), prefilled at their exact length.  ``flash_attention``
  launches once a layer a prefill, and the decode step (the dropless MoE) is
  the engine's captured graph.  Tokens against the eager decode (equal)
  and against the same engine with the plain attention: reported in bf16
  (with the share of prefill routes the two runs send to other experts),
  held with the weights in f32 at ``F32_LAYERS`` layers (equal, or a near
  tie at the first difference by phase B's rule).  Prefill ms at the
  longest prompt, decode ms a step eager and graph beside the bytes floor
  (every slot's weights read a step), tokens per second, and the share of
  (token, choice) pairs dropped at ``capacity_factor`` 1.25.
* I2, the I1 weights on a ``(1, 16)`` ``VirtualMesh`` over ``("data",
  "model")`` under ``moe_mode="ep"`` (one slot a rank), one 2048-token
  prompt's logits for ``moe_comm`` ``native``, ``messages`` with packer
  ``slice`` and with packer ``cuda`` (coalesced), at ``n_parts`` 1 and 4:
  every variant bitwise equal to the others at the same ``n_parts``; at
  every dispatch and return of the ``cuda`` runs, ``gather_pack`` and each
  ``copy_convert`` unpack window held bitwise against their plain versions
  on that call's own buffer (:func:`checked_exchanges`), and their
  launches equal to layers x 2 all-to-alls x ``n_parts`` chunks x 16 ring
  shifts; with ``capacity_factor`` 8 (``n_experts / top_k``: nothing can
  drop) the EP logits within ``EP_REL_TOL`` of the local model's, which a
  planted fault (one slot's expert output left out) must exceed; local, EP
  ``n_parts`` 1 and 4 timed in turns, with each one's idle share and the
  exchange's share of device time.
* I3, one grok-1 MoE FFN (d_model 6144, 8 experts as 16 slots of 16384
  hidden, geglu; 9.7 GB) on 2048 tokens on the same mesh, with the grouped
  psum adding each expert's two half-width slots: ``native`` and
  ``messages`` with packer ``cuda`` bitwise equal at ``n_parts`` 1 and 4
  (kernels checked as in I2); at no-drop capacity within
  ``GROK_REL_TOL`` of ``_moe_dense``, which a planted fault (each group's
  partner slot left out of the psum) must exceed; timed in turns.

``chip_smoke.py`` calls :func:`moe_phase` between phases D and E; it is the
one entry point.
"""

from __future__ import annotations

import contextlib
import json
import time

from ring_lm import (
    PhaseFailure,
    exchange_kernel_checks,
    exchange_share,
    host_ms_turns,
    near_ties,
    rel_err,
)

PHI = "phi3.5-moe-42b-a6.6b"
GROK = "grok-1-314b"
#: I1: phi3.5-moe's depth cut to fit one card (32 layers are 83.7 GB), 16
#: until phase O joined, then 8 for the script's time (phase I 63.4-65.2 s)
PHI_LAYERS = 8
SERVE_LENGTHS = (5, 12, 100, 200, 500, 900, 1500, 2000)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 2048, 16
DECODE_STEPS = 20
#: I2 and I3: the model axis of the expert-parallel mesh (one slot a rank)
EP_RANKS = 16
EP_PARTS = (1, 4)
EP_LEN = 2048
#: I2: ||EP - local|| / ||local|| of all 2048 positions' logits (bf16,
#: ``PHI_LAYERS`` layers, no drops).  The two paths run the experts' products at other
#: batch shapes, so bf16 roundings may differ, and a rounding that moves a
#: router logit across a near tie sends a token to another expert; on
#: NVIDIA H100 80GB HBM3, 700 W, torch 2.11 the two read bitwise equal
#: (0.0), the planted fault 0.577
EP_REL_TOL = 0.01
#: I3: ||EP - dense|| / ||dense|| of the one FFN's outputs (bf16, no
#: drops); read 0.0 on the same card, the planted fault 0.707
GROK_REL_TOL = 0.01
#: I1's token check: phi3.5-moe at this depth with f32 weights (42 GB),
#: served by the flash and the plain engine.
#: In bf16 the capacity routing turns attention's rounding differences
#: into other experts (a route flipped at a near tie moves the ranks of
#: every later token of both experts, and with them which tokens drop), so
#: there the tokens are reported, and held in f32 (as phase D holds RWKV's)
F32_LAYERS = 8
#: the slot (= rank) whose expert output the I2 fault leaves out
FAULT_SLOT = 3


def ep_context(dev, **kw):
    """The ``(1, EP_RANKS)`` expert-parallel context over ``("data", "model")``."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.parallel.context import ParallelContext

    return ParallelContext(mesh=make_mesh((1, EP_RANKS), ("data", "model"), device=dev),
                           moe_mode="ep", **kw)


#: the I2 and I3 variants: moe_comm and its wire knobs
EP_COMMS = {
    "native": dict(moe_comm="native"),
    "messages slice": dict(moe_comm="messages", comm_packer="slice", comm_coalesce=True),
    "messages cuda": dict(moe_comm="messages", comm_packer="cuda", comm_coalesce=True),
}


def expected_pack_launches(layers: int, n_parts: int) -> dict:
    """``gather_pack``/``copy_convert`` launches of coalesced ``cuda`` EP
    layers: a dispatch and a return a layer, each ``n_parts`` chunk
    exchanges (padding chunks included) of ``EP_RANKS`` ring shifts, each
    shift one coalesced buffer of one segment (one gather, one copy)."""
    n = layers * 2 * n_parts * EP_RANKS
    return {"gather_pack": n, "copy_convert": n}


@contextlib.contextmanager
def checked_exchanges(torch, rows: list):
    """Every coalesced ``cuda`` exchange of ``message_all_to_all`` in this
    scope, before it runs: :func:`ring_lm.exchange_kernel_checks` on the
    call's own buffer (and a random block to unpack into), one row a call
    appended to ``rows``.  The checks' launches are taken back out of the
    counts."""
    from repro_torch.core import partitioned as part_mod
    from repro_torch.core.transport import PreparedExchange
    from repro_torch.kernels import _build

    real = part_mod.exchange_messages

    def checked(x, groups, *, mesh, packer="slice", transport="loopback", coalesce=False):
        prepared = PreparedExchange(groups, mesh=mesh, local_shape=x.shape[1:], dtype=x.dtype,
                                    packer=packer, transport=transport, coalesce=coalesce)
        if prepared.packer.name == "cuda" and coalesce:
            counts = dict(_build.LAUNCHES)
            g = torch.Generator(x.device).manual_seed(len(rows))
            y = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
            rows.append(dict(shape=list(x.shape), **exchange_kernel_checks(torch, prepared, x, y)))
            _build.LAUNCHES.clear()
            _build.LAUNCHES.update(counts)
        return prepared.run(x)

    part_mod.exchange_messages = checked
    try:
        yield
    finally:
        part_mod.exchange_messages = real


def summarize_checks(rows: list, fails: list, label: str) -> dict:
    out = dict(calls=len(rows), shapes=sorted({tuple(r["shape"]) for r in rows}),
               cells=sum(r["cells"] for r in rows),
               gather_pack_equal=sum(r["gather_pack_equal"] for r in rows),
               windows=sum(r["windows"] for r in rows),
               copy_convert_windows_equal=sum(r["copy_convert_windows_equal"] for r in rows))
    if not rows or out["gather_pack_equal"] != out["cells"] or (
            out["copy_convert_windows_equal"] != out["windows"]):
        fails.append(f"{label}: pack kernels at the EP exchanges not bitwise equal to their "
                     f"plain versions: {out}")
    return out


@contextlib.contextmanager
def slot_left_out(slot: int):
    """The planted I2 fault: the dispatch's expert consumer returns zeros
    for ``slot`` (its rank), so that slot's expert output never returns."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod.partitioned_all_to_all

    def a2a(x, mesh, axis, *, consume_fn=None, **kw):
        if consume_fn is None:
            return real(x, mesh, axis, **kw)

        def consume(chunk):
            y = consume_fn(chunk).clone()
            y[slot] = 0
            return y

        return real(x, mesh, axis, consume_fn=consume, **kw)

    moe_mod.partitioned_all_to_all = a2a
    try:
        yield
    finally:
        moe_mod.partitioned_all_to_all = real


@contextlib.contextmanager
def partner_slot_left_out():
    """The planted I3 fault: the grouped psum returns its input, so each
    expert's output keeps its j = 0 slot's half alone."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod.partitioned_psum
    moe_mod.partitioned_psum = lambda x, *a, **kw: x
    try:
        yield
    finally:
        moe_mod.partitioned_psum = real


@contextlib.contextmanager
def recorded_dispatches(rows: list):
    """Append every capacity dispatch's routes and keep mask (on the
    device) to ``rows``: a prefill's, layer by layer."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod._dispatch_indices

    def dispatch(cfg, idx, *a, **kw):
        tk, rank_e, keep = real(cfg, idx, *a, **kw)
        rows.append((idx, keep))
        return tk, rank_e, keep

    moe_mod._dispatch_indices = dispatch
    try:
        yield
    finally:
        moe_mod._dispatch_indices = real


def drop_share(rows: list) -> float:
    kept = sum(int(keep.sum()) for _, keep in rows)
    return 1.0 - kept / sum(keep.numel() for _, keep in rows)


def routes_differ(rows_a: list, rows_b: list) -> float:
    """Share of (token, choice) routes of two runs' dispatches, call by
    call, that name another expert."""
    if [i.shape for i, _ in rows_a] != [i.shape for i, _ in rows_b]:
        raise PhaseFailure("the two runs' dispatch sequences differ")
    differ = sum(int((a != b).sum()) for (a, _), (b, _) in zip(rows_a, rows_b))
    return differ / sum(a.numel() for a, _ in rows_a)


def moe_logits_at(torch, model, params, prompt, prefix, max_len):
    """The logits that follow ``prompt + prefix`` in ``model``: an
    exact-length prefill of the prompt, then a decode step a prefix token."""
    dev = model.device
    logits, cache = model.prefill(params, {"tokens": torch.as_tensor([prompt], device=dev)},
                                  model.init_cache(1, max_len))
    for t in prefix:
        logits, cache = model.decode_step(params, torch.tensor([[t]], device=dev), cache)
    return logits[0, -1].float()


def weight_bytes(params) -> int:
    """Bytes of every leaf a decode step reads whole (all but the
    embedding, of which it gathers a row a token)."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            leaves.append(t)

    walk({k: v for k, v in params.items() if k != "embed"})
    return sum(t.numel() * t.element_size() for t in leaves)


def serve_phi(torch, dev, model, params, fails, *, hbm_bytes_per_s: float) -> dict:
    """I1 on the phi weights already on the card."""
    import numpy as np

    from repro_torch.core.profiling import device_breakdown
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    from time_plan_graph import decode_row, eager_decode_engine

    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_LENGTHS]
    model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.long, device=dev)},
                  model.init_cache(1, 8))  # warm-up outside the counted run
    torch.cuda.synchronize()

    def serve(m, engine_cls=ServingEngine):
        engine = engine_cls(m, params, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
        uids = [engine.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        return engine, [done[u] for u in uids], time.perf_counter() - t0

    _build.reset_launches()
    engine, tokens, serve_s = serve(model)
    launches = dict(_build.LAUNCHES)
    st = engine.stats
    captured = [p.name for p in engine.plans._plans.values() if p.captured]
    n_tok = sum(len(t) for t in tokens)
    print(f"I1 serve {cfg.name} ({cfg.n_layers} layers): {st.prefills} prefills, "
          f"{st.decode_steps} decode steps, {n_tok} tokens in {serve_s:.3f} s = "
          f"{n_tok / serve_s:.1f} tok/s; plans {st.plan_inits} inits / {st.plan_hits} hits, "
          f"captured {captured}; launches {json.dumps(launches)}", flush=True)
    if launches.get("flash_attention", 0) != cfg.n_layers * st.prefills:
        fails.append(f"I1: flash_attention launched {launches.get('flash_attention', 0)} times "
                     f"for {st.prefills} prefills of {cfg.n_layers} layers")
    if st.prefills != len(prompts) or any(len(t) != SERVE_NEW for t in tokens):
        fails.append(f"I1: {st.prefills} prefills, token counts {[len(t) for t in tokens]}")
    if st.plan_inits != len(set(SERVE_LENGTHS)) + 1 or captured != ["decode_fn"]:
        fails.append(f"I1: {st.plan_inits} plan inits, captured {captured}")
    flash_rows: list = []
    with recorded_dispatches(flash_rows):
        _, eager_tokens, eager_s = serve(model, eager_decode_engine())
    if eager_tokens != tokens:
        fails.append(f"I1: graph decode tokens differ from the eager decode's: {tokens} vs "
                     f"{eager_tokens}")
    plain = build_model(cfg, dev, attention=attention_plain)
    plain_rows: list = []
    with recorded_dispatches(plain_rows):
        _, plain_tokens, plain_s = serve(plain)
    dropped, flipped = drop_share(flash_rows), routes_differ(flash_rows, plain_rows)
    del flash_rows, plain_rows
    # reported: bf16 routing carries rounding into other experts (F32_LAYERS)
    ties_fails: list = []
    equal, ties = near_ties(torch, moe_logits_at, plain, params, prompts, tokens, plain_tokens,
                            SERVE_MAX_LEN, ties_fails, labels=("flash", "plain"))
    print(f"I1 tokens: graph decode equal to eager ({eager_s:.3f} s): {eager_tokens == tokens}; "
          f"against the plain-attention engine ({plain_s:.3f} s, reported in bf16): "
          f"{equal}/{len(prompts)} equal, first differences {json.dumps(ties)}; prefill routes "
          f"naming another expert than the plain run's: {flipped:.5f}; (token, choice) pairs "
          f"dropped at capacity_factor {cfg.capacity_factor}: {dropped:.4f}", flush=True)

    longest = torch.as_tensor([prompts[-1]], device=dev)
    prefill_ms = host_ms_turns(torch, {"prefill": lambda: model.prefill(
        params, {"tokens": longest}, model.init_cache(1, SERVE_MAX_LEN))})["prefill"]
    prefill_trace = device_breakdown(lambda: model.prefill(
        params, {"tokens": longest}, model.init_cache(1, SERVE_MAX_LEN)), n_cycles=1)
    decode = decode_row(torch, engine, n=DECODE_STEPS, rounds=2)
    for side in ("eager", "graph"):
        b = decode[side].pop("breakdown")
        decode[side]["kernels"] = b["kernels"][:6]
    floor_ms = weight_bytes(params) / hbm_bytes_per_s * 1e3
    out = dict(model=cfg.name, layers=cfg.n_layers, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
               prompt_lengths=list(SERVE_LENGTHS), prefills=st.prefills,
               decode_steps=st.decode_steps, plan_inits=st.plan_inits, plan_hits=st.plan_hits,
               captured=captured, launches=launches, tokens=n_tok, serve_s=serve_s,
               tokens_per_s=n_tok / serve_s, eager_decode_serve_s=eager_s, plain_serve_s=plain_s,
               bf16_equal_requests=equal, bf16_first_differences=ties,
               bf16_prefill_routes_differ=flipped, drop_share=dropped,
               capacity_factor=cfg.capacity_factor, prefill_ms=prefill_ms,
               prefill_len=len(prompts[-1]), prefill_busy_ms=prefill_trace["busy_us_per_cycle"] / 1e3,
               prefill_idle_share=prefill_trace["idle_share"],
               prefill_kernels=prefill_trace["kernels"][:6],
               decode_ms=decode["eager"]["us"] / 1e3, decode_graph_ms=decode["graph"]["us"] / 1e3,
               decode_floor_ms=floor_ms, decode_weight_gb=weight_bytes(params) / 1e9,
               decode=decode)
    print(f"I1 prefill {len(prompts[-1])} tokens {prefill_ms:.2f} ms (busy "
          f"{out['prefill_busy_ms']:.2f} ms, idle {prefill_trace['idle_share']:.3f}); decode a "
          f"step eager {out['decode_ms']:.2f} ms (idle {decode['eager']['idle_share']:.3f}), "
          f"graph {out['decode_graph_ms']:.2f} ms (idle {decode['graph']['idle_share']:.3f}), "
          f"floor {floor_ms:.2f} ms ({out['decode_weight_gb']:.2f} GB of weights a step)",
          flush=True)
    return out


def tokens_f32(torch, dev, fails) -> dict:
    """I1's held token check: phi3.5-moe at ``F32_LAYERS`` layers with f32
    weights (seed 0), phase B's requests through the flash engine and the
    plain-attention engine: equal, or a near tie at the first difference
    by phase B's rule; the prefill routes of the two runs compared."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(PHI).with_updates(n_layers=F32_LAYERS, dtype="float32",
                                       param_dtype="float32")
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    plain = build_model(cfg, dev, attention=attention_plain)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in SERVE_LENGTHS]
    runs, rows = [], []
    for m in (model, plain):
        engine = ServingEngine(m, params, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
        uids = [engine.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
        rows.append([])
        with recorded_dispatches(rows[-1]):
            done = engine.run()
        runs.append([done[u] for u in uids])
        del engine
    equal, ties = near_ties(torch, moe_logits_at, plain, params, prompts, runs[0], runs[1],
                            SERVE_MAX_LEN, fails, labels=("flash", "plain"))
    out = dict(layers=cfg.n_layers, param_gb=(weight_bytes(params) + params["embed"].numel() * 4)
               / 1e9, equal_requests=equal, near_ties=ties,
               prefill_routes_differ=routes_differ(*rows), drop_share=drop_share(rows[0]))
    print(f"I1 tokens in f32 ({cfg.n_layers} layers, {out['param_gb']:.2f} GB), flash engine "
          f"against the plain-attention engine: {equal}/{len(prompts)} equal, near ties "
          f"{json.dumps(ties)}; prefill routes naming another expert: "
          f"{out['prefill_routes_differ']:.6f}", flush=True)
    return out


def ep_phi(torch, dev, model, params, fails) -> dict:
    """I2 on the I1 weights."""
    import numpy as np

    from repro_torch.core.profiling import device_breakdown
    from repro_torch.kernels import _build
    from repro_torch.models import build_model

    cfg = model.cfg
    rng = np.random.default_rng(3)
    toks = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, EP_LEN)),
                                      device=dev)}
    out: dict = {"ranks": EP_RANKS, "T": EP_LEN, "n_parts": list(EP_PARTS), "bitwise": {},
                 "launches": {}, "expected": {}, "kernel_checks": {}}
    launches_total: dict = {}
    for n in EP_PARTS:
        ref = None
        for label, kw in EP_COMMS.items():
            ctx = ep_context(dev, n_parts=n, **kw)
            rows: list = []
            _build.reset_launches()
            with checked_exchanges(torch, rows):
                got = model.logits(params, toks, ctx=ctx)
            launches = dict(_build.LAUNCHES)
            for k, v in launches.items():
                launches_total[k] = launches_total.get(k, 0) + v
            out["launches"][f"{label} n_parts={n}"] = launches
            if ref is None:
                ref = got
                if not torch.isfinite(got.float()).all():
                    fails.append(f"I2 {label} n_parts={n}: non-finite logits")
            else:
                out["bitwise"][f"{label} n_parts={n}"] = bool(torch.equal(got, ref))
            if kw.get("comm_packer") == "cuda":
                want = expected_pack_launches(cfg.n_layers, n)
                out["expected"][f"n_parts={n}"] = want
                got_n = {k: launches.get(k, 0) for k in want}
                if got_n != want:
                    fails.append(f"I2 cuda n_parts={n}: pack launches {got_n}, expected {want}")
                out["kernel_checks"][f"n_parts={n}"] = summarize_checks(rows, fails,
                                                                        f"I2 n_parts={n}")
            if launches.get("flash_attention", 0) != cfg.n_layers:
                fails.append(f"I2 {label} n_parts={n}: flash_attention launched "
                             f"{launches.get('flash_attention', 0)} times, not {cfg.n_layers}")
        del ref, got
    out["launches_total"] = launches_total
    print(f"I2 EP logits of {EP_LEN} tokens over {EP_RANKS} ranks: variants bitwise equal to "
          f"native at their n_parts {json.dumps(out['bitwise'])}; launches "
          f"{json.dumps(out['launches'])}, expected {json.dumps(out['expected'])}; pack kernels "
          f"at every cuda exchange {json.dumps(out['kernel_checks'])}", flush=True)
    if not all(out["bitwise"].values()):
        fails.append(f"I2: EP variants differ {out['bitwise']}")

    # no drops: EP against the local model; the planted fault above it
    m8 = build_model(cfg.with_updates(capacity_factor=cfg.n_experts / cfg.top_k), dev)
    local = m8.logits(params, toks).float()
    errs = {f"{label} n_parts={n}": rel_err(m8.logits(params, toks, ctx=ep_context(
        dev, n_parts=n, **EP_COMMS[label])).float(), local)
        for n in EP_PARTS for label in ("native", "messages cuda")}
    with slot_left_out(FAULT_SLOT):
        errs[f"fault: slot {FAULT_SLOT} left out"] = rel_err(
            m8.logits(params, toks, ctx=ep_context(dev)).float(), local)
    del local
    out.update(rel_err=errs, tol=EP_REL_TOL, capacity_factor_no_drop=m8.cfg.capacity_factor)
    print(f"I2 no drops (capacity_factor {m8.cfg.capacity_factor}): relative L2 of the EP logits "
          f"against the local model (tol {EP_REL_TOL}): {json.dumps(errs)}", flush=True)
    for key, e in errs.items():
        if key.startswith("fault"):
            if not e > EP_REL_TOL:
                fails.append(f"I2: the check cannot see a slot left out: {errs}")
        elif not e < EP_REL_TOL:
            fails.append(f"I2 {key}: relative error {e} against the local model")

    rows: list = []
    with recorded_dispatches(rows):
        model.logits(params, toks, ctx=ep_context(dev))
    out["drop_share"] = drop_share(rows)
    del rows
    fns = {"local": lambda: model.logits(params, toks)}
    for n in EP_PARTS:
        ctx = ep_context(dev, n_parts=n, **EP_COMMS["messages cuda"])
        fns[f"EP cuda n_parts={n}"] = lambda c=ctx: model.logits(params, toks, ctx=c)
    fns["EP native n_parts=1"] = lambda c=ep_context(dev): model.logits(params, toks, ctx=c)
    out["logits_ms"] = host_ms_turns(torch, fns)
    out["breakdown"] = {}
    for label, fn in fns.items():
        trace = device_breakdown(fn, n_cycles=1)
        row = exchange_share(trace)
        row["kernels"] = [dict(name=k["name"][:60], us=k["us_per_cycle"],
                               launches=k["launches_per_cycle"]) for k in trace["kernels"][:6]]
        out["breakdown"][label] = row
        print(f"I2 {label} logits breakdown: busy {row['busy_us'] / 1e3:.2f} ms, idle share "
              f"{row['idle_share']:.3f}, exchange {row['exchange_us'] / 1e3:.2f} ms = "
              f"{row['share']:.4f} of busy", flush=True)
    print(f"I2 logits ms (host clock, in turns): {json.dumps(out['logits_ms'])}; (token, choice) "
          f"pairs dropped a rank at capacity_factor {cfg.capacity_factor}: "
          f"{out['drop_share']:.4f}", flush=True)
    return out


def ep_grok(torch, dev, fails) -> dict:
    """I3: one grok-1 MoE FFN at full width."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.context import LOCAL

    cfg = get_config(GROK)
    t0 = time.perf_counter()
    p = moe_mod.moe_ffn_params(cfg, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in p.values()) / 1e9
    g = torch.Generator(dev).manual_seed(4)
    x = torch.randn((1, EP_LEN, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    out: dict = {"model": cfg.name, "slots": moe_mod._slots(cfg), "experts": cfg.n_experts,
                 "param_gb": gb, "init_s": time.perf_counter() - t0, "T": EP_LEN, "bitwise": {},
                 "launches": {}, "kernel_checks": {}}
    launches_total: dict = {}
    for n in EP_PARTS:
        ref = None
        for label in ("native", "messages cuda"):
            rows: list = []
            _build.reset_launches()
            with checked_exchanges(torch, rows):
                y, _ = moe_mod.apply_moe_ffn(cfg, p, x, ep_context(dev, n_parts=n,
                                                                   **EP_COMMS[label]))
            launches = dict(_build.LAUNCHES)
            out["launches"][f"{label} n_parts={n}"] = launches
            for k, v in launches.items():
                launches_total[k] = launches_total.get(k, 0) + v
            if ref is None:
                ref = y
            else:
                out["bitwise"][f"n_parts={n}"] = bool(torch.equal(y, ref))
                want = expected_pack_launches(1, n)
                if {k: launches.get(k, 0) for k in want} != want:
                    fails.append(f"I3 n_parts={n}: pack launches {launches}, expected {want}")
                out["kernel_checks"][f"n_parts={n}"] = summarize_checks(rows, fails,
                                                                        f"I3 n_parts={n}")
        if not torch.isfinite(ref.float()).all():
            fails.append(f"I3 n_parts={n}: non-finite output")
        del ref, y
    out["launches_total"] = launches_total
    c4 = cfg.with_updates(capacity_factor=cfg.n_experts / cfg.top_k)
    dense, _ = moe_mod.apply_moe_ffn(c4, p, x, LOCAL)
    errs = {f"n_parts={n}": rel_err(moe_mod.apply_moe_ffn(c4, p, x, ep_context(
        dev, n_parts=n, **EP_COMMS["messages cuda"]))[0], dense) for n in EP_PARTS}
    with partner_slot_left_out():
        errs["fault: partner slot left out of the psum"] = rel_err(
            moe_mod.apply_moe_ffn(c4, p, x, ep_context(dev))[0], dense)
    del dense
    out.update(rel_err=errs, tol=GROK_REL_TOL)
    for key, e in errs.items():
        if key.startswith("fault"):
            if not e > GROK_REL_TOL:
                fails.append(f"I3: the check cannot see a partner slot left out: {errs}")
        elif not e < GROK_REL_TOL:
            fails.append(f"I3 {key}: relative error {e} against _moe_dense")
    fns = {"local": lambda: moe_mod.apply_moe_ffn(cfg, p, x, LOCAL)}
    for n in EP_PARTS:
        ctx = ep_context(dev, n_parts=n, **EP_COMMS["messages cuda"])
        fns[f"EP cuda n_parts={n}"] = lambda c=ctx: moe_mod.apply_moe_ffn(cfg, p, x, c)
    out["ms"] = host_ms_turns(torch, fns)
    print(f"I3 {cfg.name} MoE FFN ({out['slots']} slots of {cfg.d_ff // 2}, {gb:.2f} GB) on "
          f"{EP_LEN} tokens over {EP_RANKS} ranks: native = messages cuda bitwise "
          f"{json.dumps(out['bitwise'])}; launches {json.dumps(out['launches'])}; pack kernels "
          f"{json.dumps(out['kernel_checks'])}; no drops, relative L2 against _moe_dense (tol "
          f"{GROK_REL_TOL}): {json.dumps(errs)}; ms (host clock, in turns) "
          f"{json.dumps(out['ms'])}", flush=True)
    if not all(out["bitwise"].values()):
        fails.append(f"I3: native and messages cuda differ {out['bitwise']}")
    del p, x
    return out


def moe_phase(torch, dev, *, hbm_bytes_per_s: float) -> dict:
    """Phase I; raises :class:`PhaseFailure` after printing everything
    when a check fails."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    fails: list[str] = []
    cfg = get_config(PHI).with_updates(n_layers=PHI_LAYERS)
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    out: dict = {"phi_init_s": time.perf_counter() - t0,
                 "phi_param_gb": (weight_bytes(params) + params["embed"].numel()
                                  * params["embed"].element_size()) / 1e9}
    print(f"phase I: {cfg.name} at {cfg.n_layers} of 32 layers, {out['phi_param_gb']:.2f} GB of "
          f"bf16 parameters made on the card in {out['phi_init_s']:.1f} s", flush=True)
    out["serve"] = serve_phi(torch, dev, model, params, fails, hbm_bytes_per_s=hbm_bytes_per_s)
    out["ep"] = ep_phi(torch, dev, model, params, fails)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    out["tokens_f32"] = tokens_f32(torch, dev, fails)
    gc.collect()
    torch.cuda.empty_cache()
    out["grok"] = ep_grok(torch, dev, fails)
    gc.collect()
    torch.cuda.empty_cache()
    out["failures"] = fails
    if fails:
        raise PhaseFailure("; ".join(fails))
    return out
