"""Phase K of ``chip_smoke.py``: the last model families on one card, each
at full width with random weights from seed 0, and at half its depth
(``DEPTHS``: the script's time, when phase O joined).

* K1, zamba2-1.2b (19 of its 38 mamba layers of d_inner 4096 with 64 SSD
  heads of 64 and state 64, one shared attention block of 32 heads of 64
  after each group of 6; vocab 32000; 2.4 GB in bf16 at full depth) through
  ``ServingEngine(max_slots=4, max_len=2048)``: 8 requests of 5-2016 prompt
  tokens (lengths the SSD scan takes: at most 32, or a multiple of 32), 16
  new each, prefilled at their exact length.  ``flash_attention`` launches
  once a group a prefill (the shared block), the decode step is the engine's
  captured graph: tokens against the eager decode (equal) and against the
  same engine with the plain attention (equal, or a near tie at the first
  difference).  Prefill ms at the longest prompt, decode ms a step eager
  and graph with idle shares, tokens per second, beside the floor of the
  weights and the f32 SSD state a step reads.
* K2, zamba2-1.2b (K1's depth) with f32 weights, one 2048-token prompt's logits on a
  ``(1, 8)`` ``VirtualMesh`` over ``("data", "model")`` under
  ``seq_parallel`` (the conv's ghost cells through ``seq_left_halo``, the
  SSD state through ``state_passing`` by ``ring`` and ``tree``, ring
  attention in the shared block) within ``SEQ_REL_TOL`` of the local
  logits, which two planted faults (ghost cells zeroed; the incoming state
  dropped) must exceed; then ``seq_left_halo`` at the model's conv shapes
  (4224 channels, 256 positions a rank, batch 1 and the serve's 4) with
  packer ``cuda`` (``copy_convert`` a pack and an unpack a partition)
  bitwise equal to packer ``slice`` at ``n_parts`` 1 and 3, its launches
  counted.
* K3, llama-3.2-vision-11b (20 of its 40 layers: 4 of its 8 groups of 4
  self layers and a gated cross layer over 1601 vision tokens; 19.6 GB in
  bf16 at full depth) through the same engine with K1's requests and
  checks, ``flash_attention`` launched once a layer a prefill (self and
  cross layers).  The engine feeds zero patch
  embeddings and the gates start at zero, so the cross layers are the
  identity there; so one 512-token prefill and one logits call also run
  with the gates at 0.5 and a random ``vision_emb``, flash against plain
  within ``VLM_REL_TOL``, and the logits must move from the closed-gate
  model's by more than ``CROSS_MOVES`` times the flash-plain difference.
* K4, hubert-xlarge (24 of its 48 non-causal layers of 16 heads of 80;
  1.9 GB in bf16 at full depth) ``encode`` of 4 x 1000 frames (20 s of
  audio at 50 frames/s): ``flash_attention`` launched once a layer at head
  dim 80 (the padded
  tensor-core route), the cluster logits within ``ENC_REL_TOL`` of the same
  model with the plain attention; ms a call with the idle share.

``chip_smoke.py`` calls :func:`families_phase` after phase J; it is the one
entry point.
"""

from __future__ import annotations

import json
import time

from moe_lm import weight_bytes
from ring_lm import PhaseFailure, host_ms_turns, near_ties, rel_err

ZAMBA, VLM, HUBERT = "zamba2-1.2b", "llama-3.2-vision-11b", "hubert-xlarge"
#: each model's depth cut to half (the script's time, when phase O joined:
#: phase K took 75.9-77.1 s at full depth)
DEPTHS = {ZAMBA: {"n_layers": 19}, VLM: {"n_layers": 20, "n_cross_layers": 4},
          HUBERT: {"n_layers": 24}}
#: prompt lengths of K1 and K3: lengths the SSD scan takes (at most its
#: chunk of 32, or a multiple of it), from 5 to 2016
SERVE_LENGTHS = (5, 12, 32, 160, 512, 992, 1504, 2016)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 2048, 16
#: decode steps a timing window (eager and graph in turns; phases B and D
#: take 20)
DECODE_STEPS = 10
RING, SEQ_LEN = 8, 2048
#: K2: ||seq-parallel - local|| / ||local|| of all 2048 positions' f32
#: logits; the two paths sum the SSD and attention terms in other orders
#: (f32 ulps through the layers)
SEQ_REL_TOL = 1e-3
HALO_PARTS = (1, 3)
#: K3 and K4: ||flash - plain|| / ||plain|| of bf16 logits, phase H's
#: bound for llama3-8b's 32 layers (``ring_lm.RING_REL_TOL``; flash against
#: plain read 0.0199 there)
VLM_REL_TOL = 0.1
ENC_REL_TOL = 0.1
#: K3: the open gates and an image must move the logits from the closed
#: gates' by more than this many times the flash-plain difference
CROSS_MOVES = 10.0
CROSS_LEN = 512
ENC_BATCH, ENC_FRAMES = 4, 1000


def family_logits_at(torch, model, params, prompt, prefix, max_len):
    """The logits that follow ``prompt + prefix`` in ``model``: an
    exact-length prefill (the VLM's with the engine's zero image), then a
    decode step a prefix token."""
    dev, cfg = model.device, model.cfg
    batch = {"tokens": torch.as_tensor([prompt], device=dev)}
    if cfg.family == "vlm":
        batch["vision_emb"] = torch.zeros((1, cfg.vision_tokens, cfg.d_vision),
                                          dtype=torch.bfloat16, device=dev)
    logits, cache = model.prefill(params, batch, model.init_cache(1, max_len))
    for t in prefix:
        logits, cache = model.decode_step(params, torch.tensor([[t]], device=dev), cache)
    return logits[0, -1].float()


def param_gb(params) -> float:
    return (weight_bytes(params) + params["embed"].numel() * params["embed"].element_size()) / 1e9


def state_bytes(engine) -> int:
    """Bytes of the recurrent state a decode step reads and writes (the
    hybrid's conv and SSD states; none for the VLM)."""
    return sum(t.numel() * t.element_size() for k, t in engine._cache.items()
               if k.endswith(("_conv", "_ssd")))


def serve_family(torch, dev, model, params, fails, tag: str, *,
                 hbm_bytes_per_s: float) -> dict:
    """K1 / K3 on weights already on the card."""
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
    family_logits_at(torch, model, params, prompts[0], [], 64)  # warm-up outside the count
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
    per_prefill = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    print(f"{tag} serve {cfg.name}: {st.prefills} prefills, {st.decode_steps} decode steps, "
          f"{n_tok} tokens in {serve_s:.3f} s = {n_tok / serve_s:.1f} tok/s; plans "
          f"{st.plan_inits} inits / {st.plan_hits} hits, captured {captured}; launches "
          f"{json.dumps(launches)}", flush=True)
    if launches.get("flash_attention", 0) != per_prefill * st.prefills:
        fails.append(f"{tag}: flash_attention launched {launches.get('flash_attention', 0)} "
                     f"times for {st.prefills} prefills of {per_prefill}")
    if st.prefills != len(prompts) or any(len(t) != SERVE_NEW for t in tokens):
        fails.append(f"{tag}: {st.prefills} prefills, token counts {[len(t) for t in tokens]}")
    if st.plan_inits != len(set(SERVE_LENGTHS)) + 1 or captured != ["decode_fn"]:
        fails.append(f"{tag}: {st.plan_inits} plan inits, captured {captured}")
    _, eager_tokens, eager_s = serve(model, eager_decode_engine())
    if eager_tokens != tokens:
        fails.append(f"{tag}: graph decode tokens differ from the eager decode's: {tokens} vs "
                     f"{eager_tokens}")
    plain = build_model(cfg, dev, attention=attention_plain)
    _, plain_tokens, plain_s = serve(plain)
    equal, ties = near_ties(torch, family_logits_at, plain, params, prompts, tokens,
                            plain_tokens, SERVE_MAX_LEN, fails, labels=("flash", "plain"))
    print(f"{tag} tokens: graph decode equal to eager ({eager_s:.3f} s): "
          f"{eager_tokens == tokens}; against the plain-attention engine ({plain_s:.3f} s): "
          f"{equal}/{len(prompts)} equal, first differences {json.dumps(ties)}", flush=True)

    longest = {"tokens": torch.as_tensor([prompts[-1]], device=dev)}
    if cfg.family == "vlm":
        longest["vision_emb"] = torch.zeros((1, cfg.vision_tokens, cfg.d_vision),
                                            dtype=torch.bfloat16, device=dev)

    def prefill():
        return model.prefill(params, longest, model.init_cache(1, SERVE_MAX_LEN))

    prefill_ms = host_ms_turns(torch, {"prefill": prefill})["prefill"]
    trace = device_breakdown(prefill, n_cycles=1)
    decode = decode_row(torch, engine, n=DECODE_STEPS, rounds=2)
    for side in ("eager", "graph"):
        b = decode[side].pop("breakdown")
        decode[side]["kernels"] = b["kernels"][:6]
    nbytes = weight_bytes(params) + state_bytes(engine)
    out = dict(model=cfg.name, layers=cfg.n_layers, param_gb=param_gb(params),
               slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, prompt_lengths=list(SERVE_LENGTHS),
               prefills=st.prefills, decode_steps=st.decode_steps, plan_inits=st.plan_inits,
               plan_hits=st.plan_hits, captured=captured, launches=launches, tokens=n_tok,
               serve_s=serve_s, tokens_per_s=n_tok / serve_s, eager_decode_serve_s=eager_s,
               plain_serve_s=plain_s, equal_requests=equal, first_differences=ties,
               prefill_len=len(prompts[-1]), prefill_ms=prefill_ms,
               prefill_busy_ms=trace["busy_us_per_cycle"] / 1e3,
               prefill_idle_share=trace["idle_share"], prefill_kernels=trace["kernels"][:6],
               decode_ms=decode["eager"]["us"] / 1e3, decode_graph_ms=decode["graph"]["us"] / 1e3,
               decode_floor_ms=nbytes / hbm_bytes_per_s * 1e3, decode_floor_gb=nbytes / 1e9,
               state_gb=state_bytes(engine) / 1e9, decode=decode)
    print(f"{tag} prefill {len(prompts[-1])} tokens {prefill_ms:.2f} ms (busy "
          f"{out['prefill_busy_ms']:.2f} ms, idle {trace['idle_share']:.3f}); decode a step "
          f"eager {out['decode_ms']:.2f} ms (idle {decode['eager']['idle_share']:.3f}), graph "
          f"{out['decode_graph_ms']:.2f} ms (idle {decode['graph']['idle_share']:.3f}), floor "
          f"{out['decode_floor_ms']:.3f} ms ({out['decode_floor_gb']:.3f} GB of weights and "
          f"state a step)", flush=True)
    return out


def zamba_ring(torch, dev, fails) -> dict:
    """K2: the f32 model's sequence-parallel logits and the conv halo's
    kernel packer at the model's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core.halo import seq_left_halo
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.transport import Partitioner
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.models import ssm
    from repro_torch.parallel.context import ParallelContext

    cfg = get_config(ZAMBA).with_updates(**DEPTHS[ZAMBA], dtype="float32",
                                         param_dtype="float32")
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    mesh = make_mesh((1, RING), ("data", "model"), device=dev)
    ctxs = {m: ParallelContext(mesh=mesh, seq_parallel=True, state_method=m)
            for m in ("ring", "tree")}
    tokens = {"tokens": torch.randint(0, cfg.vocab_size, (1, SEQ_LEN), device=dev,
                                      generator=torch.Generator(dev).manual_seed(1))}
    local = model.logits(params, tokens)
    out: dict = {"param_gb": param_gb(params), "rel": {}}
    for m, ctx in ctxs.items():
        out["rel"][m] = rel_err(model.logits(params, tokens, ctx=ctx), local)

    def no_halo(xs, mesh, axis, width, **kw):
        return torch.cat([torch.zeros_like(xs[:, :, :width]), xs], dim=2)

    def no_state(C, D, mesh, axis, **kw):
        return torch.zeros_like(C)

    for name, fault in (("seq_left_halo", no_halo), ("state_passing", no_state)):
        orig = getattr(ssm, name)
        setattr(ssm, name, fault)
        try:
            out["rel"][f"fault: {name} left out"] = rel_err(
                model.logits(params, tokens, ctx=ctxs["ring"]), local)
        finally:
            setattr(ssm, name, orig)
    for m in ctxs:
        if not out["rel"][m] < SEQ_REL_TOL:
            fails.append(f"K2: {m} logits {out['rel'][m]} from local (tol {SEQ_REL_TOL})")
    for k, v in out["rel"].items():
        if k.startswith("fault") and not v > SEQ_REL_TOL:
            fails.append(f"K2: the check cannot see the planted fault ({k}: {v})")
    out["ms"] = host_ms_turns(torch, {"local": lambda: model.logits(params, tokens),
                                      **{m: (lambda c=c: model.logits(params, tokens, ctx=c))
                                         for m, c in ctxs.items()}}, rounds=1)
    print(f"K2 {cfg.name} f32 logits of {SEQ_LEN} tokens on {RING} ranks: relative L2 to local "
          f"{json.dumps(out['rel'])} (tol {SEQ_REL_TOL}); host ms {json.dumps(out['ms'])}",
          flush=True)
    del params, model, local
    torch.cuda.empty_cache()

    # the conv halo with the kernel packer at the model's shapes
    ch = ssm.conv_channels(cfg)
    halo = []
    for batch in (1, SERVE_SLOTS):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((RING, batch, SEQ_LEN // RING, ch), device=dev,
                            generator=torch.Generator(dev).manual_seed(2)).to(dtype)
            for n in HALO_PARTS:
                want = seq_left_halo(x, mesh, "model", cfg.conv_kernel - 1, n_parts=n)
                _build.reset_launches()
                got = seq_left_halo(x, mesh, "model", cfg.conv_kernel - 1, n_parts=n,
                                    packer="cuda")
                torch.cuda.synchronize()
                row = dict(batch=batch, dtype=str(dtype)[6:], n_parts=n,
                           bitwise=bool(torch.equal(got, want)),
                           copy_convert=_build.LAUNCHES.get("copy_convert", 0),
                           rounds=sum(1 for _, w in Partitioner(n).slices(batch) if w > 0))
                halo.append(row)
                if not row["bitwise"] or row["copy_convert"] != 2 * row["rounds"]:
                    fails.append(f"K2: seq_left_halo packer cuda {row}")
    out["halo"] = halo
    print(f"K2 seq_left_halo at the conv shapes ({ch} channels, {SEQ_LEN // RING} positions a "
          f"rank), packer cuda against slice: {json.dumps(halo)}", flush=True)
    return out


def vlm_gates(torch, dev, model, params, fails) -> dict:
    """K3's open-gate check on the weights already on the card."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import build_model

    cfg = model.cfg
    plain = build_model(cfg, dev, attention=attention_plain)
    g = torch.Generator(dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, CROSS_LEN), device=dev, generator=g),
             "vision_emb": torch.randn((1, cfg.vision_tokens, cfg.d_vision), device=dev,
                                       generator=g).to(torch.bfloat16)}
    closed = model.logits(params, batch)
    gates = [cp["xattn"][k] for cp in params["cross"] for k in ("gate_attn", "gate_ffn")]
    for t in gates:
        t.fill_(0.5)
    try:
        _build.reset_launches()
        logits = model.logits(params, batch)
        last, _ = model.prefill(params, batch, model.init_cache(1, CROSS_LEN))
        flash_launches = _build.LAUNCHES.get("flash_attention", 0)
        plain_logits = plain.logits(params, batch)
        plain_last, _ = plain.prefill(params, batch, plain.init_cache(1, CROSS_LEN))
    finally:
        for t in gates:
            t.zero_()
    out = dict(prompt_len=CROSS_LEN, flash_launches=flash_launches,
               logits_rel=rel_err(logits, plain_logits), prefill_rel=rel_err(last, plain_last),
               moved_rel=rel_err(logits, closed))
    if flash_launches != 2 * cfg.n_layers:
        fails.append(f"K3: flash_attention launched {flash_launches} times for a logits call and "
                     f"a prefill of {cfg.n_layers} layers")
    if not max(out["logits_rel"], out["prefill_rel"]) < VLM_REL_TOL:
        fails.append(f"K3: open gates, flash against plain {out} (tol {VLM_REL_TOL})")
    if not out["moved_rel"] > CROSS_MOVES * max(out["logits_rel"], 1e-6):
        fails.append(f"K3: the open gates and the image do not move the logits {out}")
    print(f"K3 gates at 0.5, a random image, {CROSS_LEN} tokens: flash against plain, logits "
          f"{out['logits_rel']:.5f}, prefill {out['prefill_rel']:.5f} (tol {VLM_REL_TOL}); the "
          f"logits moved {out['moved_rel']:.4f} from the closed gates'; flash launches "
          f"{flash_launches}", flush=True)
    return out


def hubert_encode(torch, dev, fails) -> dict:
    """K4."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiling import device_breakdown
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.models import build_model

    cfg = get_config(HUBERT).with_updates(**DEPTHS[HUBERT])
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    plain = build_model(cfg, dev, attention=attention_plain)
    frames = {"frames": torch.randn((ENC_BATCH, ENC_FRAMES, cfg.d_vision), device=dev,
                                    generator=torch.Generator(dev).manual_seed(4)
                                    ).to(torch.bfloat16)}
    model.logits(params, frames)  # warm-up outside the count
    torch.cuda.synchronize()
    _build.reset_launches()
    got = model.logits(params, frames)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = plain.logits(params, frames)
    out = dict(model=cfg.name, batch=ENC_BATCH, frames=ENC_FRAMES, head_dim=cfg.resolved_head_dim,
               param_gb=(weight_bytes(params)) / 1e9, launches=launches,
               shape=list(got.shape), finite=bool(torch.isfinite(got.float()).all()),
               rel=rel_err(got, want))
    if launches.get("flash_attention", 0) != cfg.n_layers:
        fails.append(f"K4: flash_attention launched {launches.get('flash_attention', 0)} times "
                     f"for {cfg.n_layers} layers")
    if not (out["finite"] and out["rel"] < ENC_REL_TOL
            and out["shape"] == [ENC_BATCH, ENC_FRAMES, cfg.vocab_size]):
        fails.append(f"K4: encode {out} (tol {ENC_REL_TOL})")

    def encode():
        return model.logits(params, frames)

    out["ms"] = host_ms_turns(torch, {"flash": encode,
                                      "plain": lambda: plain.logits(params, frames)})
    trace = device_breakdown(encode, n_cycles=1)
    out.update(busy_ms=trace["busy_us_per_cycle"] / 1e3, idle_share=trace["idle_share"],
               kernels=trace["kernels"][:6])
    print(f"K4 {cfg.name} encode {ENC_BATCH} x {ENC_FRAMES} frames (head dim "
          f"{cfg.resolved_head_dim}): {out['ms']['flash']:.2f} ms a call (plain attention "
          f"{out['ms']['plain']:.2f}; busy {out['busy_ms']:.2f} ms, idle "
          f"{out['idle_share']:.3f}); flash against plain {out['rel']:.5f} (tol {ENC_REL_TOL}); "
          f"launches {json.dumps(launches)}", flush=True)
    return out


def families_phase(torch, dev, *, hbm_bytes_per_s: float) -> dict:
    """Phase K; raises :class:`PhaseFailure` after printing everything
    when a check fails."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    fails: list[str] = []
    out: dict = {}
    for tag, name in (("K1", ZAMBA), ("K3", VLM)):
        model = build_model(get_config(name).with_updates(**DEPTHS[name]), dev)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        print(f"phase {tag}: {name} at full width, {model.cfg.n_layers} layers, "
              f"{param_gb(params):.2f} GB of bf16 "
              f"parameters made on the card in {time.perf_counter() - t0:.1f} s", flush=True)
        out[tag] = serve_family(torch, dev, model, params, fails, tag,
                                hbm_bytes_per_s=hbm_bytes_per_s)
        if tag == "K3":
            out["K3"]["gates"] = vlm_gates(torch, dev, model, params, fails)
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        if tag == "K1":
            out["K2"] = zamba_ring(torch, dev, fails)
            gc.collect()
            torch.cuda.empty_cache()
    out["K4"] = hubert_encode(torch, dev, fails)
    gc.collect()
    torch.cuda.empty_cache()
    out["failures"] = fails
    if fails:
        raise PhaseFailure("; ".join(fails))
    return out
