"""End-to-end serving on the PyTorch port: a small LM served with
batched requests, continuous batching, and persistent step plans (the
counterpart of ``examples/serve_batched.py``).

    PYTHONPATH=src python examples/serve_batched_torch.py [--arch stablelm-1.6b]
        [--width 128] [--layers 4] [--requests 12] [--slots 4] [--device cpu]

The default builds a ~20M-parameter stablelm-family model (head dim 32);
``--full`` serves the unreduced config (stablelm-1.6b at full width on the
card).  Without ``--device cpu`` it runs on the card (and raises where
there is none), its prefill attention the hand-written flash kernel and
its decode steps CUDA graphs.
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.train.optimizer import tree_leaves


def example_config(arch: str, width: int, layers: int, vocab: int, full: bool):
    """``arch``'s config, or unless ``full`` its reduced form at ``width``
    (heads of 32), ``layers`` and ``vocab``."""
    cfg = get_config(arch)
    if full:
        return cfg
    return cfg.reduced().with_updates(
        d_model=width, n_layers=layers, vocab_size=vocab, d_ff=width * 3,
        n_heads=max(4, width // 32), n_kv_heads=max(4, width // 32), head_dim=32)


def submit_requests(engine, vocab_size: int, requests: int, max_new: int) -> list[int]:
    """``requests`` prompts of 4-23 tokens from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [engine.submit(rng.integers(0, vocab_size, size=int(rng.integers(4, 24))).tolist(),
                          max_new_tokens=max_new)
            for _ in range(requests)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--bench-out", default="",
                    help="run the transport-layer serve cells "
                         "(repro_torch.serving.bench) and write BENCH records here")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.bench_out:
        from repro_torch.serving.bench import main as serve_main

        raise SystemExit(serve_main(
            ["--out", args.bench_out, "--requests", str(args.requests),
             "--slots", str(args.slots), "--max-new", str(args.max_new),
             *(["--device", args.device] if args.device else [])]))

    cfg = example_config(args.arch, args.width, args.layers, args.vocab, args.full)
    model = build_model(cfg, args.device)
    params = model.init(0)
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    print(f"serving {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.slots} slots, {args.requests} requests on {model.device}")

    engine = ServingEngine(model, params, max_slots=args.slots, max_len=256)
    t0 = time.perf_counter()
    uids = submit_requests(engine, cfg.vocab_size, args.requests, args.max_new)
    results = engine.run()
    dt = time.perf_counter() - t0

    for uid in uids[:4]:
        print(f"  req {uid}: {results[uid][:10]}...")
    st = engine.stats
    print(f"{st.tokens_generated} tokens in {dt:.2f}s "
          f"({st.tokens_generated/dt:.1f} tok/s) | "
          f"{st.prefills} prefills, {st.decode_steps} decode steps | "
          f"persistent plans: {st.plan_inits} inits, {st.plan_hits} hits "
          f"(amortization={st.plan_hits/max(1, st.plan_inits):.0f}x)")
    return {"results": results, "uids": uids, "stats": st, "seconds": dt,
            "params": n_params}


if __name__ == "__main__":
    main()
