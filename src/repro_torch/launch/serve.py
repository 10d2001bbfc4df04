"""Serving launcher of the PyTorch port: batched generation with continuous
batching (port of ``src/repro/launch/serve.py``, same flags plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
        --reduced --requests 8 --slots 4 --max-new 12 --device cpu

Without ``--device`` it runs on the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    if not model.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode serving")
    params = model.init(torch.Generator(model.device).manual_seed(args.seed))
    engine = ServingEngine(model, params, max_slots=args.slots, max_len=args.max_len)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    uids = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, 12)))
        uids.append(engine.submit(prompt.tolist(), max_new_tokens=args.max_new))
    results = engine.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    for uid in uids:
        print(f"req {uid}: {results[uid]}")
    st = engine.stats
    print(f"{st.tokens_generated} tokens in {dt:.2f}s on {model.device} "
          f"({st.tokens_generated/dt:.1f} tok/s), "
          f"{st.prefills} prefills, {st.decode_steps} decode steps, "
          f"plans: {st.plan_inits} inits / {st.plan_hits} cache hits")


if __name__ == "__main__":
    main()
