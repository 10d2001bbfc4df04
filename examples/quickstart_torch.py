"""Quickstart on the PyTorch port: train a tiny LM for a few steps, then
generate from it (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Without ``--device cpu`` it runs on the card (and raises where there is
none): the attention and its backward are the hand-written flash kernels,
at the reduced config's head dim of 16.
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import Trainer


def run_config(cfg) -> RunConfig:
    """The run: 30 steps of 8 sequences of 32 tokens, AdamW at 1e-3 after a
    warmup of 5."""
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("quickstart", seq_len=32, global_batch=8, kind="train"),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=60),
        steps=30,
        log_every=10,
    )


def generate(model, params):
    """8 new tokens for one request, served with persistent plans: the
    tokens and the engine's stats."""
    engine = ServingEngine(model, params, max_slots=2, max_len=64)
    uid = engine.submit([1, 2, 3, 4], max_new_tokens=8)
    return engine.run()[uid], engine.stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # a reduced llama3-style config (64-wide, 2 layers) that trains on CPU
    cfg = get_config("llama3-8b").reduced()
    model = build_model(cfg, args.device)
    n = sum(p.numel() for _, p in tree_leaves(model.init("meta")))
    print(f"arch={cfg.name} (reduced): {n:,} params on {model.device}")

    result = Trainer(model, run_config(cfg)).run()
    print(f"loss: {result.losses[0]:.3f} -> {result.losses[-1]:.3f} over "
          f"{len(result.losses)} steps")
    assert result.losses[-1] < result.losses[0], "loss must decrease"

    # generate a few tokens with the serving engine (persistent plans)
    tokens, stats = generate(model, model.init(0))
    print("generated:", tokens)
    print("plan stats:", stats.plan_inits, "inits,", stats.plan_hits, "cache hits")
    return {"losses": result.losses, "tokens": tokens, "stats": stats}


if __name__ == "__main__":
    main()
