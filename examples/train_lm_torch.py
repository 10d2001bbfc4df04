"""End-to-end training driver with checkpointing and fault-tolerant restart,
on the PyTorch port (the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 40] [--fail-at 25] [--device cpu]

Default: a small llama-family model (about 1.8M parameters) with a mid-run
injected failure: the run restarts from the latest checkpoint and finishes
on the trajectory an uninterrupted run takes.  Without ``--device cpu`` it
runs on the card (and raises where there is none); ``python -m
repro_torch.launch.train`` trains a full config.
"""

import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.train.fault_tolerance import FailureInjector
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_loop import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--fail-at", type=int, default=25)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced().with_updates(
        d_model=args.width, n_layers=args.layers, d_ff=args.width * 3,
        vocab_size=4096, n_heads=max(4, args.width // 32),
        n_kv_heads=max(2, args.width // 64), head_dim=32)
    model = build_model(cfg, args.device)
    n = sum(p.numel() for _, p in tree_leaves(model.init("meta")))
    print(f"training {cfg.name} (reduced, {n/1e6:.1f}M params) on {model.device} "
          f"batch={args.batch} seq={args.seq} steps={args.steps}")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    run_cfg = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", args.seq, args.batch, "train"),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=10,
                                  total_steps=args.steps * 2),
        steps=args.steps,
        log_every=10,
        checkpoint_dir=ckpt_dir,
        checkpoint_every=10,
        async_checkpoint=True,
    )
    injector = FailureInjector(
        fail_at_steps=(args.fail_at,) if args.fail_at >= 0 else ())
    result = Trainer(model, run_cfg, injector=injector).run()
    print(f"done: loss {result.losses[0]:.3f} -> {result.losses[-1]:.3f}, "
          f"restarts={result.restarts} (checkpoints in {ckpt_dir})")
    assert result.losses[-1] < result.losses[0]


if __name__ == "__main__":
    main()
