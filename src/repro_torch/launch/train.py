"""Training launcher of the PyTorch port (port of
``src/repro/launch/train.py``, same flags plus ``--device``).  The step
accumulates gradients over the config's ``train_microbatches``, cut to
divide ``--batch``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 4 --device cpu

Without ``--device`` it runs on the card and raises where there is none.
``--mesh production`` (training on a mesh) raises ``NotImplementedError``:
ROADMAP Queue 1 item 21.
"""

from __future__ import annotations

import argparse
import logging

from repro_torch.configs import get_config
from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.parallel.context import LOCAL, ParallelContext
from repro_torch.train.fault_tolerance import FailureInjector
from repro_torch.train.train_loop import Trainer, TrainResult


def main(argv: list[str] | None = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU smoke)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["local", "production"], default="local")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (fault-tolerance demo)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    ctx = LOCAL
    if args.mesh == "production":
        from repro_torch.launch.mesh import data_axes_of, make_production_mesh

        mesh = make_production_mesh()
        ctx = ParallelContext(mesh=mesh, data_axes=data_axes_of(mesh),
                              moe_mode="ep" if cfg.family == "moe" else "dense")

    run_cfg = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", args.seq, args.batch, "train"),
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=max(args.steps, 10)),
        steps=args.steps,
        seed=args.seed,
        log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )
    injector = FailureInjector(
        fail_at_steps=(args.fail_at,) if args.fail_at >= 0 else ())
    model = build_model(cfg, args.device)
    result = Trainer(model, run_cfg, ctx=ctx, injector=injector).run()
    print(f"trained {len(result.losses)} steps on {model.device}: "
          f"loss {result.losses[0]:.4f} -> {result.losses[-1]:.4f}, "
          f"restarts={result.restarts}, stragglers={result.straggler_flags}")
    return result


if __name__ == "__main__":
    main()
