"""The paper's workload end to end on the PyTorch port: 3-D Jacobi (heat)
iteration on a (4, 2) virtual mesh with standard / persistent / partitioned
(and fused, overlap) halo exchanges; all ranks stacked on one device.

The port's counterpart of ``examples/stencil_heat3d.py``.  It runs on the
card unless ``--device cpu`` is given (without a card the default raises):

    PYTHONPATH=src python examples/stencil_heat3d_torch.py [--cycles 10] [--size 32]
    PYTHONPATH=src python examples/stencil_heat3d_torch.py --strategy auto --device cpu

The update is ``repro_torch.stencil.heat3d.heat3d_update`` (the CUDA
``stencil27`` kernel on the card, its plain version on the CPU); the cycles
are checked against the periodic numpy oracle.
"""

import argparse

import numpy as np

from repro_torch.core.mesh import make_mesh
from repro_torch.core.transport import available_packers
from repro_torch.kernels.stencil27 import jacobi_weights
from repro_torch.stencil import (
    Domain,
    StrategyConfig,
    comb_measure,
    make_driver,
    periodic_oracle_step,
)
from repro_torch.stencil.comb import result_label
from repro_torch.stencil.heat3d import DOMAIN_AXES, MESH_AXES, heat3d_update
from repro_torch.stencil.strategies import available_strategies


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--strategy", choices=[*available_strategies(), "auto"],
                    help="measure and verify just this strategy (beside the standard "
                         "baseline); default: all registered.  'auto' lets "
                         "repro_torch.core.autotune pick strategy, packer, coalesce "
                         "mode and partition count for this cell")
    ap.add_argument("--packer", choices=available_packers(), default="slice",
                    help="pack backend every message stages through (cuda = the CUDA "
                         "copy/gather kernels; their plain versions on the CPU)")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="one wire buffer and one rank gather per message instead of "
                         "one per neighbor hop chain")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    coalesce = not args.no_coalesce

    mesh = make_mesh((4, 2), MESH_AXES, device=args.device)
    dom = Domain(mesh, global_interior=(args.size, args.size, args.size // 2),
                 mesh_axes=DOMAIN_AXES)
    w = jacobi_weights().numpy()
    update = heat3d_update(w, mesh.device)

    def config(name: str) -> StrategyConfig:
        if name == "auto":
            # fully open: the tuner owns packer, coalesce and partition count
            return StrategyConfig(name="auto", packer="auto", coalesce="auto")
        return StrategyConfig(name=name, packer=args.packer, coalesce=coalesce,
                              n_parts=args.parts if name == "partitioned" else 1)

    names = (tuple(available_strategies()) if args.strategy is None
             else tuple(dict.fromkeys(("standard", args.strategy))))
    print(f"domain {dom.global_interior} on mesh {mesh.shape} ({mesh.device}); "
          f"{args.cycles} cycles per strategy: {', '.join(names)} "
          f"(packer={args.packer}, {'coalesced' if coalesce else 'uncoalesced'})")
    results = comb_measure(dom, strategies=tuple(config(s) for s in names),
                           update_fn=update, n_cycles=args.cycles, repeats=3)
    base = results[result_label("standard", args.packer, coalesce)].us_per_cycle
    for s, r in results.items():
        sp = (base / r.us_per_cycle - 1.0) * 100.0
        print(f"  {s:12s} {r.us_per_cycle:9.1f} us/cycle  speedup={sp:+6.1f}%  "
              f"init={r.init_us:.0f}us")
        if r.selected_by:
            print(f"  {'':12s} resolved to {r.strategy}@{r.packer} "
                  f"{'coalesced' if r.coalesce else 'uncoalesced'} p={r.n_parts} "
                  f"via {r.selected_by} (predicted {r.predicted_us or 0.0:.1f}us, "
                  f"calibration {r.calibration_us / 1e6:.2f}s)")

    # verify against the periodic numpy oracle
    interior = np.random.default_rng(0).normal(size=dom.global_interior).astype(np.float32)
    want = interior.copy()
    for _ in range(args.cycles):
        want = periodic_oracle_step(want, w)
    drv = make_driver(config(args.strategy or "persistent"), dom.mesh, dom.halo_spec,
                      ndim=3, update_fn=update)
    x = dom.from_global_interior(interior)
    for _ in range(args.cycles):
        x = drv.step(x)
    got = dom.to_global_interior(drv.wait(x))
    resolved = drv.strategy  # the concrete name, also after "auto"
    drv.free()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    tag = f"auto -> {resolved}" if args.strategy == "auto" else (args.strategy or "persistent")
    print(f"{tag}: verified against the periodic numpy oracle")


if __name__ == "__main__":
    main()
