"""How often a ``torch.profiler`` session records no device activity over
the exchange cycles of ``chip_smoke.py`` phase E's breakdown, with and
without PyTorch's CUPTI teardown between sessions.

Each round builds phase E's breakdown cells (the (1024, 1024, 512) f32
interior on a ``(4, 2)`` mesh, packer ``cuda``, coalesced; ``standard``
eager, the other strategies CUDA-graph plans), calls
``repro_torch.stencil.comb.device_breakdown`` on each and frees the driver,
as phase E does.  Each ``--env`` runs the rounds in a child process of its
own: ``default`` with PyTorch's default, which tears CUPTI down after every
session (PyTorch turns that off itself only for inductor's CUDA graphs,
citing crashes at CUPTI's re-init), ``keep`` with ``TEARDOWN_CUPTI=0``.
Each child prints one JSON line: the calls, the sessions each took
(``core.profiling.TRACES``), the calls whose every session was empty, the
empty sessions' host events and CUDA runtime launch calls by strategy, and
the range of the traces' clock-check gaps.  Run from a checkout's root on a machine
with a card::

    PYTHONPATH=src python3 tools/trace_sessions.py [--rounds 15] [--env default,keep]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

INTERIOR = (1024, 1024, 512)
STRATEGIES = ("standard", "persistent", "partitioned", "fused", "overlap")
ENVS = {"default": {}, "keep": {"TEARDOWN_CUPTI": "0"}}


def child(rounds: int, label: str) -> dict:
    import torch

    from repro_torch.core import profiling
    from repro_torch.core.mesh import make_mesh
    from repro_torch.stencil import Domain, StrategyConfig, comb, make_driver

    dev = "cuda"
    dom = Domain(make_mesh((4, 2), ("px", "py"), device=dev), INTERIOR, ("px", "py", None))
    x = dom.random(0)
    empty: dict[str, list] = {name: [] for name in STRATEGIES}
    failed: dict[str, int] = {name: 0 for name in STRATEGIES}
    t0 = time.perf_counter()
    for _ in range(rounds):
        for name in STRATEGIES:
            drv = make_driver(StrategyConfig(name=name, packer="cuda",
                                             n_parts=4 if name == "partitioned" else 1),
                              dom.mesh, dom.halo_spec, ndim=3)
            x = drv.wait(drv.step(x))
            try:
                b = comb.device_breakdown(drv, x)
                empty[name] += b["empty_sessions"]
            except RuntimeError:
                failed[name] += 1
            drv.free()
    torch.cuda.synchronize()
    traces = profiling.TRACES
    gaps = [t[k] for t in traces for k in ("first_launch_to_device_us",
                                           "last_device_to_sync_end_us") if t.get(k) is not None]
    return dict(env=label, teardown_cupti=os.environ.get("TEARDOWN_CUPTI", "(unset)"),
                rounds=rounds, calls=len(traces), retraced=sum(t["sessions"] > 1 for t in traces),
                failed=failed, empty_sessions=empty, min_gap_us=min(gaps, default=None),
                max_gap_us=max(gaps, default=None),
                sessions_taken=[t["sessions"] for t in traces],
                seconds=time.perf_counter() - t0, torch=torch.__version__,
                cuda=torch.version.cuda, card=torch.cuda.get_device_name(0))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--env", default="default,keep")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.rounds, args.child)), flush=True)
        return 0
    rc = 0
    for label in args.env.split(","):
        env = {**os.environ, **ENVS[label]}
        r = subprocess.run([sys.executable, __file__, "--rounds", str(args.rounds),
                            "--child", label], env=env, timeout=900)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
