"""Which ``torch.distributed`` backends a grid of processes that share ONE
card can move data through: the facts the ``multihost`` transport is built
on (gloo over pinned host buffers).

Boots a grid of 2 processes (``repro_torch.launch.stencil.launch_grid``,
gloo, both on ``cuda:0``) in which each process tries, in turn:

* ``gloo_cpu``: a gloo ``isend``/``irecv`` of a CPU tensor with the other;
* ``nccl``: an NCCL group of the two processes and an ``all_reduce`` of a
  CUDA tensor over it;
* ``gloo_cuda``: the gloo exchange with a CUDA tensor (last: gloo then
  reads device memory as host memory, which may abort the process).

Each attempt prints one JSON line (``"ok"`` or the error it raised), so a
process that dies on a later attempt keeps its earlier lines.  The parent
prints every process's lines, whether a process's output holds NCCL's
"Duplicate GPU detected", and a summary line.  Run from a checkout's root
on a machine with a card::

    PYTHONPATH=src python3 tools/grid_backends.py
"""

from __future__ import annotations

import json
import os
import sys

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _attempt(results: dict, key: str, fn) -> None:
    try:
        fn()
        results[key] = "ok"
    except Exception as e:  # the error IS the result: report it and go on
        results[key] = f"{type(e).__name__}: {str(e)[:400]}"
    print(json.dumps({"rank": results["rank"], key: results[key]}), flush=True)


def worker() -> None:
    sys.path.insert(0, _SRC)
    from repro_torch.launch.stencil import maybe_initialize_from_env

    rank = maybe_initialize_from_env()
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    peer = 1 - rank
    results = {"rank": rank}
    print(json.dumps({"rank": rank, "device": str(dev),
                      "name": torch.cuda.get_device_name(dev)}), flush=True)

    def swap(t: torch.Tensor) -> None:
        got = torch.empty_like(t)
        works = [dist.irecv(got, peer, tag=1), dist.isend(t, peer, tag=1)]
        for w in works:
            w.wait()
        if float(got.sum()) != 4.0 * peer:
            raise AssertionError(f"received {got.tolist()}")

    def nccl() -> None:
        group = dist.new_group([0, 1], backend="nccl")
        x = torch.ones(4, device=dev)
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize(dev)

    _attempt(results, "gloo_cpu", lambda: swap(torch.full((4,), float(rank))))
    _attempt(results, "nccl", nccl)
    dist.barrier()  # both processes are past NCCL before either tries gloo on the card
    _attempt(results, "gloo_cuda", lambda: swap(torch.full((4,), float(rank), device=dev)))


def main() -> int:
    sys.path.insert(0, _SRC)
    from repro_torch.launch.stencil import launch_grid

    res = launch_grid([sys.executable, os.path.abspath(__file__), "--worker"], processes=2,
                      timeout=120.0, check=False, attempts=1, reap_grace=20.0)
    summary = {"returncodes": list(res.returncodes)}
    for rank, (out, err) in enumerate(zip(res.outs, res.errs)):
        for line in out.splitlines():
            print(line)
            if line.startswith("{"):
                summary.setdefault(f"rank{rank}", {}).update(json.loads(line))
        summary[f"rank{rank}_duplicate_gpu"] = "Duplicate GPU detected" in out + err
        if res.returncodes[rank] != 0:
            print(f"--- rank {rank} stderr (exit {res.returncodes[rank]}) ---\n{err[-2000:]}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker()
    else:
        sys.exit(main())
