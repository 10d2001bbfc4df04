"""Sequence parallelism on the PyTorch port: ring attention with partitioned
KV exchange and SSM state passing across sequence shards (the counterpart
of ``examples/long_context_ring.py``).

The 8 sequence shards are the stacked ranks of a ``(1, 8)`` ``("data",
"model")`` ``VirtualMesh`` on one device: every rank's shard is a row of
one tensor, and a ring hop is one gather over the rank dim.  The ring
exchange is the paper's partitioned pipeline with attention as the
consumer: each KV partition is handed on as soon as it is available while
the previous one is attended to.

    PYTHONPATH=src python examples/long_context_ring_torch.py [--seq 512] [--device cpu]

Without ``--device cpu`` it runs on the card (and raises where there is
none).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.mesh import make_mesh
from repro_torch.core.ring import ring_attention
from repro_torch.models import build_model, concrete_batch
from repro_torch.parallel.context import ParallelContext

SHARDS = 8
B, H, HKV, D = 2, 8, 4, 32


def stack_shards(x: torch.Tensor, ranks: int) -> torch.Tensor:
    """``(B, S, ...)`` cut along the sequence into ``ranks`` shards, stacked
    as ``(ranks, B, S / ranks, ...)``."""
    return x.unflatten(1, (ranks, x.shape[1] // ranks)).movedim(1, 0).contiguous()


def unstack_shards(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`stack_shards`."""
    return x.movedim(0, 1).flatten(1, 2)


def ring_cells(qs, ks, vs, mesh, parts: int, sync=lambda: None) -> tuple:
    """Causal ring attention of the stacked shards, fused (``n_parts`` 1)
    and partitioned (``parts``): each one's output and ms a call (5 calls
    after a warm-up)."""
    outs, ms = {}, {}
    for n_parts in (1, parts):
        def call(n=n_parts):
            return ring_attention(qs, ks, vs, mesh, "model", causal=True, n_parts=n)

        with torch.no_grad():
            outs[n_parts] = call()
            sync()
            t0 = time.perf_counter()
            for _ in range(5):
                call()
            sync()
        ms[n_parts] = (time.perf_counter() - t0) / 5 * 1e3
    return outs, ms


def zamba2_losses(cfg, params, batch, mesh, parts: int) -> tuple:
    """zamba2's loss under a local context and a sequence-parallel one (conv
    ghost cells and state passing around the ring), without grad."""
    local = ParallelContext(mesh=mesh, model_axis="model")
    seqp = ParallelContext(mesh=mesh, model_axis="model", seq_parallel=True, n_parts=parts)
    with torch.no_grad():
        return (model_loss(cfg, params, batch, local, mesh.device),
                model_loss(cfg, params, batch, seqp, mesh.device))


def model_loss(cfg, params, batch, ctx, device) -> float:
    return float(build_model(cfg, device).loss(params, batch, ctx=ctx))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = make_mesh((1, SHARDS), ("data", "model"), device=args.device)
    dev = mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(B, args.seq, H, D)), dtype=torch.float32, device=dev)
    k = torch.as_tensor(rng.normal(size=(B, args.seq, HKV, D)), dtype=torch.float32, device=dev)
    v = torch.as_tensor(rng.normal(size=(B, args.seq, HKV, D)), dtype=torch.float32, device=dev)

    print(f"ring attention over seq={args.seq} on {SHARDS} sequence shards ({dev})")
    outs, ms = ring_cells(*(stack_shards(t, SHARDS) for t in (q, k, v)), mesh, args.parts,
                          sync)
    for n_parts, label in ((1, "fused (persistent-style)"),
                           (args.parts, f"partitioned (n_parts={args.parts})")):
        print(f"  {label:32s} {ms[n_parts]:7.2f} ms/call")

    # full end-to-end: zamba2 (SSM + shared attention) with sequence-parallel
    # prefill: conv ghost cells + associative state passing around the ring.
    cfg = get_config("zamba2-1.2b").reduced()
    params = build_model(cfg, dev).init(1)
    batch = concrete_batch(cfg, 4, args.seq // 4, seed=1, device=dev)
    want, got = zamba2_losses(cfg, params, batch, mesh, args.parts)
    print(f"zamba2 seq-parallel loss {got:.5f} vs local {want:.5f}")
    np.testing.assert_allclose(got, want, rtol=2e-2)
    print("sequence-parallel == local ✓")
    return {"ring": {n: unstack_shards(o) for n, o in outs.items()}, "ms": ms,
            "loss_local": want, "loss_seqp": got}


if __name__ == "__main__":
    main()
