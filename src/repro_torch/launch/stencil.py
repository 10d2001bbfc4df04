"""Multi-process stencil launcher: the real backend behind the ``multihost``
transport (PyTorch port of ``src/repro/launch/stencil.py``).

    PYTHONPATH=src python -m repro_torch.launch.stencil --processes 2 \\
        --device cpu --strategies all --packers slice,cuda --size 16,8

Boots N worker processes that join one ``torch.distributed`` gloo grid (the
first rank hosts the TCP store, the paper's ``mpirun -np N`` analogue),
each stacking ``--ranks-per-process`` ranks of ONE global mesh on its
device, and runs the requested strategy x packer cells through the
``multihost`` transport (:class:`~repro_torch.core.transport.
MultiHostTransport`).  Every cell is verified row by row against the
reference roll (:func:`repro_torch.stencil.domain.reference_exchange`)
before it is timed with :func:`repro_torch.stencil.comb.comb_measure`, so a
cell that moves wrong bytes across the process boundary can never report a
time.  On the card every worker takes the same device (``cuda:0`` on a
one-card machine): NCCL refuses two ranks on one device, so the grid is
gloo, staged through pinned host memory.

The coordinates travel in env vars of the port's own
(``REPRO_TORCH_COORDINATOR`` / ``REPRO_TORCH_NUM_PROCESSES`` /
``REPRO_TORCH_PROCESS_ID`` / ``REPRO_TORCH_CONNECT_TIMEOUT``, set by
:func:`worker_env`, and ``REPRO_TORCH_MEMBERSHIP`` for a grid launched
with a membership service, :mod:`repro_torch.launch.membership`), never
the JAX package's ``REPRO_*``, so a JAX worker and a port worker never join
each other's grid.  A worker calls
:func:`maybe_initialize_from_env` before its first collective; anything
launched through :func:`launch_grid` (this CLI, the sweep's
``--processes`` fan-out) joins the same grid protocol.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Mapping, Sequence

#: env vars carrying the grid coordinates to worker processes
COORDINATOR_VAR = "REPRO_TORCH_COORDINATOR"
NUM_PROCESSES_VAR = "REPRO_TORCH_NUM_PROCESSES"
PROCESS_ID_VAR = "REPRO_TORCH_PROCESS_ID"
#: bound (seconds) on a worker's connect to the rank-0 store, and on each
#: of its collectives: a worker whose store died before binding, or whose
#: peer died, exits instead of blocking forever
CONNECT_TIMEOUT_VAR = "REPRO_TORCH_CONNECT_TIMEOUT"


def pick_coordinator_port() -> int:
    """A free TCP port for the rank-0 store.

    Inherently racy (TOCTOU): the port is bound, released, and only later
    re-bound by ``torch.distributed`` inside the rank-0 worker — another
    process can steal it in between.  The race cannot be closed from here
    (the store must bind it in a *child* process), so :func:`launch_grid`
    treats a store bind failure as retryable and relaunches with a fresh
    port (bounded attempts).
    """
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: stderr signatures of the store losing the picked port to the race above
#: (torch's TCPStore reports "The server socket has failed to listen on any
#: local network address ... errno: 98 - Address already in use") — and
#: nothing else: injected chaos failures, assertion deaths, or OOMs must
#: never be retried into silence
_PORT_RACE_SIGNATURES = (
    "address already in use",
    "eaddrinuse",
    "failed to bind",
    "errno 98",
    "errno: 98",
    "failed to listen on any local network address",
)


def is_port_race_failure(errs: Sequence[str], returncodes: Sequence[int]) -> bool:
    """Did this grid die because the store's port was stolen?"""
    return any(
        rc != 0 and any(sig in err.lower() for sig in _PORT_RACE_SIGNATURES)
        for err, rc in zip(errs, returncodes)
    )


def worker_env(
    *,
    coordinator: str | None = None,
    num_processes: int = 1,
    process_id: int = 0,
    base: Mapping[str, str] | None = None,
    connect_timeout: float | None = None,
    membership: str | None = None,
) -> dict[str, str]:
    """The environment one worker process boots with.

    Prepends this checkout's ``src`` to ``PYTHONPATH`` so spawned workers
    resolve the same ``repro_torch``.  With ``coordinator`` set the grid
    coordinates and the connect bound are stamped (and gloo is pointed at
    the loopback interface for a ``127.0.0.1`` store, unless the caller
    chose an interface); without it every grid variable is scrubbed, so a
    worker never inherits stale coordinates.  ``membership`` (``host:port``
    of the rank-0 membership service) is stamped as
    ``REPRO_TORCH_MEMBERSHIP`` by the same rule: scrubbed when absent.
    """
    from repro_torch.launch.membership import MEMBERSHIP_VAR

    env = dict(os.environ if base is None else base)
    if coordinator is not None:
        env[COORDINATOR_VAR] = coordinator
        env[NUM_PROCESSES_VAR] = str(num_processes)
        env[PROCESS_ID_VAR] = str(process_id)
        if coordinator.startswith("127.0.0.1:"):
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    else:
        for var in (COORDINATOR_VAR, NUM_PROCESSES_VAR, PROCESS_ID_VAR):
            env.pop(var, None)
    if connect_timeout is not None and coordinator is not None:
        env[CONNECT_TIMEOUT_VAR] = str(connect_timeout)
    else:
        env.pop(CONNECT_TIMEOUT_VAR, None)
    if membership is not None:
        env[MEMBERSHIP_VAR] = membership
    else:
        env.pop(MEMBERSHIP_VAR, None)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def maybe_initialize_from_env() -> int:
    """Join the process grid named by the ``REPRO_TORCH_*`` env vars; return
    this process's rank.

    No-op (rank 0 of a 1-process world) when the variables are absent, so
    worker entry points stay runnable standalone.  The grid is gloo
    (``init_process_group`` with the connect bound as its timeout); where
    there is a card, the worker takes device ``rank % device_count()``
    (every worker the same card on a one-card machine).
    """
    coordinator = os.environ.get(COORDINATOR_VAR)
    if not coordinator:
        return 0
    import torch
    import torch.distributed as dist

    num_processes = int(os.environ[NUM_PROCESSES_VAR])
    process_id = int(os.environ[PROCESS_ID_VAR])
    timeout = float(os.environ.get(CONNECT_TIMEOUT_VAR) or 1800.0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout),
    )
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    return process_id


def process_grid() -> tuple[int, int]:
    """``(processes, rank)`` of this process's ``torch.distributed`` grid;
    ``(1, 0)`` outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True)
class GridResult:
    """Per-rank outcome of a ``check=False`` grid launch: what the chaos
    checks need in place of the raise-on-failure contract.  A rank the
    launcher reaped has a negative return code."""

    outs: tuple[str, ...]
    errs: tuple[str, ...]
    returncodes: tuple[int, ...]

    @property
    def ok(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)

    @property
    def failed_ranks(self) -> tuple[int, ...]:
        return tuple(r for r, rc in enumerate(self.returncodes) if rc != 0)


def _launch_grid_once(
    argv: Sequence[str],
    *,
    processes: int,
    timeout: float,
    env: Mapping[str, str] | None,
    reap_grace: float = 10.0,
    membership: bool = False,
) -> GridResult:
    """One grid attempt against a freshly picked store port.

    A rank exiting nonzero dooms the whole SPMD grid, so the wait is a
    poll: once the first failure lands, the remaining ranks get
    ``reap_grace`` seconds to die on their own (gloo reports a dead peer),
    then any still-running rank is killed and reported in
    :attr:`GridResult.failed_ranks`.  Without the reap, a worker blocked on
    a dead store or in a ``recv`` from a dead peer would hold the grid for
    its whole ``timeout``.  The worker-side half is the
    ``REPRO_TORCH_CONNECT_TIMEOUT`` bound stamped into every rank's env.

    With ``membership`` a second port, for the rank-0 membership service
    (:mod:`repro_torch.launch.membership`), is picked here and advertised
    to every rank as ``REPRO_TORCH_MEMBERSHIP``; the rank-0 program binds
    it with :func:`repro_torch.launch.membership.serve_from_env`.
    """
    coordinator = f"127.0.0.1:{pick_coordinator_port()}"
    membership_addr = f"127.0.0.1:{pick_coordinator_port()}" if membership else None
    procs, files = [], []
    deadline = time.monotonic() + timeout
    reap_at = None  # set when the first rank dies nonzero
    try:
        for rank in range(processes):
            # spool each rank's streams to temp files: a chatty rank can
            # never fill a pipe and stall the collectives of the whole grid
            out_f = tempfile.TemporaryFile(mode="w+")
            err_f = tempfile.TemporaryFile(mode="w+")
            files.append((out_f, err_f))
            procs.append(subprocess.Popen(
                list(argv),
                env=worker_env(coordinator=coordinator, num_processes=processes,
                               process_id=rank, base=env, connect_timeout=timeout,
                               membership=membership_addr),
                stdout=out_f, stderr=err_f, text=True,
            ))
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if now >= deadline:  # ONE shared wall-clock budget
                raise RuntimeError(
                    f"grid did not complete within {timeout:.0f}s "
                    f"({sum(p.poll() is None for p in procs)} of {processes} ranks still running)"
                )
            if reap_at is None and any(p.poll() is not None and p.returncode != 0 for p in procs):
                reap_at = min(now + reap_grace, deadline)
            if reap_at is not None and now >= reap_at:
                break
            time.sleep(0.05)
    finally:
        for p in procs:  # one rank dying must not strand the others
            if p.poll() is None:
                p.kill()
                p.wait()
        outs, errs = [], []
        for out_f, err_f in files:
            out_f.seek(0)
            err_f.seek(0)
            outs.append(out_f.read())
            errs.append(err_f.read())
            out_f.close()
            err_f.close()
    return GridResult(outs=tuple(outs), errs=tuple(errs),
                      returncodes=tuple(p.returncode for p in procs))


def launch_grid(
    argv: Sequence[str],
    *,
    processes: int,
    timeout: float = 900.0,
    env: Mapping[str, str] | None = None,
    check: bool = True,
    attempts: int = 3,
    reap_grace: float = 10.0,
    membership: bool = False,
) -> str | GridResult:
    """Run ``argv`` as an N-process ``torch.distributed`` grid; return rank
    0's stdout.

    All ranks execute the same SPMD program; by convention only rank 0
    prints results.  Any rank exiting nonzero fails the whole grid with
    that rank's stderr tail.  With ``check=False`` no rank failure raises:
    the full :class:`GridResult` is returned instead, for callers that
    *expect* the grid to die (the chaos checks) or read every rank.

    A grid whose failure stderr matches a port-bind signature
    (:func:`is_port_race_failure`) is relaunched with a fresh port, up to
    ``attempts`` tries; real failures surface at once.  ``timeout`` is the
    wall-clock bound of each attempt, and each worker's connect and
    collective bound.  ``membership`` advertises a port for the rank-0
    membership service (see :func:`_launch_grid_once`).
    """
    if processes < 1 or attempts < 1:
        raise ValueError((processes, attempts))
    for attempt in range(1, attempts + 1):
        result = _launch_grid_once(argv, processes=processes, timeout=timeout, env=env,
                                   reap_grace=reap_grace, membership=membership)
        if result.ok or not (attempt < attempts
                             and is_port_race_failure(result.errs, result.returncodes)):
            break
        print(f"# launch_grid: store port stolen (attempt {attempt} of {attempts}); "
              f"retrying with a fresh port", file=sys.stderr)
    if not check:
        return result
    if not result.ok:
        detail = "\n".join(
            f"--- rank {r} (exit {result.returncodes[r]}) ---\n{result.errs[r][-4000:]}"
            for r in result.failed_ranks
        )
        raise RuntimeError(f"grid ranks {list(result.failed_ranks)} of {processes} failed:\n{detail}")
    return result.outs[0]


# ---------------------------------------------------------------------------
# worker side: verify + measure on the global mesh
# ---------------------------------------------------------------------------


def global_stencil_mesh(
    n_ranks: int,
    *,
    mapping: str = "row-major",
    node_size: int = 0,
    device=None,
):
    """A 1-axis mesh of ``n_ranks`` ranks over this process's grid (every
    rank derives the same mesh and stacks its own rows of it).
    ``mapping`` places ranks on coordinates through the registered
    :class:`repro_torch.launch.mapping.Mapping`, around ``node_size`` ranks
    a node (0: the ranks of one process); ``"auto"`` resolves to the
    mapping with the fewest inter-node neighbor sends
    (:func:`repro_torch.core.autotune.choose_mapping`)."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch.mapping import default_node_size, get_mapping

    processes, rank = process_grid()
    if node_size <= 0:
        node_size = default_node_size(n_ranks, processes)
    if mapping == "auto":
        from repro_torch.core.autotune import choose_mapping

        mapping = choose_mapping((n_ranks,), node_size)
    return make_mesh((n_ranks,), ("px",), device=device,
                     placement=get_mapping(mapping).placement((n_ranks,), node_size),
                     processes=processes, process_index=rank)


def verify_strategy_cell(
    domain,
    *,
    strategy: str,
    packer: str = "slice",
    transport: str = "multihost",
    n_parts: int = 3,
    seed: int = 7,
    coalesce: bool = True,
    mapping: str = "row-major",
) -> None:
    """One correctness cell: exchange on the (possibly multi-process) mesh,
    then compare this process's rows against the reference roll of the
    same numpy interior.  Exact packers are held bitwise; wire-compressed
    ones to their :meth:`~repro_torch.core.transport.Packer.wire_tolerance`."""
    import numpy as np
    import torch

    from repro_torch.core.transport import get_packer
    from repro_torch.stencil.domain import reference_exchange
    from repro_torch.stencil.strategies import StrategyConfig, make_driver

    interior = np.random.default_rng(seed).normal(size=domain.global_interior).astype(np.float32)
    want = reference_exchange(domain, interior)
    drv = make_driver(
        StrategyConfig(name=strategy, n_parts=n_parts, packer=packer, transport=transport,
                       coalesce=coalesce, mapping=mapping),
        domain.mesh, domain.halo_spec, ndim=len(domain.global_interior),
    )
    try:
        got = drv.wait(drv.step(domain.from_global_interior(interior)))
    finally:
        drv.free()
    rtol, atol = get_packer(packer).wire_tolerance(domain.dtype)
    msg = (f"{strategy}@{packer}/{transport} n_parts={n_parts} coalesce={coalesce} "
           f"(process {domain.mesh.process_index} of {domain.mesh.processes}, coordinates "
           f"{domain.mesh.local_coords})")
    if rtol == 0.0 and atol == 0.0:
        if not torch.equal(got, want):
            raise AssertionError(f"{msg}: rows differ from reference_exchange")
    elif not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{msg}: rows outside the wire tolerance ({rtol}, {atol})")


def run_cell(
    *,
    size: tuple[int, ...],
    strategies: Sequence[str],
    packers: Sequence[str],
    transport: str = "multihost",
    ranks_per_process: int = 2,
    halo: int = 1,
    n_parts: int = 3,
    n_cycles: int = 10,
    repeats: int = 1,
    seed: int = 0,
    mapping: str = "row-major",
    device=None,
    emit: Callable[[str], Any] = print,
) -> list[dict]:
    """Verify + measure the strategy x packer cells on the global mesh of
    ``ranks_per_process`` ranks a process.  Returns the flat records of
    :func:`repro_torch.stencil.comb.comb_measure` (one per cell); callers
    decide what rank prints."""
    from repro_torch.stencil.comb import comb_measure
    from repro_torch.stencil.domain import Domain
    from repro_torch.stencil.strategies import StrategyConfig, get_strategy

    processes, _ = process_grid()
    n = processes * ranks_per_process
    if mapping == "auto":
        # resolve before any StrategyConfig sees it: the placement is fixed
        # when the mesh is built
        from repro_torch.core.autotune import choose_mapping
        from repro_torch.launch.mapping import default_node_size

        mapping = choose_mapping((n,), default_node_size(n, processes))
        emit(f"# mapping=auto resolved to {mapping}")
    mesh = global_stencil_mesh(n, mapping=mapping, device=device)
    if size[0] % n or size[0] // n < 3 * halo:
        raise ValueError(f"size {size} not decomposable over {n} ranks with halo {halo}")
    domain = Domain(mesh, tuple(size), ("px",) + (None,) * (len(size) - 1), halo=halo)
    configs = []
    for packer in packers:
        for s in strategies:
            parts = 1 if s == "auto" or not get_strategy(s).uses_partitions else n_parts
            verify_strategy_cell(domain, strategy=s, packer=packer, transport=transport,
                                 n_parts=parts, mapping=mapping)
            emit(f"VERIFIED {s}@{packer}/{transport} on {n} ranks across {processes} processes")
            configs.append(StrategyConfig(name=s, n_parts=parts, packer=packer,
                                          transport=transport, mapping=mapping))
    results = comb_measure(domain, strategies=tuple(configs), n_cycles=n_cycles,
                           repeats=repeats, seed=seed)
    records = []
    for label, res in results.items():
        records.append({
            "label": label,
            "n_devices": n,
            "process_count": processes,
            "is_multihost": processes > 1,
            "global_interior": list(size),
            **res.record(),
        })
        emit(f"{label}: {res.us_per_cycle:.1f} us/cycle (init {res.init_us:.0f} us)")
    return records


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--processes", type=int, default=2,
                    help="process-grid size (ranks of the torch.distributed grid)")
    ap.add_argument("--ranks-per-process", type=int, default=2,
                    help="mesh ranks each process stacks")
    ap.add_argument("--device", default="cuda",
                    help="where each process holds its ranks: cuda (the default; raises "
                         "without a card) or cpu")
    ap.add_argument("--strategies", default="all",
                    help="comma list of registered strategies, 'all', or 'auto'")
    ap.add_argument("--packers", default="slice",
                    help="comma list of registered packers, or 'all'")
    ap.add_argument("--transport", default="multihost",
                    help="registered transport every cell routes through")
    ap.add_argument("--mapping", default="row-major",
                    help="registered process-to-node mapping (row-major|blocked|rb), or "
                         "'auto'")
    ap.add_argument("--size", default="16,8", help="global interior shape, comma-separated")
    ap.add_argument("--halo", type=int, default=1)
    ap.add_argument("--n-parts", type=int, default=3)
    ap.add_argument("--n-cycles", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="wall-clock limit of the grid, and each worker's connect and "
                         "collective bound (seconds)")
    args = ap.parse_args(argv)

    from repro_torch.launch.mapping import canonical_mapping

    if args.mapping != "auto":
        try:  # fail in the launcher, not N spawned ranks deep
            canonical_mapping(args.mapping)
        except KeyError as e:
            ap.error(str(e))
    if args.processes < 1 or args.ranks_per_process < 1:
        ap.error("--processes and --ranks-per-process must be >= 1")

    if COORDINATOR_VAR not in os.environ:
        from repro_torch.core.compat import resolve_device

        resolve_device(args.device)  # no card: raise here, not in every worker
        out = launch_grid(
            [sys.executable, "-m", "repro_torch.launch.stencil",
             *(sys.argv[1:] if argv is None else argv)],
            processes=args.processes, timeout=args.timeout,
        )
        print(out, end="")
        return

    # worker: join the grid, then run the cells; only rank 0 reports
    rank = maybe_initialize_from_env()
    from repro_torch.core.transport import available_packers
    from repro_torch.stencil.strategies import available_strategies

    strategies = (available_strategies() if args.strategies == "all"
                  else tuple(args.strategies.split(",")))
    packers = available_packers() if args.packers == "all" else tuple(args.packers.split(","))
    emit = print if rank == 0 else (lambda *_: None)
    records = run_cell(
        size=tuple(int(s) for s in args.size.split(",")), strategies=strategies,
        packers=packers, transport=args.transport, ranks_per_process=args.ranks_per_process,
        halo=args.halo, n_parts=args.n_parts, n_cycles=args.n_cycles, repeats=args.repeats,
        seed=args.seed, mapping=args.mapping, device=args.device, emit=emit,
    )
    emit(f"# {len(records)} multihost cells OK")


if __name__ == "__main__":
    main()
