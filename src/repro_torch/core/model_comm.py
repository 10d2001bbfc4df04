"""Analytic performance model for stencil halo exchange (Quartz-class CPU
cluster): a copy of ``src/repro/core/model_comm.py`` for the PyTorch port.

It is pure Python, so the port keeps its own copy rather than importing the
JAX package; every function and constant is the original's, and the
arithmetic runs in the same order, so every field of :func:`simulate`
equals the original's bit for bit (``tests/test_torch_model_comm.py``).

The paper's *timings* come from a cluster; what the model reproduces is the
paper's *model of why* each strategy wins or loses.  It is a LogGP-style
discrete-event model of one halo-exchange iteration under the three
strategies, with the cost terms the paper identifies:

* per-message host posting overhead (``o_msg``), reduced to ``o_persist_msg``
  by persistent init (amortized ``o_persist_init``);
* per-partition overhead ``o_part`` (``MPI_Pready`` + ``MPI_THREAD_MULTIPLE``
  serialization) — this is what makes partitioned *lose* for small messages
  and large partition counts (paper Figs. 4, 5);
* pack/unpack at ``pack_bw`` per OpenMP thread, with partition packing
  *overlapping* injection in the partitioned strategy (the core win);
* NIC serialization (``alpha`` + ``beta``·bytes per transfer) shared by all
  ranks on a node, with a weak-scaling contention factor (paper Fig. 2's
  rising, converging curves).

Its calibrated constants are in ``repro_torch/configs/comb_paper.py``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MachineModel:
    """Cost constants for a Quartz-class node (calibrated in configs/comb_paper)."""

    alpha: float = 1.6e-6  # per-transfer wire latency (s)
    nic_bw: float = 12.5e9  # node NIC bandwidth (bytes/s), Omni-Path 100 Gb/s
    mem_bw: float = 5.0e9  # on-node transfer bandwidth per rank-pair (bytes/s)
    o_msg: float = 1.1e-6  # host posting overhead per message (Isend/Irecv)
    o_persist_msg: float = 0.35e-6  # posting overhead per message (Start)
    o_persist_init: float = 25e-6  # one-time init per message (Send_init)
    o_part: float = 1.0e-6  # per-partition overhead (Pready + THREAD_MULTIPLE)
    pack_bw: float = 2.2e9  # pack/unpack bytes/s per OpenMP thread
    thread_launch: float = 4.0e-6  # per parallel-region launch cost
    socket_split_penalty: float = 2.0  # o_part multiplier when threads span sockets
    threads_per_socket: int = 32
    contention_base: int = 64  # procs at which contention starts
    contention_coef: float = 0.055  # beta multiplier growth per log2(procs)
    on_node_fraction: float = 0.55  # fraction of neighbor bytes staying on-node
    # --- persistent-path savings (Hatanaka'13-style: what *_init amortizes) ---
    proto_frac: float = 0.16  # per-byte protocol/registration overhead the
    #   standard path pays and persistent channels avoid (pre-pinned buffers)
    eager_threshold: int = 16384  # bytes; above it the standard path pays a
    rdv_rtt_factor: float = 2.0  # rendezvous RTS/CTS handshake of this many
    #   alphas per message (persistent pre-negotiates after init)
    # --- partitioned-path savings (paper §II-B: "utilizing the network early
    #   rather than sending all data at once") ---
    burst_penalty: float = 0.22  # incast/burst contention multiplier on beta
    #   when a rank injects all messages back-to-back after packing
    #   (standard & persistent); partitioned's staggered injection avoids it.
    burst_scale: float = 0.35  # growth of the burst penalty per log2(procs)
    #   beyond contention_base (congestion relief matters more at scale)
    # --- MPI_THREAD_MULTIPLE serialization (paper: "can cause slowdowns that
    #   vary greatly among versions of MPI") ---
    tm_coef: float = 0.06  # per-thread growth of o_part under THREAD_MULTIPLE
    cores: int = 32  # active cores per node (paper: 32 of 36)
    ht_eff: float = 0.25  # marginal efficiency of the 2nd hyperthread

    def beta_eff(self, nprocs: int, ranks_per_node: int) -> float:
        """Effective per-rank off-node seconds/byte including NIC sharing and
        at-scale contention."""
        share = self.nic_bw / max(1, ranks_per_node)
        beta = 1.0 / share
        if nprocs > self.contention_base:
            beta *= 1.0 + self.contention_coef * math.log2(
                nprocs / self.contention_base
            )
        return beta

    def burst_eff(self, nprocs: int) -> float:
        """Burst/incast penalty grows with job scale (more flows per switch)."""
        scale = 1.0
        if nprocs > self.contention_base:
            scale += self.burst_scale * math.log2(nprocs / self.contention_base)
        return self.burst_penalty * scale

    def pack_threads_eff(self, threads: int, ranks_per_node: int) -> float:
        """Packing threads beyond a rank's physical cores only add hyperthread
        headroom (paper runs 2 threads/core)."""
        rank_cores = max(1, self.cores // max(1, ranks_per_node))
        if threads <= rank_cores:
            return float(max(1, threads))
        return rank_cores + (threads - rank_cores) * self.ht_eff


@dataclass(frozen=True)
class StencilWorkload:
    """Per-rank halo-exchange workload for a 27-point 3-D stencil."""

    local_cells: tuple[int, int, int]
    vars_per_cell: int = 3
    halo: int = 1
    elem_bytes: int = 8  # doubles

    def messages(self) -> list[int]:
        """Byte sizes of the 26 neighbor messages (6 faces, 12 edges, 8 corners)."""
        nx, ny, nz = self.local_cells
        unit = self.vars_per_cell * self.elem_bytes * self.halo
        faces = [ny * nz, ny * nz, nx * nz, nx * nz, nx * ny, nx * ny]
        edges = [nx] * 4 + [ny] * 4 + [nz] * 4
        corners = [1] * 8
        return [c * unit for c in faces + edges + corners]

    @staticmethod
    def from_face_doubles(face_doubles: int, vars_per_cell: int = 3) -> "StencilWorkload":
        """Workload whose *face* messages carry ``face_doubles`` doubles
        (how Figs. 2 and 4 parametrize size)."""
        face_cells = max(1, face_doubles // vars_per_cell)
        n = max(1, round(face_cells ** 0.5))
        return StencilWorkload((n, n, n), vars_per_cell)

    @staticmethod
    def from_global_mesh(
        global_cells: tuple[int, int, int], nprocs: int, vars_per_cell: int = 3
    ) -> "StencilWorkload":
        """Split a global mesh over ``nprocs`` (near-cubic process grid)."""
        grid = _near_cubic_grid(nprocs)
        local = tuple(
            max(1, g // p) for g, p in zip(global_cells, grid)
        )
        return StencilWorkload(local, vars_per_cell)  # type: ignore[arg-type]


def _near_cubic_grid(n: int) -> tuple[int, int, int]:
    best = (n, 1, 1)
    best_score = float("inf")
    for a in range(1, int(round(n ** (1 / 3))) + 2):
        if n % a:
            continue
        m = n // a
        for b in range(a, int(math.isqrt(m)) + 1):
            if m % b:
                continue
            c = m // b
            dims = (a, b, c)
            score = max(dims) / min(dims)
            if score < best_score:
                best_score, best = score, dims
    return best


@dataclass
class TimeBreakdown:
    pack: float = 0.0
    post: float = 0.0
    net_exposed: float = 0.0  # network time not hidden behind packing
    unpack: float = 0.0
    part_overhead: float = 0.0
    thread_launch: float = 0.0
    init_amortized: float = 0.0

    @property
    def total(self) -> float:
        return (
            self.pack
            + self.post
            + self.net_exposed
            + self.unpack
            + self.part_overhead
            + self.thread_launch
            + self.init_amortized
        )


def _pack_finish_times(
    items: list[int], threads: int, pack_bw: float
) -> list[float]:
    """Round-robin the pack work items over ``threads``; return each item's
    completion time (staggered — this is what partitioned overlap exploits)."""
    t = [0.0] * max(1, threads)
    finish = []
    for i, nbytes in enumerate(items):
        th = i % max(1, threads)
        t[th] += nbytes / pack_bw
        finish.append(t[th])
    return finish


def simulate(
    strategy: str,
    machine: MachineModel,
    workload: StencilWorkload,
    *,
    nprocs: int,
    ranks_per_node: int = 32,
    threads: int = 2,
    n_parts: int | None = None,
    iters: int = 1000,
) -> TimeBreakdown:
    """Model one rank's halo-exchange iteration cost (seconds) under a strategy.

    ``n_parts`` defaults to ``threads`` (the paper binds one partition per
    packing thread).  ``iters`` only affects amortized persistent init.
    """
    assert strategy in ("standard", "persistent", "partitioned"), strategy
    msgs = workload.messages()
    n_msgs = len(msgs)
    total_bytes = sum(msgs)
    beta_off = machine.beta_eff(nprocs, ranks_per_node)
    beta_on = 1.0 / machine.mem_bw
    beta = (
        machine.on_node_fraction * beta_on
        + (1.0 - machine.on_node_fraction) * beta_off
    )
    if nprocs <= ranks_per_node:
        beta = beta_on  # single-node job: all neighbors on-node
    teff = machine.pack_threads_eff(threads, ranks_per_node)
    tb = TimeBreakdown()
    tb.thread_launch = 2 * machine.thread_launch  # pack + unpack regions
    tb.unpack = total_bytes / (machine.pack_bw * teff)

    if strategy in ("standard", "persistent"):
        # Alg. 1 / Alg. 3: pack everything, then post, then wait.
        tb.pack = total_bytes / (machine.pack_bw * teff)
        o = machine.o_msg if strategy == "standard" else machine.o_persist_msg
        tb.post = o * n_msgs
        # NIC serializes the injections after packing completes; the
        # back-to-back burst pays an incast/contention penalty that grows
        # with job scale.
        beta_burst = beta * (1.0 + machine.burst_eff(nprocs))
        net = 0.0
        for nbytes in msgs:
            net += machine.alpha + nbytes * beta_burst
            if strategy == "standard":
                # per-iteration protocol work the persistent channel avoids:
                # buffer registration/bookkeeping (per byte) + rendezvous
                # handshake for large messages.
                net += nbytes * beta * machine.proto_frac
                if nbytes > machine.eager_threshold:
                    net += machine.rdv_rtt_factor * machine.alpha
        tb.net_exposed = net
        if strategy == "persistent":
            tb.init_amortized = machine.o_persist_init * n_msgs / max(1, iters)
        return tb

    # partitioned (Alg. 6): Startall, then threads pack partitions and Pready
    # each as it completes; transfers overlap remaining packing.  Every
    # message is split into P equal partitions (padding per the standard).
    P = max(1, n_parts if n_parts is not None else threads)
    tb.post = machine.o_persist_msg * n_msgs
    # MPI_THREAD_MULTIPLE: concurrent Pready/progress calls serialize inside
    # the library; the per-partition cost grows with thread count, and doubles
    # again when the thread team spans sockets (paper Fig. 5's 1-rank cliff).
    o_part = machine.o_part * (1.0 + machine.tm_coef * threads)
    if threads > machine.threads_per_socket:
        o_part *= machine.socket_split_penalty
    items = [nbytes / P for nbytes in msgs for _ in range(P)]
    tb.part_overhead = o_part * len(items)
    ready = _pack_finish_times(items, int(round(teff)), machine.pack_bw)
    # NIC queue: staggered injections — no burst penalty (the paper's "early
    # communication reduces network contention").
    nic_free = 0.0
    done = 0.0
    for r, wire in sorted(zip(ready, items)):
        start = max(r, nic_free)
        nic_free = start + machine.alpha + wire * beta
        done = nic_free
    pack_all = max(ready) if ready else 0.0
    tb.pack = pack_all
    tb.net_exposed = max(0.0, done - pack_all)
    tb.init_amortized = machine.o_persist_init * n_msgs / max(1, iters)
    return tb


def speedup(base: TimeBreakdown, other: TimeBreakdown) -> float:
    """Paper-style speedup of ``other`` over ``base`` in percent."""
    return (base.total / other.total - 1.0) * 100.0
