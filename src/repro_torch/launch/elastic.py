"""Elastic stencil grids: rank loss -> re-mesh -> re-plan -> resume
(PyTorch port of ``src/repro/launch/elastic.py``).

    PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu \\
        --size 16,8 --ranks 4 --fail-step 3

The paper's persistent plans amortize setup over a run's iterations; this
layer is what keeps that argument when the topology changes under a
running exchange.  It joins the fault-tolerance machinery
(:mod:`repro_torch.train.fault_tolerance`) to the stencil stack:

* a :class:`FailureInjector` stands in for the missed-heartbeat signal and
  raises :class:`SimulatedFailure` at adversarial points: before a step,
  mid-exchange (the step is queued on the card, its wait not yet issued),
  or inside a plan build (between coalesced partition rounds, through
  :func:`~repro_torch.core.transport.chaos_scope`);
* on failure the runner re-forms the mesh on the surviving ranks,
  invalidates every cached plan built for the dead one
  (:meth:`~repro_torch.core.plan.PlanCache.invalidate`, counted),
  re-derives the ``Message``/``WireLayout`` tables for the new mesh
  (asserting the derivation is deterministic) and resumes from the last
  committed checkpoint;
* ``replan_us`` (table math alone) and ``init_us`` (the plan's build; on
  the card with its CUDA graph capture) are recorded per event.

Membership-led paths: rank JOIN (``joins=`` / :meth:`request_join` grows
the mesh mid-run and moves the LIVE iterate through
:func:`~repro_torch.train.fault_tolerance.reshard_state`, no checkpoint),
in-grid loss recovery (``recovery_mode="in-grid"``: the coordinator bumps
the epoch, survivors drop only epoch-stale plans and stay warm), and a
dead coordinator (:class:`CoordinatorLost`) falling back to the relaunch
path under a successor service.

Where the port differs from the JAX package:

* **Ranks, not devices.**  On one card the runner's ``devices`` are rank
  slots of a stacked :class:`~repro_torch.core.mesh.VirtualMesh` (a list
  of ints; ``survivor_fn`` and ``joins`` take and return such lists); the
  mesh is ``make_mesh((n,), ("px",), device=...)``.  On a
  ``torch.distributed`` grid the slots are the global mesh's ranks, split
  over the processes.
* **Transport.**  ``loopback`` by default (the port has no ``ppermute``);
  a grid uses ``multihost``, which in one process is ``loopback``.
* **The card.**  A failure mid-exchange lands while a plan's CUDA graph
  replay is still in flight: recovery synchronizes the device before any
  plan's static buffers and graph pool are released.  A JOIN copies the
  live iterate out of the plan-owned output before the plan is freed.
  Each :class:`Recovery` records the device memory at the raise, after the
  dead plans were released and after the first step on the new mesh.
* **Grids.**  The global interior is gathered to process 0
  (:meth:`~repro_torch.stencil.domain.Domain.to_global_interior`), which
  writes the checkpoints and gets ``final_interior`` (the others
  ``None``).  A JOIN on a grid is not supported, as in the JAX package.

Exact packers hold a resumed run to the one-rank oracle **bitwise**: the
update's per-cell arithmetic is the same on every topology, ghosts cross
losslessly and a restore is exact.  ``bf16`` and ``scaled-int8`` re-encode
the ghosts they send, so a resumed run drifts from the exact run within
the packer's ``wire_tolerance`` a step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.compat import device_name, resolve_device, synchronize
from repro_torch.core.plan import PlanCache
from repro_torch.core.transport import chaos_scope
from repro_torch.launch.membership import CoordinatorLost, MembershipService
from repro_torch.train.fault_tolerance import (
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
    reshard_state,
)

#: how the runner recovers from rank loss.  ``"relaunch"``: drop EVERY
#: cached plan, shrink to the survivors, restore the checkpoint (across
#: real processes the grid dies and relaunches).  ``"in-grid"``: the
#: coordinator bumps the epoch, only epoch-stale plans are invalidated,
#: survivors barrier and re-initialize in place, unrelated plans stay warm.
RECOVERY_MODES = ("relaunch", "in-grid")

#: rank slots a runner starts with when the caller names none (the JAX
#: package's test form runs on 8 virtual devices)
DEFAULT_RANKS = 8


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """One elastic stencil run: geometry, strategy cell, and chaos budget."""

    global_interior: tuple[int, ...] = (16, 8)
    halo: int = 1
    strategy: str = "persistent"
    packer: str = "slice"
    transport: str = "loopback"
    coalesce: bool = True
    n_parts: int = 1
    n_steps: int = 8
    #: commit a checkpoint every k completed steps (and at the end); 0
    #: disables checkpointing (oracle runs: nothing to resume)
    checkpoint_every: int = 1
    seed: int = 0
    #: failures survived in process before the last one propagates; 0 lets
    #: the first failure kill the process (the grid mode, where recovery is
    #: a relaunch on the survivor topology)
    max_replans: int = 3
    #: one of :data:`RECOVERY_MODES`
    recovery_mode: str = "relaunch"
    #: membership heartbeat window (in-grid mode only)
    heartbeat_timeout: float = 5.0

    def __post_init__(self):
        assert self.n_steps >= 1, self.n_steps
        assert self.checkpoint_every >= 0, self.checkpoint_every
        assert self.max_replans >= 0, self.max_replans
        assert self.recovery_mode in RECOVERY_MODES, self.recovery_mode


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """One (re-)planning of the exchange on a topology."""

    step: int
    n_devices: int
    #: re-deriving the static Message/WireLayout tables (table math only)
    replan_us: float
    #: the plan's build (on the card with its CUDA graph capture)
    init_us: float
    #: cached plans dropped because their topology died
    plan_invalidations: int
    #: "initial" | "rank-loss" (relaunch) | "loss-ingrid" | "join" |
    #: "coordinator-lost" (relaunch fallback)
    cause: str = "initial"
    #: membership epoch the new plan is stamped under
    epoch: int = 0


@dataclasses.dataclass
class Recovery:
    """What one topology change cost on the device (not in the JAX
    package): seconds from the raise (a JOIN's start; for ``"resume"``, a
    relaunched process's run start) to the end of the first step on the
    new mesh, the checkpoint read, and ``torch.cuda.memory_allocated`` (0
    on the CPU) at the raise, once the dead topology's plans and tensors
    were released, and after that first step."""

    cause: str
    step: int
    recover_s: float = 0.0
    restore_s: float = 0.0
    memory_at_raise: int = 0
    memory_released: int = 0
    memory_after: int = 0
    #: perf_counter at the raise; the clock of recover_s
    t_raise: float = dataclasses.field(default=0.0, repr=False)


@dataclasses.dataclass
class ElasticResult:
    #: the dense global interior (on a grid: process 0's; the others None)
    final_interior: np.ndarray | None
    steps: int
    #: failures survived (re-meshes performed)
    replans: int
    events: list[ReplanEvent]
    #: step of the last checkpoint the run committed (None: never saved)
    checkpoint_step: int | None
    recovery_mode: str = "relaunch"
    #: total us moving LIVE state onto grown meshes across all JOINs
    join_us: float = 0.0
    #: ranks that kept their process + warm plan cache through the most
    #: recent recovery/join (0 after a relaunch)
    warm_ranks: int = 0
    final_epoch: int = 0
    #: (step, seconds, mean) observations the StragglerMonitor flagged
    straggler_flags: list = dataclasses.field(default_factory=list)
    plan_cache_inits: int = 0
    plan_cache_hits: int = 0
    plan_cache_invalidations: int = 0
    #: the strategy cell, for BENCH stamping
    cell: dict = dataclasses.field(default_factory=dict)
    #: the device's name (``"cpu"`` or the card's)
    device: str = "cpu"
    #: one entry a recovery or JOIN
    recoveries: list[Recovery] = dataclasses.field(default_factory=list)
    #: seconds of each checkpoint save this process made
    save_seconds: list[float] = dataclasses.field(default_factory=list)

    def bench_record(self) -> dict:
        """One BENCH row: the JAX package's keys, plus ``device``."""
        return {
            **self.cell,
            "steps": self.steps,
            "replans": self.replans,
            "replan_us": float(sum(e.replan_us for e in self.events)),
            "recovery_mode": self.recovery_mode,
            "join_us": self.join_us,
            "warm_ranks": self.warm_ranks,
            "final_epoch": self.final_epoch,
            "straggler_flags": [list(f) for f in self.straggler_flags],
            "plan_cache_inits": self.plan_cache_inits,
            "plan_cache_hits": self.plan_cache_hits,
            "plan_cache_invalidations": self.plan_cache_invalidations,
            "checkpoint_step": self.checkpoint_step,
            "device": self.device,
        }


def diffusion_update(halo: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Three-point diffusion along each rank's array axis 0 (the
    decomposed axis) of the batched ``(R, *local)`` block, in place.

    ``0.5*mid + 0.25*up + 0.25*down`` in the JAX package's order, as
    separate torch ops (no fused multiply-add), so every topology gives the
    same bits; it writes only the interior and leaves the rim untouched.
    """
    h = halo

    def update(xb: torch.Tensor) -> torch.Tensor:
        s = xb.shape[1]
        up = xb[:, 0:s - 2 * h]
        mid = xb[:, h:s - h]
        down = xb[:, 2 * h:s]
        interior = 0.5 * mid + 0.25 * up + 0.25 * down
        xb[:, h:s - h] = interior
        return xb

    return update


def initial_interior(config: ElasticConfig) -> np.ndarray:
    """The run's deterministic initial condition: the JAX package's numpy
    draw, so both packages start from the same bits."""
    rng = np.random.default_rng(config.seed)
    return rng.normal(size=config.global_interior).astype(np.float32)


def _live_interior(domain, x: torch.Tensor) -> torch.Tensor:
    """A copy of the dense global interior on the domain's device (one
    process; the runner's mesh splits array axis 0 over ``px``)."""
    inner = x[domain.interior_window()]
    return inner.clone(memory_format=torch.contiguous_format).reshape(domain.global_interior)


def _stored_layout(domain, interior: torch.Tensor) -> torch.Tensor:
    """The JAX package's stored layout (ghosted blocks side by side along
    axis 0, ghosts zero) of a dense interior, built on its device."""
    n, h = domain.mesh.size, domain.halo
    local = domain.local_interior
    out = torch.zeros((n, local[0] + 2 * h, *local[1:]), dtype=interior.dtype,
                      device=interior.device)
    out[:, h:h + local[0]] = interior.view(n, *local)
    return out.view(n * (local[0] + 2 * h), *local[1:])


class ElasticStencilRunner:
    """Drive a checkpointed stencil run that survives injected rank loss.

    The runner owns a private :class:`~repro_torch.core.plan.PlanCache` and
    a list of rank slots (its view of the live topology).  ``survivor_fn``
    models which slots outlive a failure: the default keeps the first half;
    the surviving count must still decompose the domain.  The run is on
    ``device`` (the card unless ``"cpu"`` is asked for).
    """

    def __init__(
        self,
        config: ElasticConfig,
        ckpt_dir: str | None,
        *,
        injector: FailureInjector | None = None,
        devices: Sequence[int] | None = None,
        survivor_fn: Callable[[list], list] | None = None,
        update_fn: Callable | None = None,
        membership: MembershipService | None = None,
        straggler: StragglerMonitor | None = None,
        joins: Sequence[tuple[int, Sequence[int]]] = (),
        fail_coordinator_at: int | None = None,
        device: str | torch.device | None = None,
    ):
        self.config = config
        self.ckpt_dir = ckpt_dir
        self.injector = injector
        self.device = resolve_device(device)
        self.devices = list(range(DEFAULT_RANKS) if devices is None else devices)
        self.survivor_fn = survivor_fn or (lambda devs: devs[: max(1, len(devs) // 2)])
        self.update_fn = update_fn or diffusion_update(config.halo)
        #: this runner's table of initialized persistent plans
        self.cache = PlanCache()
        self.events: list[ReplanEvent] = []
        self.checkpoint_step: int | None = None
        #: coordinator-led membership; auto-created for in-grid mode (the
        #: runner is rank 0 of the in-process form)
        if membership is None and config.recovery_mode == "in-grid":
            membership = MembershipService(heartbeat_timeout=config.heartbeat_timeout)
        self.membership = membership
        #: stable member ids, parallel to ``devices`` (survive shrinks)
        self.members = list(range(len(self.devices)))
        #: membership epoch current plans are stamped under
        self.epoch = 0
        self.straggler = straggler
        #: pending JOINs: (step, new slots) handled before that step runs
        self._joins = sorted((int(s), list(d)) for s, d in joins)
        self._fail_coordinator_at = fail_coordinator_at
        self.join_us = 0.0
        self.warm_ranks = 0
        self.recoveries: list[Recovery] = []
        self.save_seconds: list[float] = []
        #: the recovery whose first step on the new mesh has not ended yet
        self._pending: Recovery | None = None
        #: seconds the last checkpoint read took (None: nothing to read)
        self._restore_s: float | None = None

    # -- topology ------------------------------------------------------------
    def _domain(self):
        from repro_torch.core.mesh import make_mesh
        from repro_torch.launch.stencil import process_grid
        from repro_torch.stencil.domain import Domain

        cfg = self.config
        n = len(self.devices)
        assert cfg.global_interior[0] % n == 0, (
            f"interior {cfg.global_interior} not decomposable over {n} surviving ranks")
        processes, index = process_grid()
        mesh = make_mesh((n,), ("px",), device=self.device, processes=processes,
                         process_index=index)
        return Domain(mesh, tuple(cfg.global_interior),
                      ("px",) + (None,) * (len(cfg.global_interior) - 1), halo=cfg.halo)

    def _memory(self) -> int:
        return torch.cuda.memory_allocated(self.device) if self.device.type == "cuda" else 0

    # -- planning ------------------------------------------------------------
    def _plan(self, domain, x: torch.Tensor, step: int, cause: str, invalidated: int):
        """Build the exchange driver for ``domain`` on the example ``x``;
        record one :class:`ReplanEvent` (re-derivation timed, determinism
        asserted)."""
        from repro_torch.stencil.strategies import StrategyConfig, make_driver

        cfg = self.config
        drv = make_driver(
            StrategyConfig(name=cfg.strategy, n_parts=cfg.n_parts, packer=cfg.packer,
                           transport=cfg.transport, coalesce=cfg.coalesce,
                           plan_cache=self.cache, epoch=self.epoch),
            domain.mesh, domain.halo_spec, ndim=len(cfg.global_interior),
            update_fn=self.update_fn,
        )
        # the message tables and wire-layout offsets for this topology,
        # timed, and derived twice: the elastic story rests on the
        # derivation being a pure function of the topology
        t0 = time.perf_counter()
        tables = drv.replan_tables(x)
        replan_us = (time.perf_counter() - t0) * 1e6
        assert tables == drv.replan_tables(x), (
            "static re-planning is not deterministic on this topology")
        probe = None
        if self.injector is not None:
            injector = self.injector

            def probe(point: str) -> None:
                # fires while the plan's tables are built ("group" entry,
                # between coalesced partition "round"s): before any capture
                injector.check(step, phase=f"plan-build:{point}")

        t0 = time.perf_counter()
        with chaos_scope(probe):
            drv.init(x)
        init_us = (time.perf_counter() - t0) * 1e6
        self.events.append(ReplanEvent(
            step=step, n_devices=len(self.devices), replan_us=replan_us, init_us=init_us,
            plan_invalidations=invalidated, cause=cause, epoch=self.epoch,
        ))
        return drv

    # -- state ---------------------------------------------------------------
    def _checkpoint(self, interior: np.ndarray | None, step: int) -> None:
        if self.ckpt_dir is None:
            return
        from repro_torch.launch.stencil import process_grid
        from repro_torch.train import checkpoint

        if process_grid()[1] == 0:
            t0 = time.perf_counter()
            checkpoint.save({"interior": interior, "step": np.int64(step)}, self.ckpt_dir, step)
            self.save_seconds.append(time.perf_counter() - t0)
        self.checkpoint_step = step

    def _restore_or_init(self):
        """The last committed checkpoint (structure-free: a replacement
        process knows only the directory) on the run's device, or the
        deterministic initial state."""
        from repro_torch.train import checkpoint

        t0 = time.perf_counter()
        if self.ckpt_dir is not None and checkpoint.latest_step(self.ckpt_dir) is not None:
            state, step = checkpoint.restore(self.ckpt_dir, device=self.device)
            synchronize(self.device)
            self._restore_s = time.perf_counter() - t0
            return state["interior"], int(state["step"])
        self._restore_s = None
        return initial_interior(self.config), 0

    # -- membership ----------------------------------------------------------
    def _form_membership(self) -> None:
        """Register every current member and seal the founding set."""
        if self.membership is None:
            return
        for m in self.members:
            self.membership.register(m)
        self.epoch = self.membership.seal().epoch

    def _heartbeat_all(self, step: int) -> None:
        """Every live rank beats; a dead coordinator surfaces here as
        :class:`CoordinatorLost`, the relaunch-fallback trigger."""
        if self.membership is None:
            return
        for m in self.members:
            self.membership.heartbeat(m, step=step)

    # -- JOIN ----------------------------------------------------------------
    def request_join(self, devices: Sequence[int], at_step: int = 0) -> None:
        """Admit rank slots ``devices`` before ``at_step`` runs."""
        self._joins.append((int(at_step), list(devices)))
        self._joins.sort(key=lambda j: j[0])

    def _handle_join(self, domain, drv, x: torch.Tensor, step: int):
        """Grow the mesh around registering ranks, moving LIVE state: the
        survivors' current iterate is copied out of the plan's output on
        the device, laid out for the grown decomposition and placed by
        :func:`~repro_torch.train.fault_tolerance.reshard_state`, never
        through the host.  ``join_us`` times that move.  Chaos checks run
        under the injector's ``"join"`` phase scope."""
        if domain.mesh.processes > 1:
            raise NotImplementedError("a JOIN on a multi-process grid is not supported")
        _, new_devices = self._joins.pop(0)
        scope = (self.injector.phase_scope("join") if self.injector is not None
                 else contextlib.nullcontext())
        with scope:
            self._check(step)  # chaos window: the JOIN itself can die
            t0 = time.perf_counter()
            record = Recovery(cause="join", step=step, t_raise=t0,
                              memory_at_raise=self._memory())
            # copy out of the plan-owned output before the plan goes
            live = _live_interior(domain, x)
            synchronize(self.device)
            drv.free()
            survivors = len(self.members)
            next_id = max(self.members, default=-1) + 1
            joiners = list(range(next_id, next_id + len(new_devices)))
            if self.membership is not None:
                for j in joiners:
                    view = self.membership.register(j)  # epoch bump: "join"
                self.epoch = view.epoch
            else:
                self.epoch += 1
            # plans stamped with pre-join epochs can never deliver into the
            # grown mesh; everything else the survivors warmed stays
            stale = self.cache.invalidate_stale_epochs(self.epoch)
            record.memory_released = self._memory()
            self.devices = self.devices + list(new_devices)
            self.members = self.members + joiners
            new_domain = self._domain()
            spec = ("px",) + (None,) * (len(self.config.global_interior) - 1)
            x = reshard_state(_stored_layout(new_domain, live), new_domain.mesh, spec)
            del live
            synchronize(self.device)
            self.join_us += (time.perf_counter() - t0) * 1e6
            if self.membership is not None:
                for m in self.members:
                    self.membership.ack(m, self.epoch)
                assert self.membership.barrier_complete(self.epoch)
            self.warm_ranks = survivors
            new_drv = self._plan(new_domain, x, step, cause="join", invalidated=stale)
            self._pending = record
        return x, new_domain, new_drv

    # -- LOSS recovery -------------------------------------------------------
    def _recover_loss(self, pending: int) -> tuple[str, int]:
        """Shrink to the survivors after a detected rank loss.

        In-grid mode is coordinator-led: evict the dead ranks, adopt the
        bumped epoch, drop ONLY epoch-stale plans, and barrier every
        survivor on the new epoch; a dead coordinator falls back to the
        relaunch path.  Relaunch mode drops every plan: everyone cold.
        """
        survivors = list(self.survivor_fn(self.devices))
        assert survivors, "no surviving ranks"
        lost = [m for m, d in zip(self.members, self.devices) if d not in survivors]
        if self.config.recovery_mode == "in-grid" and self.membership is not None:
            try:
                view = self.membership.mark_lost(*lost)  # epoch bump: "loss"
                self.epoch = view.epoch
                pending += self.cache.invalidate_stale_epochs(self.epoch)
                keep = [m for m in self.members if m not in lost]
                for m in keep:
                    self.membership.ack(m, self.epoch)
                assert self.membership.barrier_complete(self.epoch)
                self.members = keep
                self.devices = survivors
                self.warm_ranks = len(keep)
                return "loss-ingrid", pending
            except CoordinatorLost:
                return self._coordinator_fallback(pending, survivors=survivors, lost=lost)
        # the dead topology's plans are garbage: drop them all (the counter
        # feeds the next ReplanEvent) and go cold
        pending += self.cache.invalidate()
        self.members = [m for m in self.members if m not in lost]
        self.devices = survivors
        self.warm_ranks = 0
        return "rank-loss", pending

    def _coordinator_fallback(self, pending: int, *, survivors=None,
                              lost=()) -> tuple[str, int]:
        """The coordinator died: take the relaunch path (full invalidation,
        everyone cold) and re-form membership under a successor whose epoch
        starts past every plan the old generation stamped."""
        pending += self.cache.invalidate()
        if survivors is not None:
            self.members = [m for m in self.members if m not in lost]
            self.devices = survivors
        self.warm_ranks = 0
        self.epoch += 1
        if self.membership is not None:
            self.membership = MembershipService(
                heartbeat_timeout=self.config.heartbeat_timeout, start_epoch=self.epoch)
            self._form_membership()
        return "coordinator-lost", pending

    # -- the run loop --------------------------------------------------------
    def _check(self, step: int, phase: str | None = None) -> None:
        if self.injector is not None:
            self.injector.check(step, phase=phase)

    def _recovered(self, recover: Callable[[], tuple[str, int]]):
        """Recover from the failure being handled: synchronize first (a
        step may still be running on the card, reading and writing the
        plan's static buffers), then ``recover`` (which releases the dead
        topology's plans), then read the checkpoint.  Returns ``(cause,
        pending invalidations, interior, step)``."""
        t_raise = time.perf_counter()
        at_raise = self._memory()
        synchronize(self.device)
        cause, pending = recover()
        record = Recovery(cause=cause, step=0, t_raise=t_raise, memory_at_raise=at_raise,
                          memory_released=self._memory())
        interior, step = self._restore_or_init()
        record.step, record.restore_s = step, self._restore_s or 0.0
        self._pending = record
        return cause, pending, interior, step

    def _first_step_done(self) -> None:
        if self._pending is not None:
            rec, self._pending = self._pending, None
            rec.recover_s = time.perf_counter() - rec.t_raise
            rec.memory_after = self._memory()
            self.recoveries.append(rec)

    def run(self) -> ElasticResult:
        cfg = self.config
        replans = 0
        pending_invalidated = 0
        cause = "initial"
        t0 = time.perf_counter()
        interior, step = self._restore_or_init()
        if self._restore_s is not None:  # a relaunched process resumes
            memory = self._memory()
            self._pending = Recovery(cause="resume", step=step, t_raise=t0,
                                     restore_s=self._restore_s, memory_at_raise=memory,
                                     memory_released=memory)
        self._form_membership()
        while True:
            drv = x = y = None
            try:
                domain = self._domain()
                x = domain.from_global_interior(interior)
                interior = None
                # plan-build chaos can fire inside _plan's init
                drv = self._plan(domain, x, step, cause=cause,
                                 invalidated=pending_invalidated)
                pending_invalidated = 0
                while step < cfg.n_steps:
                    if self._joins and self._joins[0][0] <= step:
                        x, domain, drv = self._handle_join(domain, drv, x, step)
                    if (self._fail_coordinator_at is not None
                            and step >= self._fail_coordinator_at
                            and self.membership is not None):
                        self._fail_coordinator_at = None
                        self.membership.fail()  # chaos: the coordinator dies
                    self._check(step, "pre-step")
                    t0 = time.perf_counter()
                    y = drv.step(x)  # exchange + update queued on the device
                    self._check(step, "mid-exchange")
                    x = drv.wait(y)
                    y = None
                    if self.straggler is not None:
                        self.straggler.observe(step, time.perf_counter() - t0)
                    step += 1
                    self._first_step_done()
                    self._heartbeat_all(step)
                    if cfg.checkpoint_every and (step % cfg.checkpoint_every == 0
                                                 or step == cfg.n_steps):
                        self._checkpoint(domain.to_global_interior(x), step)
                final = domain.to_global_interior(x)
                stats = self.cache.stats
                return ElasticResult(
                    final_interior=final, steps=step, replans=replans,
                    events=list(self.events), checkpoint_step=self.checkpoint_step,
                    recovery_mode=cfg.recovery_mode, join_us=self.join_us,
                    warm_ranks=self.warm_ranks, final_epoch=self.epoch,
                    straggler_flags=(list(self.straggler.flagged)
                                     if self.straggler is not None else []),
                    plan_cache_inits=stats.inits, plan_cache_hits=stats.cache_hits,
                    plan_cache_invalidations=stats.invalidations,
                    cell={"strategy": cfg.strategy, "packer": cfg.packer,
                          "transport": cfg.transport, "coalesce": cfg.coalesce,
                          "n_parts": cfg.n_parts},
                    device=device_name(self.device), recoveries=list(self.recoveries),
                    save_seconds=list(self.save_seconds),
                )
            except SimulatedFailure:
                replans += 1
                if replans > cfg.max_replans:
                    raise
                x = y = None  # the dead topology's tensors go with its plans
                # resume from the last committed checkpoint (JOINs move
                # live state instead and never come through here)
                cause, pending_invalidated, interior, step = self._recovered(
                    lambda: self._recover_loss(pending_invalidated))
            except CoordinatorLost:
                replans += 1
                if replans > cfg.max_replans:
                    raise
                x = y = None
                cause, pending_invalidated, interior, step = self._recovered(
                    lambda: self._coordinator_fallback(pending_invalidated))
            finally:
                if drv is not None:
                    drv.free()

    @property
    def plan_stats(self):
        return self.cache.stats


def main(argv: Sequence[str] | None = None) -> None:
    """Run one in-process chaos cycle, report the events, and hold the
    result against the one-rank oracle."""
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--size", default="16,8", help="global interior, comma-separated")
    ap.add_argument("--ranks", type=int, default=DEFAULT_RANKS,
                    help="rank slots the run starts with (a failure keeps the first half)")
    ap.add_argument("--strategy", default="persistent")
    ap.add_argument("--packer", default="slice")
    ap.add_argument("--n-parts", type=int, default=1)
    ap.add_argument("--n-steps", type=int, default=8)
    ap.add_argument("--fail-step", type=int, default=None,
                    help="inject a mid-exchange failure at this step (default: n_steps // 2)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    args = ap.parse_args(argv)

    size = tuple(int(s) for s in args.size.split(","))
    fail_at = args.fail_step if args.fail_step is not None else args.n_steps // 2
    cfg = ElasticConfig(global_interior=size, strategy=args.strategy, packer=args.packer,
                        n_parts=args.n_parts, n_steps=args.n_steps)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="elastic_ckpt_")
    result = ElasticStencilRunner(
        cfg, ckpt, device=args.device, devices=list(range(args.ranks)),
        injector=FailureInjector(fail_at_steps=(fail_at,), phases=("mid-exchange",)),
    ).run()
    for e in result.events:
        print(f"plan[{e.cause}] step={e.step} ranks={e.n_devices} replan_us={e.replan_us:.0f} "
              f"init_us={e.init_us:.0f} invalidated={e.plan_invalidations} epoch={e.epoch}")
    for r in result.recoveries:
        print(f"recovery[{r.cause}] resumed at step {r.step}: {r.recover_s:.3f} s to the end "
              f"of the first step (restore {r.restore_s:.3f} s); memory_allocated "
              f"{r.memory_at_raise} at the raise, {r.memory_released} released, "
              f"{r.memory_after} after")
    oracle = ElasticStencilRunner(dataclasses.replace(cfg, checkpoint_every=0), None,
                                  device=args.device, devices=[0]).run()
    from repro_torch.core.transport import get_packer

    rtol, atol = get_packer(cfg.packer).wire_tolerance("float32")
    if (rtol, atol) == (0.0, 0.0):
        match = np.array_equal(result.final_interior, oracle.final_interior)
        kind = "bitwise"
    else:
        # lossy wire: topologies drift within the per-step wire tolerance
        scale = float(np.abs(oracle.final_interior).max())
        match = np.allclose(result.final_interior, oracle.final_interior,
                            rtol=cfg.n_steps * rtol,
                            atol=cfg.n_steps * max(atol, rtol * scale))
        kind = "tolerance-aware"
    print(f"{result.steps} steps, {result.replans} re-plans on {result.device}; "
          f"{kind} vs the one-rank oracle: {match}")
    if not match:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
