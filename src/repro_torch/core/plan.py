"""Persistent communication/step plans — the MPI persistent-request analogue
(PyTorch port of ``src/repro/core/plan.py``).

The JAX package compiles the SPMD step once at init.  PyTorch runs eagerly,
so here a plan's *init* is everything that does not depend on the data:
message tables, wire layouts, route tables and segment tables uploaded to
the device, and wire buffers allocated (``MPI_Send_init``).  *start* runs
the step on those (``MPI_Start``), *wait* synchronizes the device
(``MPI_Wait``), *free* drops them (``MPI_Request_free``).  Capturing the
started step as a CUDA graph is later work.

A :class:`PlanCache` is the table of initialized requests; its counters
let tests and benchmarks measure the amortization the paper reports.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Hashable, Sequence

import torch


@dataclasses.dataclass
class PlanStats:
    inits: int = 0
    starts: int = 0
    cache_hits: int = 0
    init_seconds: float = 0.0
    frees: int = 0
    #: plans dropped because their topology died under them
    invalidations: int = 0


class CommPlan:
    """One persistent plan: a step built once by ``factory`` and started
    many times.

    ::

        plan = CommPlan(factory, device=dev)   # MPI_Send_init
        out  = plan.start(x)                   # MPI_Start
        plan.wait(out)                         # MPI_Wait
        plan.free()                            # MPI_Request_free

    ``factory`` returns the step callable; when the step carries a
    ``prepared`` attribute (a :class:`~repro_torch.core.transport.
    PreparedExchange`), the plan exposes it as :attr:`exchange` — its
    message tables, wire layouts, device segment tables and buffers.
    """

    def __init__(self, factory: Callable[[], Callable], *, device: torch.device,
                 name: str | None = None):
        self.name = name or "plan"
        self.device = device
        #: transport-schedule identity + coalesced wire-layout offset tables,
        #: stamped by :func:`transport_plan` at init
        self.schedule = None
        self.wire_layouts: tuple = ()
        self._freed = False
        t0 = time.perf_counter()
        self.fn = factory()
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # uploads and allocations landed
        self.init_seconds = time.perf_counter() - t0

    @property
    def exchange(self):
        return getattr(self.fn, "prepared", None)

    def start(self, *args: Any) -> Any:
        if self._freed:
            raise RuntimeError(f"plan {self.name!r} used after free()")
        return self.fn(*args)

    def wait(self, out: Any) -> Any:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def __call__(self, *args: Any) -> Any:
        return self.start(*args)

    def free(self) -> None:
        self._freed = True
        self.fn = None


class PlanCache:
    """Registry of initialized persistent plans under structural keys."""

    def __init__(self) -> None:
        self._plans: dict[Hashable, CommPlan] = {}
        self._lock = threading.Lock()
        self.stats = PlanStats()

    def get_or_init(self, factory: Callable[[], Callable], *, key: Hashable,
                    **plan_kwargs: Any) -> CommPlan:
        """The plan under ``key``; on a miss, ``factory`` runs once and the
        new plan joins the table (a hit skips plan assembly entirely)."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.stats.cache_hits += 1
                return plan
        plan = CommPlan(factory, **plan_kwargs)
        with self._lock:
            self._plans[key] = plan
            self.stats.inits += 1
            self.stats.init_seconds += plan.init_seconds
        return plan

    def invalidate(self, predicate: Callable[[Hashable], bool] | None = None) -> int:
        """Drop (and free) cached plans selected by ``predicate`` (default:
        all); counted in ``stats.invalidations``."""
        with self._lock:
            doomed = [k for k in self._plans if predicate is None or predicate(k)]
            for k in doomed:
                self._plans.pop(k).free()
                self.stats.frees += 1
            self.stats.invalidations += len(doomed)
        return len(doomed)

    def free_all(self) -> None:
        with self._lock:
            for p in self._plans.values():
                p.free()
                self.stats.frees += 1
            self._plans.clear()

    def invalidate_stale_epochs(self, live_epoch: int) -> int:
        """Drop only the plans stamped with a membership epoch older than
        ``live_epoch``; epoch-free plans stay."""
        return self.invalidate(lambda key: stale_epoch(key, live_epoch))

    def keys(self) -> tuple:
        with self._lock:
            return tuple(self._plans)

    def __len__(self) -> int:
        return len(self._plans)


def stale_epoch(key: Hashable, live_epoch: int) -> bool:
    """True when any element of a (possibly nested) plan key carries an
    integer ``epoch`` older than ``live_epoch``."""
    def walk(obj) -> bool:
        epoch = getattr(obj, "epoch", None)
        if isinstance(epoch, int) and not isinstance(epoch, bool) and epoch < live_epoch:
            return True
        if isinstance(obj, tuple):
            return any(walk(el) for el in obj)
        return False

    return walk(key)


#: process-wide persistent-plan registry
PLANS = PlanCache()


def transport_plan(
    step_factory: Callable[[], Callable],
    *,
    device: torch.device,
    schedule: Any,
    layouts: Sequence[Any] | Callable[[], Sequence[Any]] | None = None,
    cache: PlanCache | None = None,
    key: Hashable | None = None,
    name: str | None = None,
) -> CommPlan:
    """Build ONE persistent plan for a transport schedule, private or from
    a shared cache (then under the structural ``key``; the factory only
    runs on a miss).  ``schedule`` (a :class:`~repro_torch.core.transport.
    ScheduleInfo`) and the coalesced ``layouts`` are stamped on a freshly
    built plan; a cache hit keeps its original stamp."""
    axes = tuple(schedule.mesh_axes)
    if not axes or len(set(axes)) != len(axes):
        raise ValueError(f"a transport plan needs distinct mesh axes, got {axes}")
    name = name or schedule.tag()
    if cache is None:
        plan = CommPlan(step_factory, device=device, name=name)
    else:
        if key is None:
            raise ValueError("cached plans need a structural key")
        plan = cache.get_or_init(step_factory, key=key, device=device, name=name)
    if plan.schedule is None:
        plan.schedule = schedule
        if callable(layouts):
            layouts = layouts()
        plan.wire_layouts = tuple(layouts) if layouts is not None else ()
    return plan
