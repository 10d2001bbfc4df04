"""Persistent communication/step plans — the MPI persistent-request analogue
(PyTorch port of ``src/repro/core/plan.py``).

The JAX package traces, lowers and compiles the step once at init and
dispatches the compiled executable whole at start.  On a CUDA device the
port's counterpart is a CUDA graph:

* **init** (``MPI_Send_init``) builds the step from its factory (message
  tables, wire layouts, route and segment tables uploaded, wire buffers
  allocated), makes static copies of the example arguments' tensors, runs
  the step once eagerly on a side stream (every kernel library loaded,
  every lazy module resolved), and captures one step as a
  :class:`torch.cuda.CUDAGraph` on the static inputs, in a memory pool of
  the plan's own.  ``init_seconds`` includes the capture.
* **start** (``MPI_Start``) copies each tensor argument into its static
  input, unless it already is that storage, and replays the graph.
* **wait** (``MPI_Wait``) synchronizes the device.
* **free** (``MPI_Request_free``) resets the graph and drops its static
  buffers and its pool.

On the CPU, for a plan built without example arguments (the serving
engine's prefill plans), and for a step that declares itself not
``capturable`` (a halo step whose transport calls the host inside a move:
``multihost`` across processes), *start* runs the step eagerly, on the
buffers its factory allocated once.  The decision is read from that
declaration; no capture is attempted and caught.  A capture or replay that
fails on the card raises; nothing falls back to eager there.
:attr:`CommPlan.fn` is the eager step, for measurement and checks.

A :class:`PlanCache` is the table of initialized requests; its counters
let tests and benchmarks measure the amortization the paper reports.  The
serving engine keys its step plans with :meth:`PlanCache.key_for` (function
identity + abstract arguments), as the JAX engine does.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Hashable, Iterator, Sequence

import torch

from repro_torch.kernels import _build


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

        plan = CommPlan(factory, device=dev, example_args=(x,))  # MPI_Send_init
        out  = plan.start(x)                                     # MPI_Start
        plan.wait(out)                                           # MPI_Wait
        plan.free()                                              # MPI_Request_free

    ``factory`` returns the step callable; when the step carries a
    ``prepared`` attribute (a :class:`~repro_torch.core.transport.
    PreparedExchange`), the plan exposes it as :attr:`exchange` — its
    message tables, wire layouts, device segment tables and buffers.

    On a CUDA device with ``example_args``, the step is captured as a CUDA
    graph (see the module docstring), unless it carries ``capturable =
    False``.  A step that owns buffers it
    alternates between carries ``graph_inputs``: a tuple of argument tuples,
    each captured as a graph of its own with those buffers as its static
    inputs; ``start`` replays the graph whose inputs the arguments already
    are, else copies them into the first.  The tensors a captured plan's
    ``start`` returns belong to the plan and are valid until its next
    ``start`` (as JAX's donated buffers): the next replay writes them.
    """

    def __init__(self, factory: Callable[[], Callable], *, device: torch.device,
                 example_args: Sequence[Any] | None = None, name: str | None = None):
        self.name = name or "plan"
        self.device = device
        #: transport-schedule identity + coalesced wire-layout offset tables,
        #: stamped by :func:`transport_plan` at init
        self.schedule = None
        self.wire_layouts: tuple = ()
        self._freed = False
        self._graphs: tuple[_Graph, ...] = ()
        t0 = time.perf_counter()
        self.fn = factory()
        if device.type == "cuda":
            if example_args is not None and getattr(self.fn, "capturable", True):
                self._capture(tuple(example_args))
            torch.cuda.synchronize(device)  # uploads, allocations, capture landed
        self.init_seconds = time.perf_counter() - t0

    def _capture(self, example: tuple) -> None:
        alternatives = getattr(self.fn, "graph_inputs", None)
        if alternatives is None:
            alternatives = (tree_map(torch.Tensor.clone, example),)
        else:
            for inputs in alternatives:
                bind_args(example, inputs)
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for inputs in alternatives:
                    self.fn(*inputs)  # warm-up: libraries loaded, lazy modules resolved
            current.wait_stream(side)
            pool = torch.cuda.graph_pool_handle()
            self._graphs = tuple(_Graph(self.fn, inputs, pool) for inputs in alternatives)

    @property
    def captured(self) -> bool:
        """Whether :meth:`start` replays a CUDA graph."""
        return bool(self._graphs)

    @property
    def exchange(self):
        return getattr(self.fn, "prepared", None)

    def start(self, *args: Any) -> Any:
        if self._freed:
            raise RuntimeError(f"plan {self.name!r} used after free()")
        if not self._graphs:
            return self.fn(*args)
        graph = next((g for g in self._graphs[1:] if is_bound(args, g.inputs)),
                     self._graphs[0])
        bind_args(args, graph.inputs)
        return graph.replay()

    def wait(self, out: Any) -> Any:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def __call__(self, *args: Any) -> Any:
        return self.start(*args)

    def free(self) -> None:
        """Drop the step, and the graphs with their static buffers and pool
        (their memory returns once no output ``start`` returned is held)."""
        self._freed = True
        for g in self._graphs:
            g.graph.reset()
        self._graphs = ()
        self.fn = None


class _Graph:
    """One step captured on the static inputs ``inputs``: ``replay`` runs
    it and returns the objects the captured call returned."""

    def __init__(self, fn: Callable, inputs: tuple, pool) -> None:
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        before = collections.Counter(_build.LAUNCHES)
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn(*inputs)
        finally:
            #: kernel launches one replay makes (the capture itself ran none)
            self.launches = take_launches(before)

    def replay(self) -> Any:
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        return self.outputs


def take_launches(before: collections.Counter) -> collections.Counter:
    """The launches ``_build.LAUNCHES`` counted since the snapshot
    ``before``, taken back out of it: during a capture each wrapper counts
    the launch it records, but no kernel runs until a replay, which adds
    the returned delta once each time."""
    delta = collections.Counter(_build.LAUNCHES)
    delta.subtract(before)
    delta = +delta
    for name, n in delta.items():
        _build.LAUNCHES[name] -= n
        if _build.LAUNCHES[name] == 0:
            del _build.LAUNCHES[name]
    return delta


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` applied to every tensor of a nesting of dicts, lists and
    tuples; other leaves stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _pairs(args: Any, static: Any,
           path: str = "args") -> Iterator[tuple[str, torch.Tensor, torch.Tensor]]:
    """``(path, argument, static input)`` for every tensor of ``static``,
    walking ``args`` beside it; raises where the nesting differs or a
    non-tensor leaf changed (the capture baked it in)."""
    if isinstance(static, torch.Tensor):
        if not isinstance(args, torch.Tensor):
            raise TypeError(f"{path}: a tensor was captured, got {type(args).__name__}")
        yield path, args, static
    elif isinstance(static, dict):
        if not isinstance(args, dict) or args.keys() != static.keys():
            raise ValueError(f"{path}: keys {sorted(static)} were captured")
        for k, v in static.items():
            yield from _pairs(args[k], v, f"{path}[{k!r}]")
    elif isinstance(static, (list, tuple)):
        if not isinstance(args, (list, tuple)) or len(args) != len(static):
            raise ValueError(f"{path}: {len(static)} entries were captured")
        for i, (a, s) in enumerate(zip(args, static)):
            yield from _pairs(a, s, f"{path}[{i}]")
    elif args is not static and args != static:
        raise ValueError(f"{path}: {static!r} was captured, got {args!r}")


def _same_storage(a: torch.Tensor, s: torch.Tensor) -> bool:
    return (a.data_ptr() == s.data_ptr() and a.shape == s.shape and a.stride() == s.stride()
            and a.dtype == s.dtype and a.device == s.device)


def is_bound(args: Any, static: Any) -> bool:
    """Whether every tensor of ``args`` already is its static input."""
    return all(_same_storage(a, s) for _, a, s in _pairs(args, static))


def bind_args(args: Any, static: Any) -> int:
    """Bind a start's arguments to a plan's static inputs: each tensor of
    ``args`` is copied into its static input, unless it already is that
    storage (same data pointer, shape, stride, dtype and device).  Raises,
    before copying anything, on another shape, dtype or device, another
    nesting, or a changed non-tensor argument.  Returns the number of
    tensors copied."""
    todo = [(path, a, s) for path, a, s in _pairs(args, static) if not _same_storage(a, s)]
    for path, a, s in todo:
        if a.shape != s.shape or a.dtype != s.dtype or a.device != s.device:
            raise ValueError(f"{path}: {tuple(a.shape)} {a.dtype} on {a.device}, the plan "
                             f"captured {tuple(s.shape)} {s.dtype} on {s.device}")
    for _, a, s in todo:
        s.copy_(a)
    return len(todo)


class PlanCache:
    """Registry of initialized persistent plans under structural keys."""

    def __init__(self) -> None:
        self._plans: dict[Hashable, CommPlan] = {}
        self._lock = threading.Lock()
        self.stats = PlanStats()

    def key_for(self, fn: Callable, args: Sequence[Any], extra: Hashable = ()) -> Hashable:
        """The structural key of a step: ``fn``'s qualname and identity, the
        shapes, dtypes and devices of the tensor arguments (with their
        nesting), and ``extra``, as ``repro/core/plan.py``'s ``key_for``.
        Arguments of one structure share a plan; a fresh closure per call
        would miss every time."""
        return (getattr(fn, "__qualname__", repr(fn)), id(getattr(fn, "__wrapped__", fn)),
                _abstract(list(args)), extra)

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

    def discard(self, key: Hashable) -> bool:
        """Free and drop the plan under ``key``, if any (counted in
        ``stats.frees``, not as an invalidation): a plan no caller will
        start again, such as a losing autotuner probe's."""
        with self._lock:
            plan = self._plans.pop(key, None)
            if plan is None:
                return False
            plan.free()
            self.stats.frees += 1
        return True

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


def _abstract(x: Any) -> Hashable:
    """Tensor -> (shape, dtype, device); dicts, lists and tuples -> their
    nesting of those; anything else -> its repr (a static argument)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, dict):
        return ("dict", tuple((k, _abstract(v)) for k, v in sorted(x.items())))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_abstract(v) for v in x))
    return ("static", repr(x))


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
    example_args: Sequence[Any] | None = None,
    schedule: Any,
    layouts: Sequence[Any] | Callable[[], Sequence[Any]] | None = None,
    cache: PlanCache | None = None,
    key: Hashable | None = None,
    name: str | None = None,
) -> CommPlan:
    """Build ONE persistent plan for a transport schedule, private or from
    a shared cache (then under the structural ``key``; the factory only
    runs on a miss).  ``example_args`` are the step's example arguments,
    on which a CUDA plan captures it.  ``schedule`` (a :class:`~repro_torch.core.transport.
    ScheduleInfo`) and the coalesced ``layouts`` are stamped on a freshly
    built plan; a cache hit keeps its original stamp."""
    axes = tuple(schedule.mesh_axes)
    if not axes or len(set(axes)) != len(axes):
        raise ValueError(f"a transport plan needs distinct mesh axes, got {axes}")
    name = name or schedule.tag()
    if cache is None:
        plan = CommPlan(step_factory, device=device, example_args=example_args, name=name)
    else:
        if key is None:
            raise ValueError("cached plans need a structural key")
        plan = cache.get_or_init(step_factory, key=key, device=device,
                                 example_args=example_args, name=name)
    if plan.schedule is None:
        plan.schedule = schedule
        if callable(layouts):
            layouts = layouts()
        plan.wire_layouts = tuple(layouts) if layouts is not None else ()
    return plan
