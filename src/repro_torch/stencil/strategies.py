"""Pluggable exchange-strategy registry (PyTorch port of
``src/repro/stencil/strategies.py``).

Every strategy is a registered :class:`ExchangeStrategy` selected through
:func:`make_driver`; its knobs travel in a typed :class:`StrategyConfig`.
A driver steps the stacked layout ``(*mesh_shape, *local_ghosted)`` of a
:class:`~repro_torch.stencil.domain.Domain`; the exchange and the update
work on its free ``(R, *local_ghosted)`` view.

* ``standard``    — Alg. 1: re-derives its message tables, route tables and
  segment tables, uploads them and allocates its wire buffers on EVERY step
  (fresh ``Isend``/``Irecv`` envelopes).
* ``persistent``  — Alg. 2/3/4: all of that once, at ``init``, into a
  :class:`~repro_torch.core.plan.CommPlan`; a step only packs, moves and
  unpacks (``MPI_Start``).  On the card the plan captures the step as a
  CUDA graph at ``init`` and a step replays it; ``standard`` stays eager,
  the baseline's normal dispatch path.
* ``partitioned`` — Alg. 5/6/7: persistent, every face split into
  ``n_parts`` partitions, run as pipelined rounds on the current stream.
* ``fused``       — all ``3^D - 1`` face/edge/corner messages in one group.
* ``overlap``     — double-buffered: the deep interior is updated from the
  stale buffer, the boundary shells from the exchanged one; the input is
  never written.

``"auto"`` on any of ``name``, ``packer`` or ``coalesce`` routes to
:class:`AutoStrategy` (not registered: a selector, not a schedule), which
resolves the open axes through :mod:`repro_torch.core.autotune`.

``update_fn`` maps the batched ``(R, *local)`` block to its updated block;
it may update its argument in place and return it.
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Callable, ClassVar

import torch

from repro_torch.core import autotune
from repro_torch.core.autotune import AUTO
from repro_torch.core.compat import device_name, synchronize
from repro_torch.core.halo import (
    HaloSpec,
    fused_message_group,
    sequential_message_groups,
)
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.plan import PLANS, CommPlan, PlanCache, transport_plan
from repro_torch.core.transport import (
    PreparedExchange,
    get_packer,
    get_transport,
    schedule_layouts,
    schedule_locality,
    scheduled_collective_count,
)
from repro_torch.launch.mapping import canonical_mapping, default_node_size, mesh_node_ids

UpdateFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """Strategy knobs as one typed value; fields as
    ``repro.stencil.strategies.StrategyConfig``.

    ``donate`` — the step may update its input in place (the buffer-reuse
    analogue); ``False`` steps a copy and leaves the input untouched.
    ``name``, ``packer`` and ``coalesce`` also accept ``"auto"``:
    :func:`make_driver` then builds an :class:`AutoStrategy`, which tunes
    every ``auto`` axis and keeps the others pinned.
    """

    name: str = "standard"
    n_parts: int = 1
    plan_cache: str | PlanCache = "private"
    donate: bool = True
    packer: str = "slice"
    transport: str = "loopback"
    coalesce: bool | str = True
    mapping: str = "row-major"
    epoch: int | None = None

    def __post_init__(self):
        if self.n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {self.n_parts}")
        if isinstance(self.plan_cache, str) and self.plan_cache not in ("private", "shared"):
            raise ValueError(f"plan_cache {self.plan_cache!r}")
        if not (isinstance(self.coalesce, bool) or self.coalesce == AUTO):
            raise TypeError(f"coalesce must be a bool or {AUTO!r}, got {self.coalesce!r}")
        if self.packer != AUTO:
            get_packer(self.packer)
        get_transport(self.transport)
        object.__setattr__(self, "mapping", canonical_mapping(self.mapping))

    def resolve_cache(self) -> PlanCache | None:
        """``None`` means an un-cached private plan (freed by the driver)."""
        if isinstance(self.plan_cache, PlanCache):
            return self.plan_cache
        return PLANS if self.plan_cache == "shared" else None

    def with_(self, **kw) -> "StrategyConfig":
        return dataclasses.replace(self, **kw)


class _Step:
    """One exchange(+update) iteration on prebuilt tables: ``prepared`` is
    the :class:`PreparedExchange` a plan exposes; ``capturable`` is its
    transport's declaration, which the plan reads."""

    def __init__(self, prepared: PreparedExchange, update_fn: UpdateFn | None, donate: bool):
        self.prepared = prepared
        self.ranks = prepared.ranks
        self.capturable = prepared.capturable
        self.update_fn = update_fn
        self.donate = donate

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.donate:
            x = x.clone()
        xb = self.prepared.run(x.view(self.ranks, *self.prepared.local_shape))
        if self.update_fn is not None:
            xb = self.update_fn(xb)
        return xb.view(x.shape)


class _OverlapStep(_Step):
    """Double buffer: reads buffer A, writes buffer B (never A).  B starts
    as a copy of A, is exchanged in place, and takes the overlap-split
    update; the two driver-owned buffers alternate from step to step, so
    the caller's own input is never written either."""

    def __init__(self, prepared, update_fn, example: torch.Tensor,
                 array_axes: tuple[int, ...], halo: int):
        super().__init__(prepared, update_fn, donate=False)
        self.bufs = (torch.empty_like(example), torch.empty_like(example))
        self.array_axes, self.halo = array_axes, halo
        #: a captured plan replays one graph a parity, each reading one
        #: buffer and writing the other (the output buffer is chosen in
        #: Python, which a capture freezes)
        self.graph_inputs = ((self.bufs[0],), (self.bufs[1],))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.stencil.domain import overlapped_update

        out = self.bufs[1] if x.data_ptr() == self.bufs[0].data_ptr() else self.bufs[0]
        out.copy_(x)
        local = self.prepared.local_shape
        fresh = self.prepared.run(out.view(self.ranks, *local))
        if self.update_fn is not None:
            overlapped_update(x.view(self.ranks, *local), fresh, self.update_fn,
                              array_axes=self.array_axes, halo=self.halo)
        return out


# ---------------------------------------------------------------------------
# strategy base class
# ---------------------------------------------------------------------------


class ExchangeStrategy(abc.ABC):
    """One halo-exchange (+ optional local update) iteration driver.

    ::

        drv.init(example)   # *_init   (no-op for the standard baseline)
        x = drv.step(x)     # Start
        x = drv.wait(x)     # Waitall (device synchronize)
        drv.free()          # Request_free
    """

    name: ClassVar[str] = ""
    uses_partitions: ClassVar[bool] = False
    amortizes_init: ClassVar[bool] = False
    schedule_kind: ClassVar[str] = "sequential"

    def __init__(
        self,
        mesh: VirtualMesh,
        spec_builder: Callable[[], HaloSpec],
        ndim: int,
        *,
        config: StrategyConfig | None = None,
        update_fn: UpdateFn | None = None,
    ):
        self.mesh = mesh
        self.ndim = ndim
        self.config = (config or StrategyConfig(name=self.name)).with_(name=self.name)
        self._spec_builder = spec_builder
        self.update_fn = update_fn

    # -- identity ----------------------------------------------------------
    @property
    def strategy(self) -> str:
        return self.name

    @property
    def n_parts(self) -> int:
        return self.config.n_parts

    @property
    def packer(self) -> str:
        return self.config.packer

    @property
    def transport(self) -> str:
        return self.config.transport

    def build_spec(self) -> HaloSpec:
        """The builder's geometry stamped with this strategy's identity."""
        spec = self._spec_builder()
        return spec.with_(
            strategy=self.name,
            n_parts=self.n_parts if self.uses_partitions else 1,
            packer=self.config.packer, transport=self.config.transport,
            coalesce=self.config.coalesce, mapping=self.config.mapping,
            epoch=self.config.epoch,
        )

    # -- schedule ----------------------------------------------------------
    def _local_block_shape(self, example_shape) -> tuple[int, ...]:
        """Per-rank ghosted block shape of a stacked example (this
        process's rows: ``(*mesh_shape, ...)``, or ``(local_size, ...)`` on
        a grid)."""
        lead = self.mesh.stacked_dims
        m = len(lead)
        if tuple(example_shape[:m]) != lead or len(example_shape) != m + self.ndim:
            raise ValueError(f"expected (*{lead}, <{self.ndim} local dims>), "
                             f"got {tuple(example_shape)}")
        return tuple(example_shape[m:])

    def _message_groups(self, shape: tuple[int, ...], spec: HaloSpec) -> tuple[tuple, ...]:
        sizes = {name: self.mesh.shape[name] for name in spec.mesh_axes}
        return sequential_message_groups(shape, spec, sizes)

    def _prepare(self, example: torch.Tensor) -> PreparedExchange:
        """Tables, uploads and wire buffers of one step on ``example``'s
        shape: the whole per-plan setup."""
        if example.device != self.mesh.device:
            raise ValueError(f"tensor on {example.device}, mesh on {self.mesh.device}")
        spec = self.build_spec()
        local = self._local_block_shape(example.shape)
        return PreparedExchange(
            self._message_groups(local, spec), mesh=self.mesh, local_shape=local,
            dtype=example.dtype, packer=spec.packer, transport=spec.transport,
            coalesce=spec.coalesce,
        )

    def _build_step(self, example: torch.Tensor) -> _Step:
        return _Step(self._prepare(example), self.update_fn, self.config.donate)

    def scheduled_collectives(self, example: torch.Tensor) -> int:
        """Rank gathers one step launches (one per coalesced neighbor)."""
        spec = self.build_spec()
        groups = self._message_groups(self._local_block_shape(example.shape), spec)
        return scheduled_collective_count(groups, coalesce=spec.coalesce)

    def replan_tables(self, example) -> tuple[tuple, tuple]:
        """Re-derive the static schedule: ``(message groups, wire layouts)``
        — a pure function of block shape, spec and mesh axis sizes."""
        spec = self.build_spec()
        groups = self._message_groups(self._local_block_shape(tuple(example.shape)), spec)
        layouts = (schedule_layouts(groups, spec.packer, example.dtype)
                   if spec.coalesce else ())
        return groups, layouts

    def wire_layouts(self, example: torch.Tensor) -> tuple:
        return self.replan_tables(example)[1]

    # -- lifecycle ----------------------------------------------------------
    @abc.abstractmethod
    def init(self, example: torch.Tensor) -> None:
        """Pay any amortizable setup."""

    @abc.abstractmethod
    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One exchange(+update) iteration, queued on the device."""

    def wait(self, x: torch.Tensor) -> torch.Tensor:
        synchronize(self.mesh.device)  # MPI_Waitall
        return x

    def free(self) -> None:
        """Release strategy-held plans (no-op by default)."""


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[ExchangeStrategy]] = {}


def register_strategy(cls: type[ExchangeStrategy]) -> type[ExchangeStrategy]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty `name`")
    if cls.name in _REGISTRY:
        raise ValueError(f"strategy {cls.name!r} already registered "
                         f"({_REGISTRY[cls.name].__name__})")
    _REGISTRY[cls.name] = cls
    return cls


def available_strategies() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_strategy(name: str) -> type[ExchangeStrategy]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown exchange strategy {name!r}; "
                       f"registered: {', '.join(_REGISTRY) or '(none)'}") from None


def make_driver(
    strategy: str | StrategyConfig,
    mesh: VirtualMesh,
    spec_builder: Callable[[], HaloSpec],
    ndim: int,
    *,
    update_fn: UpdateFn | None = None,
    **config_kw,
) -> ExchangeStrategy:
    """Name-or-config in, driver out; it runs on ``mesh.device``.  Any
    ``auto`` axis (name, packer or coalesce) routes to :class:`AutoStrategy`."""
    config = strategy if isinstance(strategy, StrategyConfig) else StrategyConfig(
        name=strategy, **config_kw)
    if AUTO in (config.name, config.packer, config.coalesce):
        return AutoStrategy(mesh, spec_builder, ndim, config=config, update_fn=update_fn)
    cls = get_strategy(config.name)
    return cls(mesh, spec_builder, ndim, config=config, update_fn=update_fn)


# ---------------------------------------------------------------------------
# the paper's three strategies
# ---------------------------------------------------------------------------


@register_strategy
class StandardStrategy(ExchangeStrategy):
    """Alg. 1: every step re-derives the schedule, uploads its tables and
    allocates its wire buffers before moving any data."""

    name = "standard"

    def init(self, example: torch.Tensor) -> None:
        return None  # nothing to amortize: the baseline sets up per iteration

    def step(self, x: torch.Tensor) -> torch.Tensor:
        return self._build_step(x)(x)


@register_strategy
class PersistentStrategy(ExchangeStrategy):
    """Alg. 2/3/4: the plan is built once at ``init``; a step is a bare
    start of it."""

    name = "persistent"
    amortizes_init = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._plan: CommPlan | None = None

    def _plan_key(self, example: torch.Tensor):
        """Structural plan identity (the step is a fresh object per driver):
        spec, mesh, update fn, and the example's shape, dtype and device."""
        return ("halo_plan", self.build_spec(), self.ndim, self.config.donate,
                self.mesh, self.update_fn, tuple(example.shape), str(example.dtype),
                str(example.device))

    def init(self, example: torch.Tensor) -> None:
        if self._plan is not None:
            return
        self._plan = transport_plan(
            lambda: self._build_step(example), device=self.mesh.device,
            example_args=(example,),
            schedule=self.build_spec().schedule_info(self.schedule_kind),
            layouts=lambda: self.wire_layouts(example),
            cache=self.config.resolve_cache(), key=self._plan_key(example),
            name=f"halo_{self.name}@{self.config.packer}",
        )

    @property
    def plan(self) -> CommPlan | None:
        return self._plan

    def step(self, x: torch.Tensor) -> torch.Tensor:
        if self._plan is None:
            self.init(x)
        return self._plan.start(x)

    def free(self) -> None:
        # shared-cache plans stay initialized for other drivers
        if self._plan is not None and self.config.resolve_cache() is None:
            self._plan.free()
        self._plan = None


@register_strategy
class PartitionedStrategy(PersistentStrategy):
    """Alg. 5/6/7: persistent lifecycle, faces split into ``n_parts``
    partitions each packed -> moved -> unpacked as its own round."""

    name = "partitioned"
    uses_partitions = True


# ---------------------------------------------------------------------------
# overlap strategies (beyond the paper's trio)
# ---------------------------------------------------------------------------


@register_strategy
class FusedStrategy(PersistentStrategy):
    """All ``3^D - 1`` face/edge/corner messages from the original buffer
    in ONE independent group, one persistent plan."""

    name = "fused"
    schedule_kind = "fused"

    def _message_groups(self, shape, spec):
        sizes = {name: self.mesh.shape[name] for name in spec.mesh_axes}
        return (fused_message_group(shape, spec, sizes),)


@register_strategy
class OverlapStrategy(PersistentStrategy):
    """Double-buffered ghosts: the deep interior is updated from the stale
    buffer, the boundary shells from the exchanged one
    (:func:`~repro_torch.stencil.domain.interior_halo_split`).  Both
    buffers are driver-owned and alternate; the stale one is never written.
    ``update_fn`` must satisfy the split contract; without one the step is
    a persistent exchange into the other buffer."""

    name = "overlap"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.config = self.config.with_(donate=False)

    def _build_step(self, example: torch.Tensor) -> _Step:
        spec = self.build_spec()
        return _OverlapStep(self._prepare(example), self.update_fn, example,
                            spec.array_axes, spec.halo)


# ---------------------------------------------------------------------------
# autotuned selection (not registered: "auto" is a selector, not a schedule)
# ---------------------------------------------------------------------------


class AutoStrategy(ExchangeStrategy):
    """Resolve every ``auto`` config axis at plan-build time, then delegate.

    On the first ``init``/``step`` the driver enumerates the candidate
    ``(strategy, packer, coalesce, n_parts)`` grid (a pinned axis stays
    pinned), computes each candidate's static features (``wire_bytes``,
    collective count, intra/inter-node sends under the mesh's placement)
    and asks :func:`repro_torch.core.autotune.default_tuner` to pick: by
    recorded trace, by fitted cost model, or by timed probes.  The probes
    run on a copy of the example, their barrier is the driver's ``wait``,
    and probe drivers and the resolved driver share ONE plan cache, so the
    winner's plan is a cache hit.

    After resolution the driver IS the chosen one: ``strategy``/``config``
    report the concrete cell, and ``selected_by``/``predicted_us``/
    ``calibration_us`` carry the provenance that
    :func:`repro_torch.stencil.comb.run_cycles` stamps into records.
    ``selected_by`` also enters :class:`~repro_torch.core.halo.HaloSpec`
    and so every plan key.
    """

    name = AUTO
    amortizes_init = True  # resolution + the inner init are the setup cost

    def __init__(self, mesh, spec_builder, ndim, *, config=None, update_fn=None):
        config = config or StrategyConfig(name=AUTO, packer=AUTO, coalesce=AUTO)
        super().__init__(mesh, spec_builder, ndim, config=config, update_fn=update_fn)
        # the base ctor stamps name="auto"; restore the caller's strategy pin
        self.config = config
        self._inner: ExchangeStrategy | None = None
        self._owned_cache: PlanCache | None = None
        #: (us, plan key) of the fastest probe so far
        self._fastest_probe: tuple[float, object] | None = None
        #: selection provenance, set at resolution
        self.selected_by: str | None = None
        self.predicted_us: float | None = None
        self.calibration_us: float = 0.0

    # -- identity: the sentinel before resolution, the winner after --------
    @property
    def strategy(self) -> str:
        return self._inner.strategy if self._inner is not None else AUTO

    @property
    def n_parts(self) -> int:
        return self._inner.n_parts if self._inner is not None else 1

    # -- candidate grid -----------------------------------------------------
    def _probe_plan_cache(self) -> str | PlanCache:
        """A "private" request becomes a driver-owned cache shared by the
        probes and the resolved driver (freed with this driver)."""
        if self.config.plan_cache == "private":
            if self._owned_cache is None:
                self._owned_cache = PlanCache()
            return self._owned_cache
        return self.config.plan_cache

    def _candidate_config(self, cand) -> StrategyConfig:
        return self.config.with_(
            name=cand.strategy, packer=cand.packer, coalesce=cand.coalesce,
            n_parts=cand.n_parts, plan_cache=self._probe_plan_cache(),
        )

    def _candidates(self, dtype):
        def pin(v):
            return None if v == AUTO else (v,)

        return autotune.default_candidates(
            dtype=dtype,
            strategies=pin(self.config.name),
            packers=pin(self.config.packer),
            coalesce_modes=(None if self.config.coalesce == AUTO
                            else (bool(self.config.coalesce),)),
            part_counts=(autotune.DEFAULT_PART_COUNTS if self.config.n_parts == 1
                         else (self.config.n_parts,)),
        )

    # -- resolution ---------------------------------------------------------
    def _probe(self, cand, example: torch.Tensor) -> float:
        """One timed calibration run of a candidate (init, warmup, barrier,
        timed cycles) on a copy of the example, through a spec stamped
        ``selected_by="calibration"``, the stamp the resolved driver uses,
        so the winner's plan key matches and its plan is reused.  On a grid
        every process takes process 0's time (``torch.distributed.
        broadcast``), as the JAX package broadcasts it."""
        drv = make_driver(
            self._candidate_config(cand), self.mesh,
            lambda: self._spec_builder().with_(selected_by="calibration"),
            self.ndim, update_fn=self.update_fn,
        )
        x = example.clone()
        try:
            drv.init(x)
            for _ in range(autotune.PROBE_WARMUP):
                x = drv.step(x)
            drv.wait(x)
            t0 = time.perf_counter()
            for _ in range(autotune.PROBE_CYCLES):
                x = drv.step(x)
            drv.wait(x)
            us = (time.perf_counter() - t0) / autotune.PROBE_CYCLES * 1e6
            if self.mesh.processes > 1:
                # every process must adopt rank 0's time, or the SPMD
                # processes could pick different winners and deadlock
                import torch.distributed as dist

                t = torch.tensor([us], dtype=torch.float64)
                dist.broadcast(t, src=0)
                us = float(t)
        finally:
            drv.free()  # the shared probe cache keeps the plan initialized
        self._keep_fastest_probe(drv, example, us)
        return us

    def _keep_fastest_probe(self, drv: ExchangeStrategy, example: torch.Tensor,
                            us: float) -> None:
        """In a driver-owned probe cache, keep only the fastest probe's plan
        so far (the first of equals, as the tuner's ``min``): the resolved
        driver's cache hit when calibration picks it.  A captured plan holds
        a static copy of the block and a graph pool, so the others go at
        once.  A shared cache keeps every plan (another driver may hold it)."""
        if self._owned_cache is None:
            return
        key = drv._plan_key(example) if isinstance(drv, PersistentStrategy) else None
        if self._fastest_probe is None or us < self._fastest_probe[0]:
            if self._fastest_probe is not None and self._fastest_probe[1] is not None:
                self._owned_cache.discard(self._fastest_probe[1])
            self._fastest_probe = (us, key)
        elif key is not None:
            self._owned_cache.discard(key)

    def _resolve(self, example: torch.Tensor) -> None:
        if self._inner is not None:
            return
        geo = self._spec_builder()  # geometry only: axes, halo, topology
        candidates = self._candidates(example.dtype)
        axis_names = self.mesh.axis_names
        # on a grid a node is a process
        node_size = default_node_size(self.mesh.size, self.mesh.processes)
        node_of = mesh_node_ids(self.mesh, node_size)
        block = self._local_block_shape(tuple(example.shape))
        # the JAX package's stored global shape: blocks side by side
        stored = list(block)
        for name, a in zip(geo.mesh_axes, geo.array_axes):
            stored[a] *= self.mesh.shape[name]
        face_elems = autotune.max_face_elems(block, geo.array_axes, geo.halo)
        cell = {
            "mesh_shape": self.mesh.axis_sizes,
            "shape": tuple(stored),
            "dtype": str(example.dtype).removeprefix("torch."),
            "halo": geo.halo,
            "mapping": self.config.mapping,
            "transport": self.config.transport,
            "node_size": node_size,
            "message_bytes": face_elems * example.element_size(),
            "device": device_name(self.mesh.device),
        }
        # message tables depend only on (strategy, n_parts): packer and
        # coalesce reuse them
        groups_cache: dict[tuple[str, int], tuple] = {}
        features = {}
        for cand in candidates:
            gkey = (cand.strategy, cand.n_parts)
            if gkey not in groups_cache:
                drv = make_driver(self._candidate_config(cand), self.mesh,
                                  self._spec_builder, self.ndim, update_fn=self.update_fn)
                groups_cache[gkey] = drv._message_groups(block, drv.build_spec())
            groups = groups_cache[gkey]
            loc = schedule_locality(groups, axis_order=axis_names,
                                    axis_sizes=self.mesh.shape, node_of=node_of)
            features[cand] = autotune.CellFeatures(
                wire_bytes=face_elems * get_packer(cand.packer).wire_itemsize(example.dtype),
                collective_count=scheduled_collective_count(groups, coalesce=cand.coalesce),
                intra_sends=loc.intra_sends,
                inter_sends=loc.inter_sends,
            )
        verdict = autotune.default_tuner().choose_or_calibrate(
            candidates, features, cell, probe=lambda cand: self._probe(cand, example),
        )
        self.selected_by = verdict.selected_by
        self.predicted_us = verdict.predicted_us
        self.calibration_us = verdict.calibration_us
        stamp = verdict.plan_stamp()
        self._inner = make_driver(
            self._candidate_config(verdict.candidate), self.mesh,
            lambda: self._spec_builder().with_(selected_by=stamp),
            self.ndim, update_fn=self.update_fn,
        )
        # the resolved driver's config (overlap's donate=False included)
        # becomes this driver's visible identity
        self.config = self._inner.config

    # -- lifecycle: resolve, then delegate ----------------------------------
    def init(self, example: torch.Tensor) -> None:
        self._resolve(example)
        self._inner.init(example)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        if self._inner is None:
            self._resolve(x)
        return self._inner.step(x)

    def free(self) -> None:
        if self._inner is not None:
            self._inner.free()
        if self._owned_cache is not None:
            self._owned_cache.free_all()

    def build_spec(self) -> HaloSpec:
        if self._inner is None:
            raise RuntimeError("auto strategy has no spec before resolution; "
                               "call init(example) first")
        return self._inner.build_spec()

    def scheduled_collectives(self, example: torch.Tensor) -> int:
        self._resolve(example)
        return self._inner.scheduled_collectives(example)

    def replan_tables(self, example) -> tuple[tuple, tuple]:
        self._resolve(example)
        return self._inner.replan_tables(example)

    def wire_layouts(self, example: torch.Tensor) -> tuple:
        self._resolve(example)
        return self._inner.wire_layouts(example)
