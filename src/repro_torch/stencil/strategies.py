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
  unpacks (``MPI_Start``).
* ``partitioned`` — Alg. 5/6/7: persistent, every face split into
  ``n_parts`` partitions, run as pipelined rounds on the current stream.
* ``fused``       — all ``3^D - 1`` face/edge/corner messages in one group.
* ``overlap``     — double-buffered: the deep interior is updated from the
  stale buffer, the boundary shells from the exchanged one; the input is
  never written.

``update_fn`` maps the batched ``(R, *local)`` block to its updated block;
it may update its argument in place and return it.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Callable, ClassVar

import torch

from repro_torch.core.compat import synchronize
from repro_torch.core.halo import (
    HaloSpec,
    canonical_mapping,
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
    scheduled_collective_count,
)

UpdateFn = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """Strategy knobs as one typed value; fields as
    ``repro.stencil.strategies.StrategyConfig`` (no ``auto`` selector yet).

    ``donate`` — the step may update its input in place (the buffer-reuse
    analogue); ``False`` steps a copy and leaves the input untouched.
    """

    name: str = "standard"
    n_parts: int = 1
    plan_cache: str | PlanCache = "private"
    donate: bool = True
    packer: str = "slice"
    transport: str = "loopback"
    coalesce: bool = True
    mapping: str = "row-major"
    epoch: int | None = None

    def __post_init__(self):
        if self.n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {self.n_parts}")
        if isinstance(self.plan_cache, str) and self.plan_cache not in ("private", "shared"):
            raise ValueError(f"plan_cache {self.plan_cache!r}")
        if not isinstance(self.coalesce, bool):
            raise TypeError(f"coalesce must be a bool, got {self.coalesce!r}")
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
    the :class:`PreparedExchange` a plan exposes."""

    def __init__(self, prepared: PreparedExchange, ranks: int,
                 update_fn: UpdateFn | None, donate: bool):
        self.prepared = prepared
        self.ranks = ranks
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

    def __init__(self, prepared, ranks, update_fn, example: torch.Tensor,
                 array_axes: tuple[int, ...], halo: int):
        super().__init__(prepared, ranks, update_fn, donate=False)
        self.bufs = (torch.empty_like(example), torch.empty_like(example))
        self.array_axes, self.halo = array_axes, halo

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
        """Per-rank ghosted block shape of a stacked example."""
        m = len(self.mesh.axis_sizes)
        if tuple(example_shape[:m]) != self.mesh.axis_sizes or len(example_shape) != m + self.ndim:
            raise ValueError(f"expected (*{self.mesh.axis_sizes}, <{self.ndim} local dims>), "
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
        return _Step(self._prepare(example), self.mesh.size, self.update_fn,
                     self.config.donate)

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
    """Name-or-config in, driver out; it runs on ``mesh.device``."""
    config = strategy if isinstance(strategy, StrategyConfig) else StrategyConfig(
        name=strategy, **config_kw)
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
        return _OverlapStep(self._prepare(example), self.mesh.size, self.update_fn,
                            example, spec.array_axes, spec.halo)
