"""Fault tolerance: failure injection, heartbeats, straggler detection,
elastic re-meshing (PyTorch port of ``src/repro/train/fault_tolerance.py``).

The mechanisms are real (a restart restores exact state, tested); the
*failures* are injected.  On a real cluster :class:`SimulatedFailure` is
where a missed heartbeat or a transport error lands.

:func:`reshard_state` is the port's elastic re-mesh: the JAX package puts
each leaf under a ``NamedSharding`` of a new ``Mesh``; here the new mesh is
a :class:`~repro_torch.core.mesh.VirtualMesh` and a leaf comes back in its
stacked layout ``(*mesh_shape, *shard)`` on the mesh's device.  A leaf
that is already on that device never leaves it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import zlib
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.mesh import VirtualMesh

log = logging.getLogger("repro_torch.ft")

#: one leaf's spec: for each array axis a mesh-axis name, or ``None``
#: (not split), as a ``PartitionSpec`` of single names
Spec = Sequence[str | None]


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss / NIC flap / preemption."""


# ---------------------------------------------------------------------------
# heartbeat + epoch types (mechanism; policy lives in launch.membership)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    """One liveness report: ``rank`` was alive at ``when`` (coordinator
    clock), optionally with the step it was executing."""

    rank: int
    when: float
    step: int | None = None


@dataclasses.dataclass(frozen=True)
class EpochBump:
    """Why the grid moved to ``epoch``: ``"form"`` (initial seal),
    ``"join"`` (a rank registered mid-run) or ``"loss"`` (missed
    heartbeats).  The epoch is stamped into every persistent plan key, so
    a stale plan never delivers into the re-formed mesh."""

    epoch: int
    cause: str

    def __post_init__(self):
        assert self.cause in ("form", "join", "loss"), self.cause


class HeartbeatLedger:
    """Last-beat table with a miss window: the detection half of in-grid
    recovery, kept apart from the service so its timeout logic is testable
    with a fake clock and no sockets."""

    def __init__(self, timeout: float):
        self.timeout = float(timeout)
        self._last: dict[int, Heartbeat] = {}

    def beat(self, rank: int, when: float, step: int | None = None) -> None:
        self._last[rank] = Heartbeat(rank=rank, when=when, step=step)

    def last(self, rank: int) -> Heartbeat | None:
        return self._last.get(rank)

    def missing(self, now: float) -> tuple[int, ...]:
        """Ranks whose last beat is older than the window, sorted."""
        return tuple(sorted(r for r, hb in self._last.items() if now - hb.when > self.timeout))

    def evict(self, rank: int) -> bool:
        return self._last.pop(rank, None) is not None

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(sorted(self._last))

    def __contains__(self, rank: int) -> bool:
        return rank in self._last

    def __len__(self) -> int:
        return len(self._last)


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at the given steps (or with probability p).

    ``phases`` restricts firing to labeled chaos points (``"mid-exchange"``,
    ``"plan-build:round"``, ...): with a non-empty ``phases`` only checks
    whose tag is listed may fire.  Every fire, deterministic or random, is
    recorded in ``_fired`` under ``(step, phase)``, so a restart that
    replays the step never refires (the random path is seeded by ``seed +
    step`` and would otherwise hit the same failure forever).

    Transient phases (a JOIN window) are tagged through :meth:`phase_scope`:
    the scope restores the previous tag on exit, so a ``"join"``-armed
    injector can never fire in the steady-state steps after the window.
    Inside a scope untagged checks inherit its phase; tagged checks keep
    their own.
    """

    fail_at_steps: tuple[int, ...] = ()
    probability: float = 0.0
    seed: int = 0
    enabled: bool = True
    phases: tuple[str, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)
    _active_phase: str | None = dataclasses.field(default=None, repr=False)

    @contextlib.contextmanager
    def phase_scope(self, phase: str):
        """Tag every untagged ``check`` inside the block with ``phase``."""
        prev = self._active_phase
        self._active_phase = phase
        try:
            yield self
        finally:
            self._active_phase = prev

    def check(self, step: int, phase: str | None = None) -> None:
        if not self.enabled:
            return
        if phase is None:
            phase = self._active_phase
        if self.phases and phase not in self.phases:
            return
        key = (step, phase)
        if key in self._fired:
            return
        at = f"step {step}" + (f" ({phase})" if phase else "")
        if step in self.fail_at_steps:
            self._fired.add(key)
            raise SimulatedFailure(f"injected failure at {at}")
        if self.probability > 0:
            salt = zlib.crc32((phase or "").encode())
            rng = np.random.default_rng(self.seed + step + salt)
            if rng.random() < self.probability:
                self._fired.add(key)
                raise SimulatedFailure(f"random failure at {at}")


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than ``factor`` x the
    mean (an outlier does not move the mean)."""

    ewma: float = 0.9
    factor: float = 3.0
    _mean: float | None = None
    flagged: list = dataclasses.field(default_factory=list)
    on_straggler: Callable[[int, float, float], None] | None = None

    def observe(self, step: int, seconds: float) -> bool:
        if self._mean is not None and seconds > self.factor * self._mean:
            self.flagged.append((step, seconds, self._mean))
            if self.on_straggler:
                self.on_straggler(step, seconds, self._mean)
            return True
        self._mean = seconds if self._mean is None else (
            self.ewma * self._mean + (1 - self.ewma) * seconds)
        return False


def run_with_restarts(
    make_step_iter: Callable[[], Any],
    *,
    max_restarts: int = 3,
    on_restart: Callable[[int], None] | None = None,
) -> Any:
    """Call ``make_step_iter`` until it returns, restarting on
    :class:`SimulatedFailure` at most ``max_restarts`` times; the callee
    restores from its latest checkpoint when called again."""
    restarts = 0
    while True:
        try:
            return make_step_iter()
        except SimulatedFailure as e:
            restarts += 1
            log.warning("failure: %s (restart %d/%d)", e, restarts, max_restarts)
            if restarts > max_restarts:
                raise
            if on_restart:
                on_restart(restarts)


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pinned:
    """The spec of a leaf that only the ranks at ``coords`` along the mesh
    axes ``axes`` hold, split among them as ``spec`` says: its stacked
    layout has size 1 on those axes.  ZeRO-1 may split a stacked subtree's
    layer axis over the data axes (stablelm-1.6b's 24 layers over 2 data
    ranks), and the port keeps a leaf a layer, so one layer's moments live
    on the data rank that holds the layer
    (:func:`repro_torch.train.train_loop.stacked_specs`)."""

    spec: tuple
    axes: tuple[str, ...]
    coords: tuple[int, ...]

    def holders(self, mesh: VirtualMesh) -> VirtualMesh:
        """The mesh of the ranks that hold the leaf (a one-process mesh)."""
        if mesh.processes > 1:
            raise ValueError("a pinned leaf on a mesh over several processes")
        sizes = tuple(1 if n in self.axes else k for n, k in zip(mesh.axis_names,
                                                                   mesh.axis_sizes))
        return VirtualMesh(sizes, mesh.axis_names, mesh.device)


def _names(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names: none, one, or a tuple of them
    (split over their row-major flattening)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axis_plan(shape: Sequence[int], mesh: VirtualMesh, spec: Spec):
    """``(split dims, position of each mesh axis among them, local dims)``
    of a global shape under ``spec``: every split array axis ``a`` becomes
    ``(k, shape[a] // k)``, or ``(k1, k2, ..., shape[a] // (k1 k2 ...))``
    for an entry that names several axes."""
    spec = tuple(spec)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not name the {len(shape)} axes of {tuple(shape)}")
    dims, mesh_pos, local_pos = [], {}, []
    for a, entry in enumerate(spec):
        k = 1
        for name in _names(entry):
            if name in mesh_pos:
                raise ValueError(f"mesh axis {name!r} splits two array axes in {spec}")
            mesh_pos[name] = len(dims)
            dims.append(mesh.shape[name])
            k *= mesh.shape[name]
        if shape[a] % k:
            raise ValueError(f"axis {a} of {tuple(shape)} does not split over {entry}={k}")
        local_pos.append(len(dims))
        dims.append(shape[a] // k)
    return dims, mesh_pos, local_pos


def _to_stacked(t: torch.Tensor, mesh: VirtualMesh, spec: Spec | Pinned) -> torch.Tensor:
    """A global tensor in ``mesh``'s stacked layout, materialized: ranks
    along a mesh axis the spec does not name hold copies; on a grid only
    this process's rows, in coordinate order."""
    if isinstance(spec, Pinned):
        mesh, spec = spec.holders(mesh), spec.spec
    dims, mesh_pos, local_pos = _axis_plan(t.shape, mesh, spec)
    t = t.reshape(dims)
    order = []
    for name in mesh.axis_names:
        if name not in mesh_pos:
            t = t.unsqueeze(-1)
            mesh_pos[name] = t.dim() - 1
        order.append(mesh_pos[name])
    local = [dims[p] for p in local_pos]
    t = t.permute(*order, *local_pos).expand(*mesh.axis_sizes, *local)
    if mesh.processes > 1:
        t = t.reshape(mesh.size, *local)[list(mesh.local_coords)]
    return t.clone(memory_format=torch.contiguous_format)


def _from_stacked(t: torch.Tensor, mesh: VirtualMesh, spec: Spec | Pinned) -> torch.Tensor:
    """Inverse of :func:`_to_stacked` on one process's whole mesh (rank 0
    of a mesh axis the spec does not name)."""
    if isinstance(spec, Pinned):
        mesh, spec = spec.holders(mesh), spec.spec
    if mesh.processes > 1:
        raise ValueError("a stacked leaf of a multi-process mesh holds only its own rows")
    m = len(mesh.axis_names)
    if tuple(t.shape[:m]) != mesh.axis_sizes or t.dim() != m + len(spec):
        raise ValueError(f"stacked {tuple(t.shape)} is not ({mesh.axis_sizes}, <{len(spec)} dims>)")
    named = {n for entry in spec for n in _names(entry)}
    names = list(mesh.axis_names)
    for i in reversed(range(m)):
        if names[i] not in named:
            t = t.select(i, 0)
            names.pop(i)
    order, shape = [], []
    for a, entry in enumerate(spec):
        k = 1
        for name in _names(entry):
            order.append(names.index(name))
            k *= mesh.shape[name]
        order.append(len(names) + a)
        shape.append(t.shape[len(names) + a] * k)
    return t.permute(order).reshape(shape)


def _map_specs(fn: Callable[[Any, Spec], Any], state: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a nesting of dicts, lists and tuples, with
    ``specs`` beside it (a spec is a tuple at a leaf's place); ``None``
    leaves stay ``None``."""
    if isinstance(state, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        if len(specs) != len(state):
            raise ValueError(f"{len(specs)} specs for {len(state)} entries")
        return type(state)(_map_specs(fn, v, s) for v, s in zip(state, specs))
    if state is None:
        return None
    return fn(state, specs)


def reshard_state(state: Any, new_mesh: VirtualMesh, specs: Any, *,
                  old_mesh: VirtualMesh | None = None) -> Any:
    """Elastic re-mesh: every leaf of ``state`` in ``new_mesh``'s stacked
    layout on ``new_mesh.device``, split as ``specs`` says (a tree beside
    ``state``: for each leaf one entry per array axis, a mesh-axis name, a
    tuple of names or ``None``; or a :class:`Pinned` spec).

    A leaf is a global array (a tensor on any device, or numpy); with
    ``old_mesh`` it is instead ``old_mesh``'s stacked layout under the same
    specs, as one process holds it: grow 4 -> 8, shrink 8 -> 6, shard sizes that do not divide each other, every boundary may
    move.  A leaf on ``new_mesh.device`` is moved by device copies alone,
    never through the host; the result owns its memory.
    """
    def as_tensor(leaf):
        return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(leaf))

    if old_mesh is not None:
        state = _map_specs(lambda leaf, spec: _from_stacked(as_tensor(leaf), old_mesh, spec),
                           state, specs)
    return _map_specs(lambda leaf, spec: _to_stacked(as_tensor(leaf).to(new_mesh.device),
                                                     new_mesh, spec), state, specs)
