"""Collective accounting and roofline terms: the port's counterpart of
``src/repro/core/hlo_analysis.py``.

The JAX module reads its numbers off the post-optimization HLO text of a
compiled program.  The port compiles no program, so HLO text, loop trip
counts and fusion have no meaning here; what the JAX module derives from
them is taken from the collectives as the port issues them:

* :func:`count_collectives` runs a function once with the transport's
  collective log switched on (:data:`repro_torch.core.transport.OP_LOG`)
  and sums what it logged, under the HLO op names and with the per-device
  wire factors of ``hlo_analysis._wire_bytes``.  The log is written by
  every rank gather of a :meth:`~repro_torch.core.transport.Transport.move`
  (through :meth:`~repro_torch.core.transport.PreparedExchange.run`,
  :meth:`~repro_torch.core.transport.Transport.permute` or a plan's step):
  one ``collective-permute`` of one rank's wire bytes; a hop-free self-copy
  is none, as in ``scheduled_collective_count``.  The stacked-rank
  reductions of :mod:`repro_torch.core.partitioned` log an ``all-reduce``
  (``psum``, over its group), a ``reduce-scatter`` (``psum_scatter``) and an
  ``all-to-all``; a group of one rank is none.  Counts are per executed
  call (JAX counts an op in a loop body once).  XLA may combine or drop
  collectives (its all-reduce combiner merges the chunks of a partitioned
  ``psum`` into one); the log counts what the port issues.  A CUDA graph
  replay runs no Python, so the count comes from an eager run (a plan's
  :attr:`~repro_torch.core.plan.CommPlan.fn`), never from a replay, and
  nothing is logged during a capture.
* :class:`Hardware`, :data:`V5E`, :class:`RooflineTerms` and
  :func:`roofline` are the JAX module's, with :data:`H100` beside
  :data:`V5E`; :attr:`RooflineTerms.mfu_bound` divides by the peak of the
  hardware the terms were built with (the JAX property divides by
  ``V5E``'s whatever ``hw`` was).

* :func:`count_cost` is the FLOP and HBM-byte half of ``analyze_hlo``:
  it runs a function once (on meta tensors for the dry-run,
  :mod:`repro_torch.launch.dryrun`, or on any device) under a
  ``TorchDispatchMode`` that sees every op dispatched, forward and
  backward, a remat's recomputation included.  FLOPs are the matrix
  products' (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the convolutions:
  ``torch.utils.flop_counter``'s formulas, ``2 x |result| x
  |contracting|`` as ``_dot_flops``) plus what the hand-written kernels'
  meta routes record (:mod:`repro_torch.kernels.costs`: each kernel at its
  own traffic, where JAX's dry-run counts its plain attention).  Bytes
  follow ``_op_traffic``: each op is charged its result plus its
  operands; an op whose output aliases its input (a view, a reshape that
  is a view, a transpose, an expand, a slice, ``detach``) nothing, as
  ``_NO_TRAFFIC_OPS``; a scatter (``index_put``, ``scatter``,
  ``index_add``, the embedding's backward) three times its operands but
  the largest, a gather (``index``, ``gather``, ``index_select``,
  ``embedding``) twice its result; an allocation (``empty``) nothing.  The
  port fuses nothing, so every op is a top-level op.  The peak is the
  most bytes live at once of the storages made during the call (a storage
  counted once whatever its views, released by a finalizer when its last
  tensor goes).  Collectives are :func:`count_collectives`' fields.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import transport
from repro_torch.kernels import _build

__all__ = ["CollectiveStats", "count_collectives", "CostStats", "count_cost", "counting",
           "repeated", "Hardware", "V5E", "H100", "RooflineTerms", "roofline"]


def _wire_bytes(op: str, result_bytes: float, g: int) -> float:
    """Per-device wire bytes of one collective with ``result_bytes`` per
    device over a group of ``g`` (``hlo_analysis._wire_bytes``: ring
    algorithms)."""
    g = max(g, 1)
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(result_bytes) * (g - 1)
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    if op == "collective-permute":
        return float(result_bytes)
    raise ValueError(op)


@dataclass
class CollectiveStats:
    """Per-device collective totals of one call (the fields of the object
    ``parse_collectives`` returns); ``log`` holds the call's entries in
    issue order and ``result`` what the call returned."""

    wire_bytes: float = 0.0
    by_op_bytes: dict = field(default_factory=dict)
    by_op_counts: dict = field(default_factory=dict)
    log: list = field(default_factory=list)
    result: Any = None

    @classmethod
    def from_log(cls, log: list, result: Any = None) -> "CollectiveStats":
        by_bytes: dict[str, float] = defaultdict(float)
        by_counts: dict[str, int] = defaultdict(int)
        wire = 0.0
        for op, nbytes, group in log:
            wb = _wire_bytes(op, nbytes, 1 if group is None else group)
            wire += wb
            by_bytes[op] += wb
            by_counts[op] += 1
        return cls(wire, dict(by_bytes), dict(by_counts), list(log), result)

    def summary(self) -> str:
        parts = [f"wire={self.wire_bytes/1e9:.3f}GB"]
        for op in sorted(self.by_op_bytes):
            parts.append(f"{op}={self.by_op_bytes[op]/1e9:.3f}GB"
                         f"(x{self.by_op_counts[op]})")
        return " ".join(parts)


def count_collectives(fn: Callable, *args: Any, **kw: Any) -> CollectiveStats:
    """Run ``fn(*args, **kw)`` once, eagerly, with the collective log on,
    and return its collectives (the counterpart of ``parse_collectives``;
    ``.result`` is what ``fn`` returned).  A count inside another count
    adds its entries to the outer one's too."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("count_collectives inside a CUDA graph capture: a replay runs no "
                           "Python, so count an eager run")
    outer, log = transport.OP_LOG, []
    transport.OP_LOG = log
    try:
        result = fn(*args, **kw)
    finally:
        transport.OP_LOG = outer
        if outer is not None:
            outer.extend(log)
    return CollectiveStats.from_log(log, result)


# ---------------------------------------------------------------------------
# FLOPs, HBM bytes and the peak of one call
# ---------------------------------------------------------------------------

#: the matrix products whose FLOPs count (``_dot_flops``'s dots, and the
#: convolutions)
_PRODUCTS = frozenset(getattr(torch.ops.aten, n) for n in (
    "mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution", "convolution_backward"))
#: allocations: their result is not written
_ALLOCATIONS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                          "new_empty_strided"})
#: in-place writes of the result alone (its old contents are not read)
_WRITES = frozenset({"fill_", "zero_", "normal_", "uniform_", "random_", "bernoulli_"})
#: scatters: three times the operands but the largest (the destination)
_SCATTERS = frozenset({"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
                       "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
                       "index_add", "index_add_", "index_copy", "index_copy_",
                       "masked_scatter", "masked_scatter_", "embedding_dense_backward"})
#: gathers: twice the result
_GATHERS = frozenset({"index", "gather", "index_select", "embedding", "take"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any, out: list) -> list:
    """The tensors of an op's arguments or result (tuples and lists of
    them), in order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    return out


@dataclass
class CostStats(CollectiveStats):
    """One call's FLOPs, HBM bytes and peak (:func:`count_cost`) beside its
    collectives (the fields of :class:`CollectiveStats`); ``kernels``: per
    hand-written kernel whose meta route ran, its calls, FLOPs and bytes
    (already in ``flops`` and ``bytes``); ``ops``: the ops dispatched."""

    flops: int = 0
    bytes: int = 0
    peak_bytes: int = 0
    kernels: dict = field(default_factory=dict)
    ops: int = 0


class _CostMode(TorchDispatchMode):
    """Sees every op dispatched while it is on (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0  # ints: a count of many ops stays exact
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: set[int] = set()

    def _release(self, key: int, nbytes: int) -> None:
        self._storages.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func.overloadpacket
        if packet in _PRODUCTS:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ins = _tensors(args, [])
        for k, v in kwargs.items():
            if k != "out":
                _tensors(v, ins)
        outs = _tensors(out, [])
        in_storages = {t.untyped_storage()._cdata for t in ins}
        name = packet.__name__
        if (not func._schema.is_mutable
                and all(t.untyped_storage()._cdata in in_storages for t in outs)):
            return out  # a view of an input: no traffic, no storage
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._storages and key not in in_storages:
                nbytes = st.nbytes()
                self._storages.add(key)
                self.live += nbytes
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._release, key, nbytes)
        operand_b = [_nbytes(t) for t in ins]
        result_b = sum(_nbytes(t) for t in outs)
        if name in _ALLOCATIONS:
            return out
        if name in _WRITES:
            self.bytes += result_b
        elif name == "copy_":
            self.bytes += result_b + sum(operand_b[1:])
        elif name in _SCATTERS:
            if name == "embedding_dense_backward":  # its destination is made inside
                operand_b.append(result_b)
            self.bytes += 3 * (sum(operand_b) - max(operand_b, default=0))
        elif name in _GATHERS:
            self.bytes += 2 * result_b
        else:
            self.bytes += result_b + sum(operand_b)
        return out


#: the count :func:`count_cost` runs, while it runs
_ACTIVE: _CostMode | None = None


def counting() -> bool:
    """Whether a :func:`count_cost` is running."""
    return _ACTIVE is not None


@contextlib.contextmanager
def repeated(n: int, *, collectives: bool = False):
    """Inside a :func:`count_cost`, what the block counts (FLOPs, bytes,
    ops, the kernels' calls) counts ``n`` times: a block that stands for
    ``n`` passes of the same shapes, run once (the meta step's data ranks
    and microbatches, :mod:`repro_torch.train.train_loop`).  Its storages
    count once.  Its collectives count ``n`` times with ``collectives``
    (passes one device runs in turn: the microbatches), else once (passes
    that run side by side on other devices: the data ranks, whose
    collectives a per-device count takes once).  Outside a count it does
    nothing."""
    mode = _ACTIVE
    if mode is None or n == 1:
        yield
        return
    flops, nbytes, ops, logged = mode.flops, mode.bytes, mode.ops, len(_build.COST_LOG)
    issued = len(transport.OP_LOG) if transport.OP_LOG is not None else 0
    yield
    mode.flops += (n - 1) * (mode.flops - flops)
    mode.bytes += (n - 1) * (mode.bytes - nbytes)
    mode.ops += (n - 1) * (mode.ops - ops)
    _build.COST_LOG.extend(_build.COST_LOG[logged:] * (n - 1))
    if collectives and transport.OP_LOG is not None:
        transport.OP_LOG.extend(transport.OP_LOG[issued:] * (n - 1))


def count_cost(fn: Callable, *args: Any, **kw: Any) -> CostStats:
    """Run ``fn(*args, **kw)`` once under the cost count (module
    docstring) and return its :class:`CostStats` (``.result`` is what
    ``fn`` returned).  The totals are of the whole call: on a mesh of
    stacked ranks, every rank's."""
    global _ACTIVE
    mode, outer, outer_log, log = _CostMode(), _ACTIVE, _build.COST_LOG, []
    _build.COST_LOG, _ACTIVE = log, mode
    try:
        with mode:
            coll = count_collectives(fn, *args, **kw)
    finally:
        _build.COST_LOG, _ACTIVE = outer_log, outer
        if outer_log is not None:
            outer_log.extend(log)
    kernels: dict = {}
    for name, flops, nbytes in log:
        k = kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
    return CostStats(coll.wire_bytes, coll.by_op_bytes, coll.by_op_counts, coll.log, coll.result,
                     flops=mode.flops + sum(k["flops"] for k in kernels.values()),
                     bytes=mode.bytes + sum(k["bytes"] for k in kernels.values()),
                     peak_bytes=mode.peak, kernels=kernels, ops=mode.ops)


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # bytes/s per chip
    ici_bw: float = 50e9  # bytes/s per link (1 link assumed; conservative)
    hbm_per_chip: float = 16e9


#: the JAX package's TPU v5e constants, kept for parity
V5E = Hardware()

#: NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU datasheet:
#: 989 TFLOP/s dense BF16 on the tensor cores (1979 is with sparsity),
#: 3.35 TB/s of HBM3 (the rate ``chip_smoke.HBM_BYTES_PER_S`` bounds the
#: kernels by), 80 GB of HBM, and NVLink 4 at 900 GB/s a card, 450 GB/s
#: each way.  On one card the ranks of a virtual mesh are stacked in one
#: tensor and a hop between them is an HBM copy, so ``collective_s`` under
#: ``H100`` bounds a deployment over several cards joined by NVLink, not
#: the virtual ring.
H100 = Hardware(name="h100-sxm5", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                hbm_per_chip=80e9)


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    hlo_bytes: float
    wire_bytes: float
    #: the hardware the terms were built with (:attr:`mfu_bound` divides by
    #: its peak)
    hw: Hardware = V5E

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def step_time_s(self) -> float:
        """Roofline step time: the dominant term (perfect-overlap bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / executed FLOPs (per device): the fraction of the
        compute that is 'useful', which catches remat and redundancy."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound, on ``hw``."""
        t = self.step_time_s
        return (self.model_flops / self.hw.peak_flops) / t if t else 0.0


def roofline(
    *,
    hlo_flops_per_device: float,
    hlo_bytes_per_device: float,
    wire_bytes_per_device: float,
    model_flops_global: float,
    n_chips: int,
    hw: Hardware = V5E,
) -> RooflineTerms:
    """The JAX function's terms (its keyword names kept: ``hlo_*`` are the
    FLOPs and HBM bytes a device executes, however they were counted)."""
    return RooflineTerms(
        compute_s=hlo_flops_per_device / hw.peak_flops,
        memory_s=hlo_bytes_per_device / hw.hbm_bw,
        collective_s=wire_bytes_per_device / hw.ici_bw,
        model_flops=model_flops_global / max(1, n_chips),
        hlo_flops=hlo_flops_per_device,
        hlo_bytes=hlo_bytes_per_device,
        wire_bytes=wire_bytes_per_device,
        hw=hw,
    )
