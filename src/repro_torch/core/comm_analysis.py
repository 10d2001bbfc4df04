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

The FLOP and HBM-byte half of ``analyze_hlo`` has no counterpart here: it
belongs with the port of ``launch/dryrun.py`` (shapes from meta tensors).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.core import transport

__all__ = ["CollectiveStats", "count_collectives", "Hardware", "V5E", "H100",
           "RooflineTerms", "roofline"]


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
