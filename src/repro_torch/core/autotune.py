"""Online autotuner: pick the best exchange cell for the current topology
(PyTorch port of ``src/repro/core/autotune.py``, numpy only).

At plan-build time it picks the ``(strategy, packer, coalesce, n_parts)``
cell for the current ``(topology, message size, node_size)`` instead of
requiring the caller to hard-code one.  Two selection backends behind one
interface (:class:`Tuner`):

* **trace-driven** — a recorded sweep (``BENCH_torch_stencil_sweep.json``)
  is the ground truth.  A candidate whose cell was measured verbatim is
  scored by its recorded ``us_per_cycle`` (``selected_by="trace"``); one
  whose message size was never swept, from the nearest swept size plus a
  model-predicted delta (``"trace-nearest"``); an unswept candidate by the
  fitted per-strategy cost model alone (``"model"``).  Measurements
  outrank extrapolation.
* **in-situ calibration** — when no usable trace exists, each candidate is
  probed with a short timed run through the caller's plan cache, and the
  verdict is memoized in a persistent :class:`AutotuneCache`, so the next
  process skips the probes (``selected_by="cache"``).

The cost model is per strategy: ``us ~ c0 + c_w*wire_bytes +
c_c*collective_count + alpha*total_sends + delta*inter_node_sends`` with
every non-intercept coefficient clamped nonnegative, so predictions are
monotone in ``wire_bytes`` and ``inter_node_sends`` and an inter-node send
costs at least an intra-node one.

Where the port differs from the JAX package on purpose:

* its own env vars (:data:`TRACE_ENV`, :data:`CACHE_ENV`) and its own
  default cache ``~/.cache/repro_torch/autotune.json``: a verdict of the
  JAX package is never replayed here;
* a cell carries its device name (``"cpu"`` or the card's), which enters
  :func:`cell_key`, and trace rows and the cost model are those of records
  of the same device: a verdict or a trace taken on the CPU never resolves
  a cell on the card;
* :func:`default_tuner` reads traces with the port's own
  ``repro_torch.stencil.sweep.read_bench_json``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import tempfile
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.transport import available_packers, get_packer
from repro_torch.launch.mapping import available_mappings, get_mapping

#: the sentinel value `StrategyConfig`/CLIs use to request autotuning
AUTO = "auto"

#: env vars naming the trace file the cost model fits from and the
#: persistent calibration-verdict cache (both optional; the sweep CLI's
#: ``--autotune-trace``/``--autotune-cache`` set them)
TRACE_ENV = "REPRO_TORCH_AUTOTUNE_TRACE"
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

#: partition counts the candidate grid tries for partitioning strategies
DEFAULT_PART_COUNTS = (1, 2, 4)

#: timed-probe shape: short, Comb-style (warmup then a timed run)
PROBE_CYCLES = 3
PROBE_WARMUP = 1


# ---------------------------------------------------------------------------
# candidates and their static features
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One selectable exchange cell (the §VI coordinates autotuning ranges
    over; mapping/transport stay pinned by the caller — a driver cannot
    re-place an already-built mesh)."""

    strategy: str
    packer: str
    coalesce: bool
    n_parts: int = 1


@dataclasses.dataclass(frozen=True)
class CellFeatures:
    """Static cost-model inputs of one candidate on one topology — pure
    table math (:func:`repro_torch.core.transport.schedule_locality`), no timing."""

    wire_bytes: int
    collective_count: int
    intra_sends: int
    inter_sends: int

    @property
    def total_sends(self) -> int:
        return self.intra_sends + self.inter_sends

    def vector(self) -> tuple[float, ...]:
        """The regression row: ``[1, wire, collectives, total, inter]`` —
        parameterizing locality as ``alpha*total + delta*inter`` makes the
        fitted inter-node cost ``alpha + delta >= alpha`` by construction."""
        return (1.0, float(self.wire_bytes), float(self.collective_count),
                float(self.total_sends), float(self.inter_sends))


def max_face_elems(
    ghosted_shape: Sequence[int], array_axes: Sequence[int], halo: int
) -> int:
    """Largest face-slab element count of an exchange: ``halo`` thick along
    the exchanged axis, full ghosted extent along every other axis (the
    sequential corner-trick slab — matches ``Domain.max_face_bytes``)."""
    assert array_axes, "no decomposed axes"
    best = 0
    for a in array_axes:
        elems = halo * math.prod(
            g for i, g in enumerate(ghosted_shape) if i != a
        )
        best = max(best, elems)
    return best


def default_candidates(
    *,
    dtype: Any = "float32",
    strategies: Sequence[str] | None = None,
    packers: Sequence[str] | None = None,
    coalesce_modes: Sequence[bool] | None = None,
    part_counts: Sequence[int] = DEFAULT_PART_COUNTS,
) -> tuple[Candidate, ...]:
    """The candidate grid, honoring any caller-pinned axis.

    ``packers=None`` enumerates only the *exact* registered packers
    (``wire_tolerance == (0, 0)`` for ``dtype``; ``slice`` and ``cuda`` for
    f32): autotuning never picks lossy wire compression on its own.
    """
    from repro_torch.stencil.strategies import available_strategies, get_strategy

    if strategies is None:
        strategies = available_strategies()
    if packers is None:
        packers = tuple(
            p for p in available_packers()
            if get_packer(p).wire_tolerance(dtype) == (0.0, 0.0)
        )
    else:
        for p in packers:
            get_packer(p)
    if coalesce_modes is None:
        coalesce_modes = (False, True)
    out = []
    for s in strategies:
        parts = (
            tuple(dict.fromkeys(part_counts))
            if get_strategy(s).uses_partitions else (1,)
        )
        for coalesce in coalesce_modes:
            for packer in packers:
                out.extend(
                    Candidate(s, packer, bool(coalesce), p) for p in parts
                )
    assert out, "empty candidate grid"
    return tuple(out)


# ---------------------------------------------------------------------------
# trace-driven cost model
# ---------------------------------------------------------------------------


def _fit_nonneg(rows: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with every non-intercept coefficient clamped >= 0
    (active-set style: refit with negative columns removed until clean).
    Keeps predictions monotone in every feature; the intercept stays free."""
    n_cols = rows.shape[1]
    keep = set(range(1, n_cols))
    while True:
        cols = [0] + sorted(keep)
        coef_sub, *_ = np.linalg.lstsq(rows[:, cols], y, rcond=None)
        neg = [c for c, v in zip(cols, coef_sub) if c != 0 and v < 0]
        if not neg:
            coef = np.zeros(n_cols)
            coef[cols] = coef_sub
            return coef
        keep -= set(neg)
        if not keep:
            coef = np.zeros(n_cols)
            coef[0] = float(np.mean(y)) if len(y) else 0.0
            return coef


class TraceCostModel:
    """Per-strategy linear model over the static schedule features.

    ``predict`` is monotone (non-strictly) in ``wire_bytes`` and in
    ``inter_node_sends`` with everything else fixed, and the implied
    inter-node per-send cost is always >= the intra-node one.
    """

    def __init__(self, coefs: Mapping[str, np.ndarray]):
        self._coefs = dict(coefs)

    @classmethod
    def fit(cls, records: Sequence[Mapping]) -> "TraceCostModel":
        by_strategy: dict[str, list[tuple[tuple, float]]] = {}
        for r in records:
            feats = record_features(r)
            if feats is None:
                continue
            by_strategy.setdefault(r["strategy"], []).append(
                (feats.vector(), float(r["us_per_cycle"]))
            )
        coefs = {}
        for strategy, pairs in by_strategy.items():
            rows = np.array([v for v, _ in pairs], dtype=float)
            y = np.array([us for _, us in pairs], dtype=float)
            coefs[strategy] = _fit_nonneg(rows, y)
        return cls(coefs)

    def covers(self, strategy: str) -> bool:
        return strategy in self._coefs

    def predict(self, strategy: str, feats: CellFeatures) -> float:
        coef = self._coefs[strategy]
        us = float(np.dot(coef, np.asarray(feats.vector())))
        return max(us, 0.0)

    def locality_costs(self, strategy: str) -> tuple[float, float]:
        """(intra, inter) fitted per-send costs; inter >= intra always."""
        coef = self._coefs[strategy]
        alpha, delta = float(coef[3]), float(coef[4])
        return alpha, alpha + delta


def record_features(r: Mapping) -> CellFeatures | None:
    """The model features carried by a BENCH sweep record (``None`` when the
    record predates the locality/coalescing schema)."""
    try:
        return CellFeatures(
            wire_bytes=int(r.get("wire_bytes", r["message_bytes"])),
            collective_count=int(r["collective_count"]),
            intra_sends=int(r["intra_node_sends"]),
            inter_sends=int(r["inter_node_sends"]),
        )
    except (KeyError, TypeError):
        return None


# ---------------------------------------------------------------------------
# persistent calibration-verdict cache
# ---------------------------------------------------------------------------


def default_cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json"
    )


class AutotuneCache:
    """Durable ``cell key -> calibration verdict`` table (json on disk).

    Keys are built like plan keys — topology, dtype/shape, placement,
    transport, and the candidate grid that was raced — so a verdict is only
    reused for the exact selection problem it answered.  Writes are atomic
    (tempfile + rename); a missing or corrupt file is an empty cache, never
    an error (tuning must degrade to probing, not crash the exchange).
    """

    def __init__(self, path: str):
        self.path = path
        self._table: dict[str, dict] | None = None

    def _load(self) -> dict[str, dict]:
        if self._table is None:
            try:
                with open(self.path) as f:
                    payload = json.load(f)
                self._table = dict(payload) if isinstance(payload, dict) else {}
            except (OSError, ValueError):
                self._table = {}
        return self._table

    def get(self, key: str) -> dict | None:
        return self._load().get(key)

    def put(self, key: str, verdict: dict) -> None:
        table = self._load()
        table[key] = verdict
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(self.path) or ".", suffix=".autotune"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(table, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        return len(self._load())


def cell_key(cell: Mapping, candidates: Sequence[Candidate]) -> str:
    """The cache key of one selection problem (string: json must round-trip
    it; candidate order is irrelevant).  A cell without a ``device`` gets
    the JAX package's key; the port's cells carry one, appended last."""
    cand = ";".join(
        f"{c.strategy}@{c.packer}/c{int(c.coalesce)}/p{c.n_parts}"
        for c in sorted(candidates, key=lambda c: (
            c.strategy, c.packer, c.coalesce, c.n_parts))
    )
    return (
        f"mesh={tuple(cell['mesh_shape'])}|shape={tuple(cell['shape'])}"
        f"|dtype={cell['dtype']}|halo={cell['halo']}"
        f"|mapping={cell['mapping']}|transport={cell['transport']}"
        f"|node_size={cell['node_size']}|{cand}"
        + (f"|device={cell['device']}" if "device" in cell else "")
    )


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One selection outcome: the chosen cell plus its provenance — what
    drivers stamp into plan keys (``selected_by``) and BENCH records
    (``selected_by``/``predicted_us``/``calibration_us``)."""

    candidate: Candidate
    #: "trace" | "trace-nearest" | "model" | "calibration" | "cache"
    selected_by: str
    predicted_us: float
    #: wall time spent probing (0 for trace-driven and cache-hit verdicts)
    calibration_us: float = 0.0

    def plan_stamp(self) -> str:
        """What lands in plan keys: a cache hit replays the original
        calibration verdict, so the stamp (and therefore the plan key)
        stays identical across processes — only the BENCH record says
        "cache"."""
        return "calibration" if self.selected_by == "cache" else (
            self.selected_by
        )


class Tuner:
    """Trace-first, probe-fallback plan selection."""

    def __init__(
        self,
        trace_records: Sequence[Mapping] = (),
        cache: AutotuneCache | None = None,
    ):
        # only static measurements are ground truth: an autotuned record
        # re-fed as trace would amplify earlier selection, not evidence
        self.trace = [r for r in trace_records if not r.get("selected_by")]
        #: one cost model per device the trace was taken on
        self.models = {
            dev: TraceCostModel.fit([r for r in self.trace if r.get("device") == dev])
            for dev in dict.fromkeys(r.get("device") for r in self.trace)
        }
        self.cache = cache

    def model_for(self, cell: Mapping) -> TraceCostModel | None:
        """The cost model fitted on the cell's own device's records."""
        return self.models.get(cell.get("device"))

    # -- trace backend ------------------------------------------------------
    def _trace_rows(self, cand: Candidate, cell: Mapping) -> list[Mapping]:
        rows = []
        for r in self.trace:
            if (r.get("strategy") == cand.strategy
                    and r.get("packer", "slice") == cand.packer
                    and bool(r.get("coalesce", False)) == cand.coalesce
                    and int(r.get("n_parts", 1)) == cand.n_parts
                    and r.get("mapping", "row-major") == cell["mapping"]
                    and r.get("transport", "loopback") == cell["transport"]
                    and r.get("device") == cell.get("device")
                    and tuple(r.get("mesh_shape", ())) == tuple(
                        cell["mesh_shape"])
                    and int(r.get("node_size", 0)) == int(cell["node_size"])):
                rows.append(r)
        return rows

    def trace_verdict(
        self, cand: Candidate, feats: CellFeatures, cell: Mapping
    ) -> Verdict | None:
        rows = self._trace_rows(cand, cell)
        model = self.model_for(cell)
        if not rows:
            if model is not None and model.covers(cand.strategy):
                return Verdict(cand, "model", model.predict(cand.strategy, feats))
            return None
        mb = int(cell["message_bytes"])
        exact = [r for r in rows if int(r["message_bytes"]) == mb]
        if exact:
            us = float(np.mean([r["us_per_cycle"] for r in exact]))
            return Verdict(cand, "trace", us)
        # nearest swept size (log distance: 2x too small == 2x too big),
        # shifted by the model's delta between the two feature points
        nearest = min(
            rows, key=lambda r: abs(math.log(max(int(r["message_bytes"]), 1)
                                             / max(mb, 1)))
        )
        us = float(nearest["us_per_cycle"])
        near_feats = record_features(nearest)
        if (model is not None and model.covers(cand.strategy)
                and near_feats is not None):
            us += (model.predict(cand.strategy, feats)
                   - model.predict(cand.strategy, near_feats))
        return Verdict(cand, "trace-nearest", max(us, 0.0))

    def choose(
        self,
        candidates: Sequence[Candidate],
        features: Mapping[Candidate, CellFeatures],
        cell: Mapping,
    ) -> Verdict | None:
        """Trace-driven selection, or ``None`` when no candidate has any
        trace/model support (the caller then calibrates).

        Tiered: measured cells (``trace``) outrank size-interpolated ones
        (``trace-nearest``), which outrank pure model extrapolation — a
        modeled candidate can never beat a measured one on predicted
        microseconds alone.
        """
        verdicts = [
            v for c in candidates
            if (v := self.trace_verdict(c, features[c], cell)) is not None
        ]
        if not verdicts:
            return None
        for tier in ("trace", "trace-nearest", "model"):
            in_tier = [v for v in verdicts if v.selected_by == tier]
            if in_tier:
                return min(in_tier, key=lambda v: v.predicted_us)
        raise AssertionError(verdicts)  # unreachable: tiers are exhaustive

    # -- calibration backend -----------------------------------------------
    def calibrate(
        self,
        candidates: Sequence[Candidate],
        cell: Mapping,
        probe: Callable[[Candidate], float],
    ) -> Verdict:
        """Race the candidates with short timed probes; memoize the verdict.

        A probe that raises ends the calibration with its error: every
        candidate's topology was already validated when its features were
        derived, so a probe fails only where a kernel fails to build or
        launch, and skipping it would hand the cell to another packer
        (the JAX package skips failing probes).
        """
        key = cell_key(cell, candidates)
        if self.cache is not None:
            hit = self.cache.get(key)
            if hit is not None:
                return Verdict(
                    Candidate(hit["strategy"], hit["packer"],
                              bool(hit["coalesce"]), int(hit["n_parts"])),
                    "cache", float(hit["predicted_us"]), 0.0,
                )
        t0 = time.perf_counter()
        us, cand = min(((float(probe(c)), c) for c in candidates),
                       key=lambda t: t[0])
        calibration_us = (time.perf_counter() - t0) * 1e6
        if self.cache is not None:
            self.cache.put(key, {
                "strategy": cand.strategy, "packer": cand.packer,
                "coalesce": cand.coalesce, "n_parts": cand.n_parts,
                "predicted_us": us, "calibration_us": calibration_us,
            })
        return Verdict(cand, "calibration", us, calibration_us)

    def choose_or_calibrate(
        self,
        candidates: Sequence[Candidate],
        features: Mapping[Candidate, CellFeatures],
        cell: Mapping,
        probe: Callable[[Candidate], float],
    ) -> Verdict:
        verdict = self.choose(candidates, features, cell)
        if verdict is not None:
            return verdict
        return self.calibrate(candidates, cell, probe)


# ---------------------------------------------------------------------------
# process-wide default tuner (env-configured)
# ---------------------------------------------------------------------------

_TUNERS: dict[tuple[str | None, str | None], Tuner] = {}


def default_tuner() -> Tuner:
    """The env-configured tuner: trace from ``REPRO_TORCH_AUTOTUNE_TRACE``
    (fitted once per process per path), persistent verdicts at
    ``REPRO_TORCH_AUTOTUNE_CACHE`` (default
    ``~/.cache/repro_torch/autotune.json``)."""
    trace_path = os.environ.get(TRACE_ENV) or None
    cache_path = default_cache_path()
    key = (trace_path, cache_path)
    if key not in _TUNERS:
        records: list[Mapping] = []
        if trace_path:
            from repro_torch.stencil.sweep import read_bench_json

            records, _config = read_bench_json(trace_path)
        _TUNERS[key] = Tuner(records, cache=AutotuneCache(cache_path))
    return _TUNERS[key]


def reset_default_tuners() -> None:
    """Drop memoized tuners (tests re-pointing the env vars)."""
    _TUNERS.clear()


# ---------------------------------------------------------------------------
# mapping selection (mesh-build time — a driver cannot re-place its mesh)
# ---------------------------------------------------------------------------


def choose_mapping(
    mesh_shape: Sequence[int], node_size: int, periodic: bool = True
) -> str:
    """The registered mapping minimizing inter-node nearest-neighbor sends
    on this torus — the ``mapping="auto"`` resolution the launch layer runs
    *before* building a mesh.

    Scored on the generic halo pattern (one +/-1 exchange per mesh axis)
    rather than any one strategy's tables: the placement axis is schedule-
    independent (re-plan purity), so the neighbor structure is all that
    matters.  Ties resolve in registration order (row-major first — the
    identity placement wins unless a permutation strictly helps).
    """
    shape = tuple(mesh_shape)

    def flat(coords: Sequence[int]) -> int:
        idx = 0
        for c, k in zip(coords, shape):
            idx = idx * k + c
        return idx

    best_name, best_inter = None, None
    for name in available_mappings():
        node_of = get_mapping(name).node_of(shape, node_size)
        inter = 0
        for coords in itertools.product(*map(range, shape)):
            for a, k in enumerate(shape):
                if k == 1:
                    continue
                for d in (-1, 1):
                    c = coords[a] + d
                    if not periodic and not 0 <= c < k:
                        continue
                    dst = list(coords)
                    dst[a] = c % k
                    if node_of[flat(coords)] != node_of[flat(dst)]:
                        inter += 1
        if best_inter is None or inter < best_inter:
            best_name, best_inter = name, inter
    assert best_name is not None
    return best_name
