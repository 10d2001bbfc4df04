"""The paper's §VI parameter study as a sweep (PyTorch port of
``src/repro/stencil/sweep.py``).

The paper sweeps *process count*, *thread count* and *message size* over
Comb's exchange strategies.  The port's analogues:

* **virtual rank count**    (process count)  — the ranks of a
  :class:`~repro_torch.core.mesh.VirtualMesh`, stacked on the device of
  one process, or of each of ``processes`` processes of a grid;
* **partition count**       (thread count)   — ``StrategyConfig.n_parts``;
* **message size**          — the domain's face-slab bytes, varied through
  ``global_interior``;
* **packer**                — ``"slice"`` (plain tensor copies) vs
  ``"cuda"`` (the hand-written copy/gather kernels), and the lossy wires;
* **coalesce**              — one wire buffer and one rank gather per hop
  chain vs one per message; the first mode hosts the baseline cell;
* **mapping**               — the process-to-node placement
  (:mod:`repro_torch.launch.mapping`): each swept mapping builds the cell's
  mesh with its placement, and every record carries the static
  hop-locality tally (``intra_node_sends`` / ``inter_node_sends``).  The
  first mapping hosts the baseline cell.

Every cell measures the requested strategies through
:func:`repro_torch.stencil.comb.comb_measure` and emits one flat record per
(strategy, cell) with its speedup against the baseline, serialized to
``BENCH_<name>.json``.  The records carry the JAX package's keys
(:data:`RECORD_KEYS`) plus ``device``.

Where the port differs from the JAX sweep on purpose:

* with ``processes == 1`` rank counts run in this process, one after the
  other (a virtual mesh has no device count fixed at start-up, so no
  subprocess per count), and the card's cache is emptied between counts;
* with ``processes > 1`` each rank count boots as a grid of ``processes``
  worker processes (:func:`repro_torch.launch.stencil.launch_grid`), each
  stacking ``n // processes`` ranks, its cells moving through the
  ``multihost`` transport (``loopback`` cannot cross processes); rank 0
  prints the records, which stamp ``process_count`` and ``is_multihost``;
* ``device=`` (the CLI's ``--device``, default ``cuda``) picks the card or
  the CPU; the config block stamps the device's name and the torch and
  CUDA versions.

In-process use::

    records = sweep_cells(smoke_config(4), device="cpu")

The CLI (the card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.stencil.sweep --smoke --device cpu \
        --out BENCH_torch_verify.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import warnings
from typing import Any, Sequence

import torch

from repro_torch.core.compat import device_name, resolve_device
from repro_torch.core.mesh import make_mesh
from repro_torch.core.transport import (
    available_packers,
    get_packer,
    get_transport,
    schedule_locality,
)
from repro_torch.launch.mapping import (
    available_mappings,
    canonical_mapping,
    default_node_size,
    get_mapping,
)
from repro_torch.launch.stencil import process_grid
from repro_torch.stencil.comb import comb_measure, result_label
from repro_torch.stencil.domain import Domain
from repro_torch.stencil.strategies import (
    StrategyConfig,
    available_strategies,
    get_strategy,
    make_driver,
)

SCHEMA_VERSION = 1

#: keys every sweep record carries: the JAX package's, plus ``device``
RECORD_KEYS = (
    "bench", "schema_version", "strategy", "n_devices", "n_parts",
    "packer", "transport", "coalesce", "process_count", "is_multihost",
    "mapping", "node_size", "intra_node_sends", "inter_node_sends",
    "global_interior", "mesh_shape", "message_bytes", "wire_bytes",
    "us_per_cycle", "collective_count",
    "plan_cache_inits", "plan_cache_hits",
    "replan_us", "plan_cache_invalidations",
    "selected_by", "predicted_us", "calibration_us",
    "recovery_mode", "join_us", "warm_ranks",
    "init_us", "n_cycles", "repeats", "checksum", "speedup_vs_baseline",
    "device",
)


def mesh_shape_for(
    n_devices: int, mesh_ndim: int, *, warn: bool = False
) -> tuple[int, ...]:
    """The cell's mesh shape: a 1-D row, or an ``(n/2, 2)`` torus when a
    2-D cell is requested and the device count allows one.

    A 2-D request the device count cannot honor (odd or prime counts)
    silently used to degrade to a 1×N row where no corner chains exist —
    coalescing then measures as a no-op without any trace of why.  With
    ``warn=True`` (the cell-construction sites) the degradation warns, and
    :func:`config_block` records the effective shapes so figures can
    annotate these cells.
    """
    if mesh_ndim == 2:
        if n_devices >= 4 and n_devices % 2 == 0:
            return (n_devices // 2, 2)
        if warn:
            warnings.warn(
                f"mesh_ndim=2 requested but {n_devices} device(s) cannot "
                f"form an (n/2, 2) torus; degrading to the 1-D mesh row "
                f"({n_devices},) — no corner/edge chains exist there, so "
                f"the coalesce axis measures as a no-op for this cell",
                RuntimeWarning,
                stacklevel=2,
            )
    return (n_devices,)


def _assert_decomposable(
    size: tuple[int, ...], mesh_shape: tuple[int, ...], halo: int, why: str
) -> None:
    """The one size-vs-mesh validity rule (config construction and
    :func:`sweep_cells` use it)."""
    if len(size) < len(mesh_shape):
        raise ValueError(f"size {size} has fewer axes than mesh {mesh_shape}")
    for extent, k in zip(size, mesh_shape):
        if extent % k or extent // k < 3 * halo:
            raise ValueError(f"size {size} not decomposable over mesh {mesh_shape}; {why}")


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """The §VI grid: rank count x partition count x message/domain size;
    fields and defaults as ``repro.stencil.sweep.SweepConfig`` except the
    packers (``slice``, ``cuda``) and the transport (``loopback``)."""

    device_counts: tuple[int, ...] = (2, 4, 8)
    part_counts: tuple[int, ...] = (1, 2, 4)
    #: global interior shapes; the first axes are decomposed over the mesh
    sizes: tuple[tuple[int, ...], ...] = ((32, 16), (64, 32))
    strategies: tuple[str, ...] = (
        "standard", "persistent", "partitioned", "fused", "overlap",
    )
    #: pack backends to sweep (the first hosts the baseline)
    packers: tuple[str, ...] = ("slice", "cuda")
    #: transport every cell's messages move through
    transport: str = "loopback"
    #: coalescing modes to sweep; the FIRST hosts the baseline cell
    coalesce_modes: tuple[bool, ...] = (False, True)
    #: process-to-node mappings to sweep; the FIRST hosts the baseline cell
    mappings: tuple[str, ...] = ("row-major",)
    #: ranks per modeled node for the hop-locality tally; 0 = derive via
    #: repro_torch.launch.mapping.default_node_size (a two-node split)
    node_size: int = 0
    #: processes of the grid each rank count boots as (1 = in this process)
    processes: int = 1
    #: 1 = the paper's 1-D rank row; 2 = an (n/2, 2) torus over the first
    #: two array axes (edges and corners exist, so coalescing has chains)
    mesh_ndim: int = 1
    baseline: str = "standard"
    halo: int = 1
    n_cycles: int = 20
    repeats: int = 2
    seed: int = 0

    def __post_init__(self):
        if self.baseline not in self.strategies:
            raise ValueError(f"baseline {self.baseline!r} must be swept")
        # an autotuned baseline would normalize every speedup against a
        # moving target
        if self.baseline == "auto":
            raise ValueError("baseline cannot be autotuned")
        if not self.packers or not self.coalesce_modes or not self.mappings:
            raise ValueError("packers, coalesce_modes and mappings must be non-empty")
        if not all(isinstance(c, bool) for c in self.coalesce_modes) or len(
                set(self.coalesce_modes)) != len(self.coalesce_modes):
            raise ValueError(f"coalesce_modes {self.coalesce_modes}")
        if self.processes < 1 or self.node_size < 0:
            raise ValueError((self.processes, self.node_size))
        if self.processes > 1 and self.transport == "loopback":
            raise ValueError(f"transport {self.transport!r} cannot cross processes; a grid of "
                             f"{self.processes} needs transport='multihost'")
        for n in self.device_counts:
            if n % self.processes:
                raise ValueError(f"device count {n} not divisible into {self.processes} "
                                 f"process ranks")
        canon = tuple(canonical_mapping(m) for m in self.mappings)
        if len(set(canon)) != len(canon):
            raise ValueError(f"duplicate mapping cells after alias resolution: {self.mappings}")
        object.__setattr__(self, "mappings", canon)
        for p in self.packers:
            get_packer(p)
        get_transport(self.transport)
        if self.mesh_ndim not in (1, 2):
            raise ValueError(f"mesh_ndim {self.mesh_ndim}")
        for n in self.device_counts:
            for size in self.sizes:
                _assert_decomposable(size, mesh_shape_for(n, self.mesh_ndim), self.halo,
                                     f"device count {n}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "SweepConfig":
        raw = json.loads(text)
        raw["device_counts"] = tuple(raw["device_counts"])
        raw["part_counts"] = tuple(raw["part_counts"])
        raw["sizes"] = tuple(tuple(s) for s in raw["sizes"])
        raw["strategies"] = tuple(raw["strategies"])
        raw["packers"] = tuple(raw.get("packers", ("slice",)))
        raw["coalesce_modes"] = tuple(bool(c) for c in raw.get("coalesce_modes", (False,)))
        raw.setdefault("mesh_ndim", 1)
        raw["mappings"] = tuple(raw.get("mappings", ("row-major",)))
        raw.setdefault("node_size", 0)
        return cls(**raw)


def _size_records(
    config: SweepConfig, size: tuple[int, ...], n_devices: int, device
) -> list[dict]:
    """Measure one (rank count, size) slab: non-partitioning strategies once
    per (packer, coalesce mode), partitioning ones once per partition count
    too, each mapping on a mesh with its placement, all against the same
    baseline run (the first mapping's first-packer first-mode baseline
    strategy)."""
    n_proc, rank = process_grid()
    if n_proc != config.processes:
        raise RuntimeError(f"the config asks for {config.processes} processes, this grid has "
                           f"{n_proc} (run_sweep boots the grid)")
    mesh_shape = mesh_shape_for(n_devices, config.mesh_ndim, warn=True)
    axis_names = ("px", "py")[: len(mesh_shape)]
    axis_sizes = dict(zip(axis_names, mesh_shape))
    # on a grid a node is a process
    node_size = config.node_size or default_node_size(n_devices, n_proc)
    base_us: float | None = None
    # message tables depend on (strategy, n_parts) only, never on the
    # mapping: derived once, re-classified under each mapping's node vector
    groups_cache: dict[tuple[str, int], tuple] = {}
    records: list[dict] = []
    for mapping in config.mappings:
        placement = get_mapping(mapping).placement(mesh_shape, node_size)
        mesh = make_mesh(mesh_shape, axis_names, device=device, placement=placement,
                         processes=n_proc, process_index=rank)
        domain = Domain(mesh, tuple(size), axis_names + (None,) * (len(size) - len(mesh_shape)),
                        halo=config.halo)
        strat_configs = []
        for coalesce in config.coalesce_modes:
            for packer in config.packers:
                knobs = dict(packer=packer, transport=config.transport,
                             coalesce=coalesce, mapping=mapping)
                for s in config.strategies:
                    if s == "auto":
                        continue  # one tuned cell per mapping, added below
                    if get_strategy(s).uses_partitions:
                        strat_configs.extend(StrategyConfig(name=s, n_parts=p, **knobs)
                                             for p in config.part_counts)
                    else:
                        strat_configs.append(StrategyConfig(name=s, **knobs))
        if "auto" in config.strategies:
            # ONE tuned cell per mapping: the tuner owns the other axes
            strat_configs.append(StrategyConfig(
                name="auto", packer="auto", coalesce="auto",
                transport=config.transport, mapping=mapping,
            ))
        results = comb_measure(domain, strategies=tuple(strat_configs),
                               n_cycles=config.n_cycles, repeats=config.repeats,
                               seed=config.seed)
        if base_us is None:
            base_us = results[result_label(config.baseline, config.packers[0],
                                           config.coalesce_modes[0])].us_per_cycle
        node_of = get_mapping(mapping).node_of(mesh_shape, node_size)
        # shape and dtype only: the tables never read data
        example = torch.empty(domain.stacked_shape, dtype=domain.torch_dtype, device="meta")
        message_bytes = domain.max_face_bytes()
        face_elems = message_bytes // domain.torch_dtype.itemsize
        for res in results.values():
            key = (res.strategy, res.n_parts)
            if key not in groups_cache:
                drv = make_driver(StrategyConfig(name=res.strategy, n_parts=res.n_parts),
                                  domain.mesh, domain.halo_spec, ndim=len(size))
                groups_cache[key] = drv.replan_tables(example)[0]
            loc = schedule_locality(groups_cache[key], axis_order=axis_names,
                                    axis_sizes=axis_sizes, node_of=node_of)
            records.append({
                "bench": "stencil_sweep",
                "schema_version": SCHEMA_VERSION,
                "n_devices": n_devices,
                "process_count": n_proc,
                "is_multihost": n_proc > 1,
                "node_size": node_size,
                "intra_node_sends": loc.intra_sends,
                "inter_node_sends": loc.inter_sends,
                "global_interior": list(size),
                "mesh_shape": list(mesh_shape),
                "message_bytes": message_bytes,
                # the face's cost on the wire under this record's packer
                "wire_bytes": face_elems * get_packer(res.packer).wire_itemsize(domain.dtype),
                "speedup_vs_baseline": base_us / res.us_per_cycle,
                **res.record(),
            })
    return records


def sweep_cells(
    config: SweepConfig, *, n_devices: int | None = None, device=None
) -> list[dict]:
    """The partition-count x size grid at ONE rank count (``n_devices``,
    default the config's largest) on ``device`` (default the card), in
    this process; with ``config.processes > 1`` every process of the grid
    calls it (as :func:`run_sweep`'s workers do)."""
    n = n_devices or max(config.device_counts)
    for size in config.sizes:
        _assert_decomposable(size, mesh_shape_for(n, config.mesh_ndim), config.halo,
                             f"{n} ranks")
    records = []
    for size in config.sizes:
        records.extend(_size_records(config, size, n, device))
    return records


def run_sweep(config: SweepConfig, *, device=None, timeout: float = 1200.0) -> list[dict]:
    """The full §VI grid.  With ``config.processes == 1`` every rank count
    runs in this process, one after the other, the card's cache emptied
    between counts.  With ``processes > 1`` each rank count boots as a
    grid of that many worker processes (:func:`repro_torch.launch.stencil.
    launch_grid`, ``timeout`` seconds each) that run :func:`sweep_cells`
    SPMD, ``n // processes`` ranks each; rank 0 prints the records."""
    dev = resolve_device(device)
    records: list[dict] = []
    for n in config.device_counts:
        sub = dataclasses.replace(config, device_counts=(n,))
        if config.processes > 1:
            from repro_torch.launch.stencil import launch_grid

            stdout = launch_grid(
                [sys.executable, "-m", "repro_torch.stencil.sweep", "--worker", sub.to_json(),
                 "--device", dev.type],
                processes=config.processes, timeout=timeout,
            )
            records.extend(json.loads(stdout.strip().splitlines()[-1]))
            continue
        records.extend(sweep_cells(sub, n_devices=n, device=dev))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def is_bench_path(path: str) -> bool:
    """The one definition of the ``BENCH_*.json`` naming rule."""
    base = os.path.basename(path)
    return base.startswith("BENCH_") and base.endswith(".json")


def write_bench_json(
    records: Sequence[dict], path: str, *, config: dict | None = None
) -> None:
    """Serialize records to the repo's ``BENCH_*.json`` interchange format.

    Without ``config`` the file is the bare list of row dicts; with it,
    records are wrapped as ``{"config": ..., "records": [...]}`` so the
    run's parameters (grid, packers, device, versions) travel with the
    measurements.  :func:`read_bench_json` accepts both.
    """
    assert is_bench_path(path), path
    payload: Any = (
        list(records) if config is None
        else {"config": config, "records": list(records)}
    )
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


def read_bench_json(path: str) -> tuple[list[dict], dict | None]:
    """Load a ``BENCH_*.json`` file: (records, config-block-or-None).

    Malformed payloads raise :class:`ValueError` naming the file and the
    shape mismatch — not a bare ``KeyError`` from deep inside a consumer
    (the regression guard's historical failure mode on stale baselines).
    """
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict):
        if "records" not in payload:
            raise ValueError(
                f"{path}: BENCH dict payload has no 'records' key (top-level"
                f" keys: {sorted(payload)}); expected the bare record list "
                f"or the {{'config': ..., 'records': [...]}} wrapper — the "
                f"file is not a BENCH interchange artifact"
            )
        return list(payload["records"]), payload.get("config")
    if not isinstance(payload, list):
        raise ValueError(
            f"{path}: BENCH payload must be a json list or dict, got "
            f"{type(payload).__name__}"
        )
    return list(payload), None


def summarize(records: Sequence[dict]) -> list[str]:
    """csv rows (name,us,derived) matching benchmarks/run.py's emit format.

    The name carries the full cell coordinate including the mapping axis;
    the derived column carries the locality tally
    (``intra=``/``inter=`` node sends) and, for autotuned records, the
    selection provenance — an ``auto:`` tag also prefixes the resolved
    strategy so a tuned cell never collides with the identical static one.
    """
    rows = []
    for r in records:
        tag = "auto:" if r.get("selected_by") else ""
        name = (f"sweep/d{r['n_devices']}/p{r['n_parts']}"
                f"/m{r['message_bytes']}/{r.get('packer', 'slice')}"
                f"/c{int(bool(r.get('coalesce', False)))}"
                f"/{r.get('mapping', 'row-major')}"
                f"/{tag}{r['strategy']}")
        pct = (r["speedup_vs_baseline"] - 1.0) * 100.0
        derived = (f"speedup={pct:.1f}%;init_us={r['init_us']:.0f};"
                   f"replan_us={r.get('replan_us', 0.0):.0f}")
        if "intra_node_sends" in r or "inter_node_sends" in r:
            derived += (f";intra={r.get('intra_node_sends', 0)}"
                        f";inter={r.get('inter_node_sends', 0)}")
        if r.get("selected_by"):
            derived += f";selected_by={r['selected_by']}"
        rows.append(f"{name},{r['us_per_cycle']:.1f},{derived}")
    return rows


def regression_failures(
    baseline_records: Sequence[dict],
    records: Sequence[dict],
    *,
    threshold: float = 0.25,
) -> list[str]:
    """Compare a fresh sweep against a committed baseline sweep.

    Per *strategy* present in BOTH record sets, the best
    ``speedup_vs_baseline`` across all its cells must not fall more than
    ``threshold`` below the committed best.  Speedups (not absolute
    microseconds) are compared, so the guard survives CI machines of
    different speeds; keying by strategy (not per-cell coordinate) keeps
    the max over ~a dozen cells, whose run-to-run noise is far below any
    single tiny cell's — single-cell jitter on the 3-cycle smoke grid
    exceeds 25%, so a finer key would flash red on identical code.  Only
    ``speedup_vs_baseline`` is compared: newer record fields (e.g. the
    ``replan_us`` re-plan latency or ``plan_cache_invalidations``) are
    tolerated in either record set and simply travel along — a baseline
    written before a field existed never trips the guard.  The
    check is only meaningful when both runs swept comparable grids (the
    full-matrix smoke grid, never the restricted ``--packer`` cells).
    Returns human-readable failure lines (empty = pass).

    Autotuned records (``selected_by`` set) are NOT keyed by their resolved
    strategy name — that would let a ``strategy=auto`` sweep satisfy the
    guard by merely resolving to the same names.  They pool under one
    ``auto`` key whose best speedup must clear the committed autotuned best
    when the baseline carries one, else the committed *best static* cell —
    the tuner's whole contract is matching the static oracle, so falling
    ``threshold`` below it is a selection regression even if every static
    path is healthy.

    A record missing the two keys the guard actually reads (``strategy``,
    ``speedup_vs_baseline``) raises :class:`ValueError` naming the record
    and the likely cause (a baseline predating the schema), instead of the
    historical bare ``KeyError``.
    """

    def best(recs: Sequence[dict], which: str) -> tuple[
        dict[str, float], float | None
    ]:
        """(per-strategy best of the STATIC records, best autotuned-or-None)."""
        static: dict[str, float] = {}
        auto: float | None = None
        for i, r in enumerate(recs):
            for key in ("strategy", "speedup_vs_baseline"):
                if key not in r:
                    raise ValueError(
                        f"{which} record {i} is missing {key!r} "
                        f"(schema_version={r.get('schema_version')!r}): the "
                        f"file likely predates the current record schema — "
                        f"regenerate it with `python -m repro_torch.stencil.sweep "
                        f"--smoke --out BENCH_torch_stencil_sweep.json`"
                    )
            if r.get("selected_by"):
                auto = max(r["speedup_vs_baseline"],
                           auto if auto is not None else 0.0)
            else:
                static[r["strategy"]] = max(r["speedup_vs_baseline"],
                                            static.get(r["strategy"], 0.0))
        return static, auto

    old, old_auto = best(baseline_records, "baseline")
    new, new_auto = best(records, "fresh-sweep")
    fails = []
    if new_auto is not None:
        if old_auto is not None:
            ref, ref_label = old_auto, "committed autotuned best"
        elif old:
            ref = max(old.values())
            ref_label = "committed best static cell"
        else:
            raise ValueError(
                "fresh sweep carries autotuned records but the baseline has "
                "no records to floor them against — the baseline predates "
                "the autotune schema; regenerate it with `python -m "
                "repro.stencil.sweep --smoke --out BENCH_torch_stencil_sweep.json`"
            )
        floor = ref * (1.0 - threshold)
        if new_auto < floor:
            fails.append(
                f"auto: best autotuned speedup {new_auto:.3f} fell below "
                f"{floor:.3f} ({ref_label} {ref:.3f}, threshold "
                f"{threshold:.0%})"
            )
    compared_auto = new_auto is not None
    if (old or new) and not set(old) & set(new) and not compared_auto:
        raise ValueError(
            f"no strategy appears in BOTH record sets (baseline strategies "
            f"{sorted(old)}, fresh {sorted(new)}): the sweeps are not "
            f"comparable — a stale baseline or mismatched grids would make "
            f"this guard silently vacuous"
        )
    for strategy in sorted(set(old) & set(new)):
        floor = old[strategy] * (1.0 - threshold)
        if new[strategy] < floor:
            fails.append(
                f"{strategy}: best speedup {new[strategy]:.3f} fell below "
                f"{floor:.3f} (committed {old[strategy]:.3f}, threshold "
                f"{threshold:.0%})"
            )
    return fails


def check_against_baseline(
    records: Sequence[dict], baseline_path: str, *, threshold: float = 0.25
) -> list[str]:
    """CLI helper: load the committed BENCH baseline and diff ``records``."""
    baseline_records, _config = read_bench_json(baseline_path)
    return regression_failures(baseline_records, records,
                               threshold=threshold)


def smoke_config(
    n_devices: int = 4,
    packers: tuple[str, ...] | None = None,
    coalesce_modes: tuple[bool, ...] | None = None,
    mappings: tuple[str, ...] | None = None,
    strategies: tuple[str, ...] | None = None,
) -> SweepConfig:
    """A 1-cell grid over ALL registered strategies x ALL registered packers
    (the lossy ones too) x both coalesce modes x two mappings (row-major
    hosts the baseline, blocked is a permuted mesh) on an ``(n/2, 2)``
    torus; 4 cells a rank along the decomposed axis."""
    return SweepConfig(
        device_counts=(n_devices,), part_counts=(1, 2),
        sizes=((4 * n_devices, 8),),
        strategies=tuple(available_strategies()) if strategies is None else strategies,
        n_cycles=3, repeats=1,
        packers=available_packers() if packers is None else packers,
        coalesce_modes=(False, True) if coalesce_modes is None else coalesce_modes,
        mappings=("row-major", "blocked") if mappings is None else mappings,
        mesh_ndim=2,
    )


def config_block(config: SweepConfig, *, device=None, smoke: bool = False) -> dict:
    """The BENCH config block: the full grid, the device's name and the
    torch and CUDA versions, so a recorded sweep is re-runnable as-is."""
    return {
        "sweep": dataclasses.asdict(config),
        "smoke": smoke,
        "device": device_name(resolve_device(device)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "process_count": config.processes,
        "is_multihost": config.processes > 1,
        # the mesh each rank count ran on (a 2-D request can degrade to a
        # 1-D row, see mesh_shape_for)
        "effective_mesh_shapes": {
            str(n): list(mesh_shape_for(n, config.mesh_ndim)) for n in config.device_counts
        },
    }


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--worker", metavar="CONFIG_JSON",
                    help="(internal) one rank of a --processes grid: run one rank count's "
                         "cells and print the records from rank 0")
    ap.add_argument("--out", default="BENCH_torch_stencil_sweep.json",
                    help="output path (must match BENCH_*.json)")
    ap.add_argument("--device", default="cuda",
                    help="where the ranks live: cuda (the default; raises without a "
                         "card) or cpu")
    ap.add_argument("--fast", action="store_true",
                    help="2-cell grid instead of the full default grid")
    ap.add_argument("--smoke", action="store_true",
                    help="1-cell grid over all registered strategies x packers")
    ap.add_argument("--packer", metavar="NAME",
                    help="restrict the packer axis to ONE registered packer")
    ap.add_argument("--coalesce", choices=("on", "off", "both"), default="both",
                    help="restrict the coalescing axis (default: both modes)")
    ap.add_argument("--mapping", metavar="NAME",
                    help="restrict the mapping axis to ONE registered mapping "
                         "(row-major|blocked|rb), or 'all'")
    ap.add_argument("--strategy", metavar="NAMES",
                    help="comma list of strategies; 'all' = every registered one (the "
                         "default), 'auto' = the autotuned cell.  The static baseline "
                         "is always swept alongside")
    ap.add_argument("--autotune-trace", metavar="BENCH_JSON",
                    help="BENCH sweep the autotuner fits from (sets "
                         "REPRO_TORCH_AUTOTUNE_TRACE)")
    ap.add_argument("--autotune-cache", metavar="PATH",
                    help="autotune calibration-verdict cache (sets "
                         "REPRO_TORCH_AUTOTUNE_CACHE; default "
                         "~/.cache/repro_torch/autotune.json)")
    ap.add_argument("--check", metavar="BENCH_JSON",
                    help="diff the records against this BENCH baseline; exit non-zero "
                         "if any strategy's speedup regressed beyond the threshold")
    ap.add_argument("--check-threshold", type=float, default=0.25,
                    help="allowed fractional speedup regression for --check")
    ap.add_argument("--processes", type=int, default=1,
                    help="boot every rank count as a grid of N processes (each stacking "
                         "n/N ranks; transport multihost; rank 0 gathers the records)")
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="wall-clock limit of each rank count's grid (seconds)")
    args = ap.parse_args(argv)

    if args.worker:
        from repro_torch.launch.stencil import maybe_initialize_from_env

        rank = maybe_initialize_from_env()
        config = SweepConfig.from_json(args.worker)
        records = sweep_cells(config, n_devices=config.device_counts[0], device=args.device)
        if rank == 0:
            print(json.dumps(records))
        return
    if args.processes < 1:
        ap.error(f"--processes must be >= 1, got {args.processes}")
    if not is_bench_path(args.out):
        ap.error(f"--out must be named BENCH_*.json, got {args.out!r}")

    device = resolve_device(args.device)
    if args.packer and args.packer not in available_packers():
        ap.error(f"--packer must be one of {available_packers()}, got {args.packer!r}")
    coalesce_modes = {"on": (True,), "off": (False,), "both": None}[args.coalesce]
    mappings: tuple[str, ...] | None = None
    if args.mapping:
        if args.mapping == "all":
            mappings = available_mappings()
        else:
            try:
                mappings = (canonical_mapping(args.mapping),)
            except KeyError as e:
                ap.error(str(e.args[0]) if e.args else str(e))
    if args.autotune_trace:
        os.environ["REPRO_TORCH_AUTOTUNE_TRACE"] = args.autotune_trace
    if args.autotune_cache:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = args.autotune_cache
    strategies: tuple[str, ...] | None = None
    if args.strategy and args.strategy != "all":
        names = tuple(s.strip() for s in args.strategy.split(",") if s.strip())
        for s in names:
            if s != "auto" and s not in available_strategies():
                ap.error(f"--strategy must name registered strategies "
                         f"{available_strategies()} or 'auto', got {s!r}")
        # the static baseline always rides along: every speedup's denominator
        baseline = SweepConfig.__dataclass_fields__["baseline"].default
        strategies = tuple(dict.fromkeys((baseline,) + names))

    grid = (dict(processes=args.processes, transport="multihost") if args.processes > 1
            else {})
    if args.smoke:
        # 2 ranks a process on a grid (4 in one process)
        n = 2 * args.processes if args.processes > 1 else 4
        config = dataclasses.replace(
            smoke_config(n, packers=(args.packer,) if args.packer else None,
                         coalesce_modes=coalesce_modes, mappings=mappings,
                         strategies=strategies), **grid)
        records = (run_sweep(config, device=device, timeout=args.timeout) if grid
                   else sweep_cells(config, n_devices=n, device=device))
    else:
        config = SweepConfig()
        if args.fast:
            config = dataclasses.replace(config, device_counts=(2, 4), part_counts=(1, 2),
                                         sizes=((32, 16),))
        if args.packer:
            config = dataclasses.replace(config, packers=(args.packer,))
        if coalesce_modes is not None:
            config = dataclasses.replace(config, coalesce_modes=coalesce_modes)
        if mappings is not None:
            config = dataclasses.replace(config, mappings=mappings)
        if strategies is not None:
            config = dataclasses.replace(config, strategies=strategies)
        config = dataclasses.replace(config, **grid)
        records = run_sweep(config, device=device, timeout=args.timeout)
    write_bench_json(records, args.out,
                     config=config_block(config, device=device, smoke=args.smoke))
    for row in summarize(records):
        print(row)
    print(f"# {len(records)} records -> {args.out}")
    if args.check:
        fails = check_against_baseline(records, args.check, threshold=args.check_threshold)
        if fails:
            for line in fails:
                print(f"REGRESSION: {line}", file=sys.stderr)
            raise SystemExit(1)
        print(f"# regression check vs {args.check}: ok")


if __name__ == "__main__":
    main()
