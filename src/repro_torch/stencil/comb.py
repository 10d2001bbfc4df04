"""Comb-style benchmark driver: barriered, multi-cycle halo-exchange timing
(PyTorch port of ``src/repro/stencil/comb.py``).

The paper's protocol (§V): synchronize before timing, run many exchange
cycles, take the mean per-cycle cost, repeat and average.  The barrier is
``torch.cuda.synchronize()`` on the card, and the clock is the host's
around work that ends in that barrier.  On a mesh that spans processes,
every process also meets at ``torch.distributed.barrier()`` before each
timed window (Comb's ``MPI_Barrier``), and the checksum and the bitwise
holds are decided over all processes.  Every record names its device and
its process count.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import profiling
from repro_torch.core.autotune import AUTO
from repro_torch.core.compat import device_name, synchronize
from repro_torch.core.transport import get_packer
from repro_torch.stencil.domain import Domain
from repro_torch.stencil.strategies import (
    ExchangeStrategy,
    StrategyConfig,
    UpdateFn,
    make_driver,
)


@dataclasses.dataclass
class CycleResult:
    """One measured cell; the JAX record's fields plus ``device``."""

    strategy: str
    us_per_cycle: float
    init_us: float
    n_cycles: int
    repeats: int
    checksum: float
    n_parts: int = 1
    packer: str = "slice"
    transport: str = "loopback"
    coalesce: bool = True
    mapping: str = "row-major"
    #: rank gathers ONE step launches (one per coalesced neighbor chain)
    collective_count: int | None = None
    plan_cache_inits: int = 0
    plan_cache_hits: int = 0
    #: time to re-derive the static Message/WireLayout tables
    replan_us: float = 0.0
    plan_cache_invalidations: int = 0
    selected_by: str | None = None
    predicted_us: float | None = None
    calibration_us: float = 0.0
    recovery_mode: str = "none"
    join_us: float = 0.0
    warm_ranks: int = 0
    #: where the cycles ran: the card's name, or "cpu"
    device: str = ""
    #: processes the mesh spans
    process_count: int = 1

    def record(self) -> dict:
        return dataclasses.asdict(self)


def _all_processes(mesh, ok: bool) -> bool:
    """``ok`` held in every process of the mesh's grid (a collective there),
    so that every process takes the same branch."""
    if mesh.processes == 1:
        return ok
    import torch.distributed as dist

    t = torch.tensor([int(ok)])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t)


def checksum(x: torch.Tensor, mesh) -> float:
    """The float64 sum of the stacked block over its element count, summed
    over every process of a grid first (a collective there), so that a
    grid's checksum is its one-process cell's."""
    total = x.sum(dtype=torch.float64).cpu().reshape(1)
    if mesh.processes > 1:
        import torch.distributed as dist

        dist.all_reduce(total)
    return float(total) / (x.numel() * mesh.processes)


def run_cycles(
    driver: ExchangeStrategy,
    x: torch.Tensor,
    *,
    n_cycles: int = 50,
    warmup: int = 3,
    repeats: int = 3,
    return_final: bool = False,
) -> CycleResult | tuple[CycleResult, torch.Tensor]:
    """Time ``n_cycles`` exchange(+update) iterations, paper-style.
    ``init_us`` (tables, uploads, buffers, and on the card the plan's
    warm-up and CUDA-graph capture) is charged only to strategies
    declaring ``amortizes_init``.  With ``return_final`` the last block
    comes back beside the result (valid until the driver is freed)."""
    dev = driver.mesh.device
    cache = driver.config.resolve_cache()
    hits0, inits0, invals0 = (
        (cache.stats.cache_hits, cache.stats.inits, cache.stats.invalidations)
        if cache else (0, 0, 0)
    )
    synchronize(dev)
    t0 = time.perf_counter()
    driver.init(x)
    synchronize(dev)
    init_us = (time.perf_counter() - t0) * 1e6 if driver.amortizes_init else 0.0
    if cache is not None:
        plan_hits = cache.stats.cache_hits - hits0
        plan_inits = cache.stats.inits - inits0
        plan_invals = cache.stats.invalidations - invals0
    else:
        plan_hits, plan_inits, plan_invals = 0, int(driver.amortizes_init), 0
    collective_count = driver.scheduled_collectives(x)
    t0 = time.perf_counter()
    driver.replan_tables(x)
    replan_us = (time.perf_counter() - t0) * 1e6

    for _ in range(warmup):
        x = driver.step(x)
    driver.wait(x)

    times = []
    for _ in range(repeats):
        driver.wait(x)  # the paper's pre-timing barrier
        if driver.mesh.processes > 1:
            import torch.distributed as dist

            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n_cycles):
            x = driver.step(x)
        driver.wait(x)  # Waitall before stopping the clock
        times.append((time.perf_counter() - t0) / n_cycles * 1e6)
    result = CycleResult(
        strategy=driver.strategy, us_per_cycle=float(np.mean(times)),
        init_us=init_us, n_cycles=n_cycles, repeats=repeats,
        # sum then one division, the same on the card and on the CPU (a
        # float64 sum of a small f32 block is exact in any order)
        checksum=checksum(x, driver.mesh),
        n_parts=driver.n_parts, packer=driver.config.packer,
        transport=driver.config.transport, coalesce=driver.config.coalesce,
        mapping=driver.config.mapping, collective_count=collective_count,
        plan_cache_inits=plan_inits, plan_cache_hits=plan_hits,
        replan_us=replan_us, plan_cache_invalidations=plan_invals,
        # autotuned drivers carry their selection provenance; pinned ones
        # have none (only AutoStrategy defines these)
        selected_by=getattr(driver, "selected_by", None),
        predicted_us=getattr(driver, "predicted_us", None),
        calibration_us=getattr(driver, "calibration_us", 0.0),
        device=device_name(dev), process_count=driver.mesh.processes,
    )
    return (result, x) if return_final else result


def device_breakdown(driver: ExchangeStrategy, x: torch.Tensor, *, n_cycles: int = 3) -> dict:
    """Where one steady cycle's time goes on the card: one warm-up cycle,
    then ``n_cycles`` traced (see :func:`repro_torch.core.profiling.
    device_breakdown`).  CUDA only: raises when the trace holds no device
    activity."""
    state = [x]

    def cycle() -> None:
        state[0] = driver.step(state[0])

    return profiling.device_breakdown(cycle, n_cycles=n_cycles)


def _as_config(strategy: str | StrategyConfig, default_n_parts: int) -> StrategyConfig:
    if isinstance(strategy, StrategyConfig):
        return strategy
    if strategy == AUTO:
        # the bare name opens every autotunable axis
        return StrategyConfig(name=AUTO, packer=AUTO, coalesce=AUTO)
    return StrategyConfig(name=strategy,
                          n_parts=default_n_parts if strategy == "partitioned" else 1)


def result_label(name: str, packer: str = "slice", coalesce: bool = True) -> str:
    """``comb_measure``'s result key: the strategy name, ``@packer`` for
    non-default packers, ``~uncoalesced`` for the coalesce-off cells."""
    label = name if packer == "slice" else f"{name}@{packer}"
    return label if coalesce else f"{label}~uncoalesced"


def comb_measure(
    domain: Domain,
    *,
    strategies: tuple[str | StrategyConfig, ...] = ("standard", "persistent", "partitioned"),
    n_parts: int = 4,
    update_fn: UpdateFn | None = None,
    n_cycles: int = 50,
    repeats: int = 3,
    seed: int = 0,
) -> dict[str, CycleResult]:
    """Measure every strategy on one domain (on the domain's device) from
    the same seeded state; checksums must agree within the packers' wire
    tolerance, and every exact-packer cell's last block must equal the first
    exact-packer cell's bitwise (the JAX package checks checksums only; on
    a grid each process holds its own rows, and a difference in any
    process fails them all).
    Keys follow :func:`result_label` (``#pN``/``#2`` suffixes for repeats,
    as in the JAX package).  The seeded state is drawn once and each
    strategy steps its own copy."""

    def wire_tol(res: CycleResult) -> tuple[float, float]:
        return get_packer(res.packer).wire_tolerance(domain.dtype)

    results: dict[str, CycleResult] = {}
    exact_ref: tuple[str, torch.Tensor] | None = None
    x0 = domain.random(seed)
    for strategy in strategies:
        config = _as_config(strategy, n_parts)
        label = result_label(config.name, config.packer, config.coalesce)
        if label in results:
            label = f"{label}#p{config.n_parts}"
        if label in results:
            base, n = label, 2
            while label in results:
                label = f"{base}#{n}"
                n += 1
        x = x0.clone()
        driver = make_driver(config, domain.mesh, domain.halo_spec,
                             ndim=len(domain.global_interior), update_fn=update_fn)
        try:
            res, final = run_cycles(driver, x, n_cycles=n_cycles, repeats=repeats,
                                    return_final=True)
            if wire_tol(res) == (0.0, 0.0):
                if exact_ref is None:
                    exact_ref = (label, final.clone())
                elif not _all_processes(domain.mesh, torch.equal(final, exact_ref[1])):
                    raise AssertionError(f"strategy {label}'s block differs from "
                                         f"{exact_ref[0]}'s (exact packers move data bitwise)")
            results[label] = res
            del final
        finally:
            driver.free()
        del x
    del x0, exact_ref

    sums = {s: r.checksum for s, r in results.items()}
    ref_label, ref_res = next(iter(results.items()))
    ref_rtol, ref_atol = wire_tol(ref_res)
    for s, r in results.items():
        wr, wa = wire_tol(r)
        rtol, atol = max(1e-3, ref_rtol, wr), max(1e-3, ref_atol, wa)
        if not abs(r.checksum - ref_res.checksum) < atol + rtol * abs(ref_res.checksum):
            raise AssertionError(f"strategy {s} diverged from {ref_label}: {sums}")
    return results


def speedup_vs_baseline(results: dict[str, CycleResult], baseline: str = "standard") -> dict[str, float]:
    base = results[baseline].us_per_cycle
    return {s: base / r.us_per_cycle for s, r in results.items()}
