"""Comb-style benchmark driver: barriered, multi-cycle halo-exchange timing
(PyTorch port of ``src/repro/stencil/comb.py``).

The paper's protocol (§V): synchronize before timing, run many exchange
cycles, take the mean per-cycle cost, repeat and average.  The barrier is
``torch.cuda.synchronize()`` on the card, and the clock is the host's
around work that ends in that barrier.  Every record names its device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.compat import synchronize
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

    def record(self) -> dict:
        return dataclasses.asdict(self)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_cycles(
    driver: ExchangeStrategy,
    x: torch.Tensor,
    *,
    n_cycles: int = 50,
    warmup: int = 3,
    repeats: int = 3,
) -> CycleResult:
    """Time ``n_cycles`` exchange(+update) iterations, paper-style.
    ``init_us`` (tables, uploads, buffers) is charged only to strategies
    declaring ``amortizes_init``."""
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
        t0 = time.perf_counter()
        for _ in range(n_cycles):
            x = driver.step(x)
        driver.wait(x)  # Waitall before stopping the clock
        times.append((time.perf_counter() - t0) / n_cycles * 1e6)
    checksum = float(x.mean(dtype=torch.float64))
    return CycleResult(
        strategy=driver.strategy, us_per_cycle=float(np.mean(times)),
        init_us=init_us, n_cycles=n_cycles, repeats=repeats, checksum=checksum,
        n_parts=driver.n_parts, packer=driver.config.packer,
        transport=driver.config.transport, coalesce=driver.config.coalesce,
        mapping=driver.config.mapping, collective_count=collective_count,
        plan_cache_inits=plan_inits, plan_cache_hits=plan_hits,
        replan_us=replan_us, plan_cache_invalidations=plan_invals,
        device=device_name(dev),
    )


def device_breakdown(driver: ExchangeStrategy, x: torch.Tensor, *, n_cycles: int = 3) -> dict:
    """Where one steady cycle's time goes on the card, from ``torch.profiler``.

    Runs one warm-up cycle, then traces ``n_cycles``.  Returns per-cycle
    device time by kernel name (with launches per cycle), the traced
    window, the device-busy time (union of kernel, memcpy and memset
    intervals) and the idle share of the window.  CUDA only: raises when
    the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    x = driver.wait(driver.step(x))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_cycles):
            x = driver.step(x)
        driver.wait(x)
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    by_name: dict[str, list[float]] = {}
    for e in device:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    kernels = sorted(((name, us / n_cycles, n / n_cycles) for name, (us, n) in by_name.items()),
                     key=lambda row: -row[1])
    return {
        "cycles": n_cycles, "window_us_per_cycle": window / n_cycles,
        "busy_us_per_cycle": busy / n_cycles, "idle_share": 1.0 - busy / window,
        "kernels": [{"name": n, "us_per_cycle": us, "launches_per_cycle": c}
                    for n, us, c in kernels],
    }


def _as_config(strategy: str | StrategyConfig, default_n_parts: int) -> StrategyConfig:
    if isinstance(strategy, StrategyConfig):
        return strategy
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
    tolerance.  Keys follow :func:`result_label` (``#pN``/``#2`` suffixes
    for repeats, as in the JAX package)."""
    results: dict[str, CycleResult] = {}
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
        x = domain.random(seed)
        driver = make_driver(config, domain.mesh, domain.halo_spec,
                             ndim=len(domain.global_interior), update_fn=update_fn)
        try:
            results[label] = run_cycles(driver, x, n_cycles=n_cycles, repeats=repeats)
        finally:
            driver.free()
        del x

    def wire_tol(res: CycleResult) -> tuple[float, float]:
        return get_packer(res.packer).wire_tolerance(domain.dtype)

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
