from repro_torch.stencil.domain import (
    Domain,
    periodic_oracle_step,
    reference_exchange,
    stacked_from_stored,
    stored_from_stacked,
)
from repro_torch.stencil.exchange import ExchangeDriver
from repro_torch.stencil.strategies import (
    ExchangeStrategy,
    StrategyConfig,
    available_strategies,
    get_strategy,
    make_driver,
    register_strategy,
)
from repro_torch.stencil.comb import (
    CycleResult,
    comb_measure,
    result_label,
    run_cycles,
    speedup_vs_baseline,
)

_SWEEP_EXPORTS = ("SweepConfig", "run_sweep", "sweep_cells",
                  "write_bench_json", "read_bench_json")


def __getattr__(name):
    # lazy, so `python -m repro_torch.stencil.sweep` does not find the
    # module already imported by the package body
    if name in _SWEEP_EXPORTS:
        from repro_torch.stencil import sweep

        return getattr(sweep, name)
    raise AttributeError(name)


__all__ = [
    "Domain", "periodic_oracle_step", "reference_exchange",
    "stacked_from_stored", "stored_from_stacked", "ExchangeDriver",
    "ExchangeStrategy", "StrategyConfig", "available_strategies",
    "get_strategy", "make_driver", "register_strategy",
    "CycleResult", "comb_measure", "result_label", "run_cycles",
    "speedup_vs_baseline",
    "SweepConfig", "run_sweep", "sweep_cells", "write_bench_json",
    "read_bench_json",
]
