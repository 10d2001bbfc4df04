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

__all__ = [
    "Domain", "periodic_oracle_step", "reference_exchange",
    "stacked_from_stored", "stored_from_stacked", "ExchangeDriver",
    "ExchangeStrategy", "StrategyConfig", "available_strategies",
    "get_strategy", "make_driver", "register_strategy",
    "CycleResult", "comb_measure", "result_label", "run_cycles",
    "speedup_vs_baseline",
]
