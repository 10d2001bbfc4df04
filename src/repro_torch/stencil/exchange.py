"""Back-compat facade over the exchange-strategy registry (PyTorch port of
``src/repro/stencil/exchange.py``).

``ExchangeDriver(mesh, spec_builder, ndim, strategy=...)`` builds the
registered driver for ``strategy`` via :func:`~repro_torch.stencil.
strategies.make_driver`.  New code should call ``make_driver`` directly.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core.halo import HaloSpec
from repro_torch.core.mesh import VirtualMesh
from repro_torch.core.plan import PlanCache
from repro_torch.stencil.strategies import (
    ExchangeStrategy,
    StrategyConfig,
    UpdateFn,
    make_driver,
)


def ExchangeDriver(
    mesh: VirtualMesh,
    spec_builder: Callable[[], HaloSpec],
    ndim: int,
    *,
    strategy: str | None = None,
    update_fn: UpdateFn | None = None,
    plan_cache: PlanCache | None = None,
) -> ExchangeStrategy:
    """One halo-exchange (+ optional local update) driver: ``strategy`` by
    name, else the spec builder's ``strategy``; partition count, packer,
    transport and coalescing are lifted from the built spec."""
    spec = spec_builder()
    config = StrategyConfig(
        name=strategy or spec.strategy,
        n_parts=max(1, spec.n_parts),
        packer=spec.packer,
        transport=spec.transport,
        coalesce=spec.coalesce,
        plan_cache=plan_cache if plan_cache is not None else "private",
    )
    return make_driver(config, mesh, spec_builder, ndim, update_fn=update_fn)
