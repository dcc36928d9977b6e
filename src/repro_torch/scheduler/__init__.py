"""Concurrent query scheduler of the port: admit many SemFrame queries
onto one Session/engine pool with cross-query flush coalescing and tiered
tenants. See scheduler.py (admission + fairness + tiers), hub.py
(coalescing seam), tenants.py (TenantSpec tiers). The port of
`repro.scheduler`: framework-free code, copied, with the port's runtime
underneath.

Lazy exports (PEP 562): repro_torch.api.session imports tenants from here
for SessionConfig validation; importing scheduler.py eagerly would close
an import cycle back through repro_torch.api.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "QueryScheduler": "repro_torch.scheduler.scheduler",
    "QueryHandle": "repro_torch.scheduler.scheduler",
    "QueryTelemetry": "repro_torch.scheduler.scheduler",
    "SchedulerSaturated": "repro_torch.scheduler.scheduler",
    "FlushHub": "repro_torch.scheduler.hub",
    "QueryDispatcher": "repro_torch.scheduler.hub",
    "split_ints": "repro_torch.scheduler.hub",
    "TenantSpec": "repro_torch.scheduler.tenants",
    "TIERS": "repro_torch.scheduler.tenants",
    "validate_tenants": "repro_torch.scheduler.tenants",
}

__all__ = sorted(_EXPORTS)

if TYPE_CHECKING:    # static importers see the real names
    from repro_torch.scheduler.hub import (FlushHub, QueryDispatcher,  # noqa
                                     split_ints)
    from repro_torch.scheduler.scheduler import (QueryHandle,  # noqa
                                           QueryScheduler,
                                           QueryTelemetry,
                                           SchedulerSaturated)
    from repro_torch.scheduler.tenants import (TIERS, TenantSpec,  # noqa
                                         validate_tenants)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return __all__
