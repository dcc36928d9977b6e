"""Tiered tenants for the concurrent query scheduler.

A TenantSpec names one workload class sharing a Session's engine pool
and declares how the scheduler treats its queries: `weight` sets the
weighted-fair admission share (a tenant's virtual time advances at
tuples/weight, so a heavy tenant with twice the weight gets twice the
throughput before a light tenant's queries jump the queue), `tier`
selects the cache policy — premium tenants keep their profile ladders
device-resident (the engine's device LRU is pre-warmed on their first
query per corpus and never evicted by the scheduler), standard tenants
share the LRU opportunistically, and cold tenants build lazily and have
their rungs evicted from the device LRU when each query finishes, so a
rarely-seen workload cannot squat on HBM a premium tenant paid for.

Declared on SessionConfig(tenants=...) or passed straight to
QueryScheduler(tenants=...); queries are submitted under a tenant name
(default: the implicit "default" standard tenant).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# tier -> (default fair-share weight, default keep_warm)
TIERS = {
    "premium": (4.0, True),
    "standard": (1.0, False),
    "cold": (0.25, False),
}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant sharing a scheduled Session.

      name      — unique tenant name queries are submitted under
      tier      — "premium" | "standard" | "cold" (cache policy + the
                  default weight)
      weight    — weighted-fair admission share (None: the tier default;
                  premium 4.0, standard 1.0, cold 0.25). Charged in
                  tuples/weight of virtual time per coalesced flush.
      keep_warm — pre-stage this tenant's profile ladder in the engines'
                  device-resident LRU on its first query per corpus
                  (None: the tier default; True only for premium).
                  A no-op on engines with the device cache off.
    """
    name: str
    tier: str = "standard"
    weight: Optional[float] = None
    keep_warm: Optional[bool] = None

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError("TenantSpec.name must be a non-empty string")
        if self.tier not in TIERS:
            raise ValueError(
                f"tenant {self.name!r}: tier {self.tier!r} is not one of "
                f"{sorted(TIERS)}")
        if self.weight is not None and self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be "
                             f"positive, got {self.weight}")

    @property
    def fair_weight(self) -> float:
        """The effective fair-share weight (tier default unless set)."""
        return float(self.weight) if self.weight is not None \
            else TIERS[self.tier][0]

    @property
    def warms(self) -> bool:
        """Whether this tenant's first query per corpus pre-warms the
        device LRU (tier default unless keep_warm set)."""
        return bool(self.keep_warm) if self.keep_warm is not None \
            else TIERS[self.tier][1]

    @property
    def evicts(self) -> bool:
        """Cold tenants release their device-LRU rungs after each
        query."""
        return self.tier == "cold"


def validate_tenants(tenants) -> Tuple[TenantSpec, ...]:
    """Normalize + validate a tenants declaration (tuple of TenantSpec,
    unique names)."""
    specs = tuple(tenants)
    for t in specs:
        if not isinstance(t, TenantSpec):
            raise TypeError(f"tenants must be TenantSpec instances, "
                            f"got {type(t)!r}")
    names = [t.name for t in specs]
    dups = sorted({n for n in names if names.count(n) > 1})
    if dups:
        raise ValueError(f"duplicate tenant name(s): {dups}")
    return specs
