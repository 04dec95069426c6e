"""Tenant SLO classes and admission thresholds.

Pure configuration — no I/O, no locks.  The router consults one
:class:`TenantPolicy` per instance; thresholds resolve from the
``DMLC_TENANT_*`` knobs at construction so a drill can build two routers
with different admission envelopes side by side (check_tenancy.py's
surge phase does exactly that).

Class semantics (doc/serving.md, "Multi-tenant serving"):

* ``gold``    — never class-shed; eligible for cross-replica hedging
                when ``DMLC_TENANT_HEDGE_MS`` > 0.
* ``silver``  — default; sheds only at the router-wide in-flight cap.
* ``bronze``  — sheds FIRST: 429 once router in-flight exceeds
                ``shed_fraction * max_inflight``, before gold or silver
                see any queueing.

Orthogonally, ``DMLC_TENANT_QUOTA`` caps any single tenant's concurrent
in-flight predicts (429, reason ``quota``) so one hot tenant cannot
monopolize the fleet regardless of class.

The PyTorch port's counterpart of ``dmlc_core_tpu/serve/tenancy/policy.py``: the same
names, env ABI and metric names.
"""

from __future__ import annotations

from typing import Dict, Optional

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.base.parameter import get_env

__all__ = ["TenantPolicy", "CLASSES"]

#: recognized SLO classes, best first
CLASSES = ("gold", "silver", "bronze")


def _parse_classes(spec: str) -> Dict[str, str]:
    """``'gold:a,b;bronze:c'`` -> ``{'a': 'gold', 'b': 'gold', 'c':
    'bronze'}`` (whitespace tolerated, empty groups ignored)."""
    out: Dict[str, str] = {}
    for group in spec.split(";"):
        group = group.strip()
        if not group:
            continue
        CHECK(":" in group,
              f"DMLC_TENANT_CLASSES group {group!r} is not class:t1,t2")
        cls, _, names = group.partition(":")
        cls = cls.strip().lower()
        CHECK(cls in CLASSES,
              f"DMLC_TENANT_CLASSES: unknown class {cls!r} "
              f"(want one of {'|'.join(CLASSES)})")
        for name in names.split(","):
            name = name.strip()
            if name:
                out[name] = cls
    return out


class TenantPolicy:
    """Immutable admission policy resolved from knobs (overridable per
    argument for tests and drills)."""

    def __init__(self, classes: Optional[str] = None,
                 default_class: Optional[str] = None,
                 quota: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 shed_fraction: Optional[float] = None,
                 hedge_ms: Optional[int] = None):
        spec = (get_env("DMLC_TENANT_CLASSES", "", str)
                if classes is None else classes)
        self._class_of = _parse_classes(spec)
        self.default_class = (
            get_env("DMLC_TENANT_DEFAULT_CLASS", "silver", str)
            if default_class is None else default_class).lower()
        CHECK(self.default_class in CLASSES,
              f"DMLC_TENANT_DEFAULT_CLASS: unknown class "
              f"{self.default_class!r}")
        self.quota = (get_env("DMLC_TENANT_QUOTA", 0, int)
                      if quota is None else quota)
        self.max_inflight = (get_env("DMLC_TENANT_MAX_INFLIGHT", 64, int)
                             if max_inflight is None else max_inflight)
        frac = (get_env("DMLC_TENANT_SHED_FRACTION", 0.5, float)
                if shed_fraction is None else shed_fraction)
        CHECK(0.0 < frac <= 1.0,
              f"DMLC_TENANT_SHED_FRACTION must be in (0, 1], got {frac}")
        self.shed_fraction = frac
        self.hedge_ms = (get_env("DMLC_TENANT_HEDGE_MS", 0, int)
                         if hedge_ms is None else hedge_ms)

    def class_of(self, tenant: str) -> str:
        """SLO class for ``tenant`` (default class when unlisted)."""
        return self._class_of.get(tenant, self.default_class)

    def shed_threshold(self, tenant: str) -> int:
        """Router-wide in-flight count at which ``tenant`` starts
        shedding: ``shed_fraction * max_inflight`` for bronze, the full
        cap for everyone else."""
        if self.class_of(tenant) == "bronze":
            return max(1, int(self.max_inflight * self.shed_fraction))
        return self.max_inflight

    def hedges(self, tenant: str) -> bool:
        """Whether ``tenant`` predicts are hedged across replicas."""
        return self.hedge_ms > 0 and self.class_of(tenant) == "gold"
