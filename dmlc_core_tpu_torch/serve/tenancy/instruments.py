"""Shared metric handles for the multi-tenant serving tier.

Same pattern as ``serve.instruments`` / ``fleet.instruments``: every
tenancy layer (router admission, replica pager, tenant rollouts) records
into the process-wide registry so the spool-merge (base/metrics_agg)
folds router-side and replica-side tenant series into ONE snapshot the
SLO scorecard can gate per-tenant p99 on (scripts/slo/tenancy.json).

The rows that matter operationally (see ``doc/observability.md``):
``tenant_shed_total`` says admission control fired and for WHOM (the
``reason`` label separates a per-tenant quota breach from class-based
bronze shedding); ``tenant_evictions_total`` / ``tenant_restore_seconds``
say the replica residency cap is churning (raise the cap or add
replicas); ``tenant_hedge_total`` says gold-tenant tail latency is being
bought with duplicate work.

The PyTorch port's counterpart of ``dmlc_core_tpu/serve/tenancy/instruments.py``: the same
names, env ABI and metric names.
"""

from __future__ import annotations

from typing import Dict

from dmlc_core_tpu_torch.base import metrics as _metrics

__all__ = ["tenant_metrics"]

_M: Dict[str, object] = {}


def tenant_metrics() -> Dict[str, object]:
    """Lazily declared instrument handles (get-or-create, shared by all
    tenancy layers — one dict lookup per event on the hot path)."""
    if not _M:
        r = _metrics.default_registry()
        _M.update({
            # -- router admission + outcome -------------------------------
            "requests": r.counter(
                "tenant_requests_total",
                "tenant-tagged predicts answered at the router, by "
                "tenant and final HTTP code", labels=("tenant", "code")),
            "e2e": r.histogram(
                "tenant_request_seconds",
                "router-side end-to-end latency of tenant-tagged "
                "predicts — the series the SLO scorecard gates "
                "per-tenant p99 on", labels=("tenant",)),
            "shed": r.counter(
                "tenant_shed_total",
                "tenant predicts refused by router admission control, "
                "by tenant and reason (quota|class|inflight)",
                labels=("tenant", "reason")),
            "hedge": r.counter(
                "tenant_hedge_total",
                "gold-tenant hedge events, by outcome "
                "(launched|won|lost)", labels=("outcome",)),
            # -- replica pager --------------------------------------------
            "evictions": r.counter(
                "tenant_evictions_total",
                "resident tenant models paged out by the replica "
                "residency cap, by tenant", labels=("tenant",)),
            "restore": r.histogram(
                "tenant_restore_seconds",
                "wall time to page a tenant model back in (rebuild from "
                "retained bytes + the bucket ladder's warmup)",
                labels=("tenant",)),
            "resident": r.gauge(
                "tenant_resident_models",
                "tenant models currently warm (runner resident) on this "
                "replica"),
            "published": r.counter(
                "tenant_publish_total",
                "tenant model versions published or staged, by tenant",
                labels=("tenant",)),
            # -- tenant rollouts ------------------------------------------
            "rollbacks": r.counter(
                "tenant_rollbacks_total",
                "tenant-scoped staged rollouts that rolled back (the "
                "poisoned-publish path), by tenant", labels=("tenant",)),
        })
    return _M
