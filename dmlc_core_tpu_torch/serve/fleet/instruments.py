"""Shared metric handles for the fleet tier.

Same pattern as ``serve.instruments``: every fleet layer (router,
rollout, autoscale, tracker) records into the process-wide registry
(``base.metrics.default_registry``) so one ``/metrics`` scrape — the
router's — shows routing decisions, failovers, sheds, rollout progress
and autoscale recommendations next to the ordinary serve instruments.

The rows that matter operationally (see ``doc/observability.md``):
``fleet_failover_total`` says replicas are failing (reason label:
``transport`` vs ``shed`` vs ``open``); ``fleet_shed_total`` says the
FLEET is saturated (router admission control fired — add replicas);
``fleet_autoscale_recommendation`` is the policy's current verdict
(-1 / 0 / +1) before any backend acts on it.

The PyTorch port's counterpart of ``dmlc_core_tpu/serve/fleet/instruments.py``:
the same names, env ABI and metric names.
"""

from __future__ import annotations

from typing import Dict

from dmlc_core_tpu_torch.base import metrics as _metrics

__all__ = ["fleet_metrics"]

_M: Dict[str, object] = {}


def fleet_metrics() -> Dict[str, object]:
    """Lazily declared instrument handles (get-or-create, shared by all
    fleet layers — one dict lookup per event on the hot path)."""
    if not _M:
        r = _metrics.default_registry()
        _M.update({
            # -- router --------------------------------------------------
            "routed": r.counter(
                "fleet_routed_total",
                "predicts routed, by replica rank that answered",
                labels=("replica",)),
            "failover": r.counter(
                "fleet_failover_total",
                "per-replica routing failures that moved a predict to "
                "the next ring candidate, by reason "
                "(transport|shed|open|unhealthy)", labels=("reason",)),
            "shed": r.counter(
                "fleet_shed_total",
                "predicts the router refused fleet-wide, by reason "
                "(queue|no_replicas)", labels=("reason",)),
            "healthy": r.gauge(
                "fleet_healthy_replicas",
                "replicas the router currently considers routable"),
            "queue_depth": r.gauge(
                "fleet_queue_depth",
                "fleet-wide queued requests (sum of healthy replicas' "
                "last-probed queue depth)"),
            "router_e2e": r.histogram(
                "fleet_request_seconds",
                "router-side end-to-end request latency", labels=("path",)),
            # -- tracker -------------------------------------------------
            "replicas": r.gauge(
                "fleet_replicas",
                "replicas currently registered with the fleet tracker"),
            # -- rollout -------------------------------------------------
            "rollout_waves": r.counter(
                "fleet_rollout_waves_total",
                "staged-rollout waves finished, by outcome "
                "(activated|rolled_back)", labels=("outcome",)),
            "rollout_target": r.gauge(
                "fleet_rollout_target_version",
                "version the in-progress (or last) staged rollout is "
                "driving the fleet toward"),
            # -- autoscale -----------------------------------------------
            "autoscale_rec": r.gauge(
                "fleet_autoscale_recommendation",
                "current autoscale policy verdict: -1 scale-in, 0 hold, "
                "+1 scale-out"),
            "autoscale_events": r.counter(
                "fleet_autoscale_events_total",
                "autoscale actions a backend executed, by direction "
                "(out|in)", labels=("direction",)),
        })
    return _M
