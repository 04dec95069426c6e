"""Shared metric handles for the launch tier.

Same pattern as ``serve.fleet.instruments``: every launch layer
(transports, the JobSet supervisor, the backend glue) records into the
process-wide registry (``base.metrics.default_registry``) so one scrape
shows spawn latency, respawn churn and supervised-worker counts next to
the tracker and fleet instruments.

The rows that matter operationally (see ``doc/observability.md``):
``launch_respawns_total`` says workers are dying and being brought back
(a rising rate is a failing host or a crash-looping command);
``launch_workers`` is the supervised head-count per JobSet;
``launch_spawn_seconds`` p95 is the cold-start tax each respawn pays.

The PyTorch port's counterpart of ``dmlc_core_tpu/launch/instruments.py``: the same
names, env ABI and metric names.
"""

from __future__ import annotations

from typing import Dict

from dmlc_core_tpu_torch.base import metrics as _metrics

__all__ = ["launch_metrics"]

_M: Dict[str, object] = {}


def launch_metrics() -> Dict[str, object]:
    """Lazily declared instrument handles (get-or-create, shared by all
    launch layers — one dict lookup per event on the hot path)."""
    if not _M:
        r = _metrics.default_registry()
        _M.update({
            "spawn": r.histogram(
                "launch_spawn_seconds",
                "time to spawn one worker process, by transport",
                labels=("transport",)),
            "respawns": r.counter(
                "launch_respawns_total",
                "workers restarted by a JobSet supervisor after an "
                "unexpected exit", labels=("jobset",)),
            "workers": r.gauge(
                "launch_workers",
                "worker processes a JobSet currently supervises",
                labels=("jobset",)),
            "events": r.counter(
                "launch_events_total",
                "JobSet lifecycle events, by kind (spawn|exit|respawn|"
                "spawn_error|giveup|wedged|stop|teardown)",
                labels=("event",)),
        })
    return _M
