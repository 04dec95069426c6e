"""Shared metric handles for the serving subsystem.

Every layer of ``dmlc_core_tpu_torch.serve`` records into the SAME process-wide
registry (``base.metrics.default_registry``) that training and io already
use, so one ``/metrics`` scrape shows the whole picture: queue depth and
queue-wait (batcher), batch-size and execute-time (runner), request
counters per path/code and per model version (frontend).

The split that matters operationally (see ``doc/serving.md``):
``serve_queue_wait_seconds`` is time a request sat WAITING for a batch
slot — tune ``max_delay``/``max_batch`` when it dominates;
``serve_execute_seconds`` is time the model spent computing a batch —
tune the model (fewer trees, smaller buckets) when THAT dominates.

This package's own copy of ``dmlc_core_tpu.serve.instruments``, over
the port's ``base/metrics.py``: the same metric names and labels.
"""

from __future__ import annotations

from typing import Dict

from dmlc_core_tpu_torch.base import metrics as _metrics

__all__ = ["serve_metrics"]

#: power-of-two row-count buckets for the batch-size histogram — mirrors
#: the runner's bucket ladder so the exposition answers "which compiled
#: shape did traffic actually land in?"
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

_M: Dict[str, object] = {}


def serve_metrics() -> Dict[str, object]:
    """Lazily declared instrument handles (get-or-create, shared by all
    serve layers — one dict lookup per event on the hot path)."""
    if not _M:
        r = _metrics.default_registry()
        _M.update({
            # -- frontend ------------------------------------------------
            "requests": r.counter(
                "serve_requests_total",
                "HTTP requests served, by path and status code",
                labels=("path", "code")),
            "version_requests": r.counter(
                "serve_version_requests_total",
                "predict requests answered, by model version",
                labels=("version",)),
            "e2e": r.histogram(
                "serve_request_seconds",
                "end-to-end request latency (parse + queue + batch + "
                "execute + respond)", labels=("path",)),
            # -- batcher -------------------------------------------------
            "queue_depth": r.gauge(
                "serve_queue_depth",
                "requests currently queued for batching",
                labels=("batcher",)),
            "queue_wait": r.histogram(
                "serve_queue_wait_seconds",
                "time a request waited in the batch queue before its "
                "batch was assembled", labels=("batcher",)),
            "batch_rows": r.histogram(
                "serve_batch_rows",
                "real (unpadded) rows per executed batch",
                labels=("batcher",), buckets=_BATCH_BUCKETS),
            "flushes": r.counter(
                "serve_batch_flush_total",
                "batch flushes, by trigger (full|deadline|drain)",
                labels=("batcher", "reason")),
            "rejected": r.counter(
                "serve_rejected_total",
                "requests rejected before execution, by reason "
                "(queue_full|closed|timeout|cancelled)",
                labels=("batcher", "reason")),
            # -- runner --------------------------------------------------
            "execute": r.histogram(
                "serve_execute_seconds",
                "model execute time per padded batch",
                labels=("runner",)),
            "rows": r.counter(
                "serve_rows_total", "real rows scored",
                labels=("runner",)),
            "pad_rows": r.counter(
                "serve_pad_rows_total",
                "padding rows added to reach a batch bucket",
                labels=("runner",)),
            "compiled_shapes": r.gauge(
                "serve_compiled_shapes",
                "distinct batch buckets this runner has executed "
                "(bounded by log2(max_batch)+1)", labels=("runner",)),
            # -- registry ------------------------------------------------
            "model_info": r.gauge(
                "serve_model_info",
                "1 for every published model version; the source label "
                "carries the checkpoint URI or model kind",
                labels=("version", "source")),
        })
    return _M
