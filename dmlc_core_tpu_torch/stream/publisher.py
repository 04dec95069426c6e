"""Auto-publish online refreshes into the serve registry, safely.

The last hop of the train→serve loop: after each refresh the trainer
hands its (continuously mutated) model here, and :class:`ModelPublisher`

1. **snapshots** it — a byte-level ``save_model``/``load_model`` round
   trip via :func:`~dmlc_core_tpu_torch.serve.registry.clone_model`, because
   the registry must never hold a reference the next refresh will
   mutate under in-flight batches;
2. **stages** the snapshot — ``ModelRegistry.publish(…,
   activate=False)`` retains it under a monotone version without moving
   the current pointer, so live traffic never sees an unvetted model;
3. **eval-gates** it on the holdout window: candidate score vs the
   score of the version traffic is currently served from, with relative
   tolerance ``DMLC_STREAM_EVAL_GATE`` (scores are lower-is-better;
   default metric is mean squared error of ``predict`` vs labels);
4. **activates** on pass (the registry's atomic hot-swap — in-flight
   batches finish on the old version) or **rolls back** on regression:
   the current pointer simply never moves, the poisoned candidate stays
   retained for postmortem, and ``dmlc_stream_refreshes_total{outcome=
   "rolled_back"}`` counts the save.

With ``checkpoint_uri`` set, every *activated* snapshot is also written
as a versioned serving checkpoint (atomic, CRC'd, previous version
retained — ``parallel.checkpoint`` semantics), so a crashed process
restarts by ``registry.load(checkpoint_uri)`` into bit-identical
predictions for the last good version.

The PyTorch port's counterpart of ``dmlc_core_tpu/stream/publisher.py``,
over the port's ``serve/registry.py``.  The snapshot lands on the
model's own device (``clone_model``), so the gate's holdout predictions
run where the model lives — on a card, ``forest_kernel``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import knobs as _knobs
from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import LOG
from dmlc_core_tpu_torch.serve.registry import (ModelRegistry, checkpoint_model,
                                          clone_model)

__all__ = ["ModelPublisher"]

_PM = None


def _pub_metrics():
    global _PM
    if _PM is None:
        r = _metrics.default_registry()
        _PM = {
            "refreshes": r.counter(
                "stream_refreshes_total",
                "model refreshes published to the serve registry, by "
                "gate outcome (activated|rolled_back)",
                labels=("publisher", "outcome")),
        }
    return _PM


def _mse_metric(model: Any, X: np.ndarray, y: np.ndarray) -> float:
    """Default eval-gate score: mean squared error of ``predict``
    against labels (lower is better; works for every model family the
    registry serves)."""
    pred = np.asarray(model.predict(X), np.float64).reshape(len(y), -1)
    if pred.shape[1] > 1:                      # multiclass: 0/1 error
        return float(np.mean(pred.argmax(axis=1) != y))
    return float(np.mean((pred[:, 0] - np.asarray(y, np.float64)) ** 2))


class ModelPublisher:
    """Staged publish + eval gate + rollback over a
    :class:`~dmlc_core_tpu_torch.serve.registry.ModelRegistry`.

    ``holdout=(Xh, yh)`` enables the gate; without it every snapshot
    activates unconditionally.  ``metric(model, Xh, yh) -> float``
    overrides the score (lower is better).  ``gate`` is the relative
    regression tolerance (default ``DMLC_STREAM_EVAL_GATE``): a
    candidate is rejected when ``score > active_score · (1 + gate) +
    1e-12``.  The first publish always activates (there is nothing to
    regress against)."""

    def __init__(self, registry: ModelRegistry,
                 holdout: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 metric: Optional[Callable[[Any, np.ndarray, np.ndarray],
                                           float]] = None,
                 gate: Optional[float] = None,
                 checkpoint_uri: Optional[str] = None,
                 name: str = "stream"):
        self.registry = registry
        self.holdout = holdout
        self.metric = metric or _mse_metric
        self.gate = float(gate if gate is not None
                          else _knobs.value("DMLC_STREAM_EVAL_GATE"))
        self.checkpoint_uri = checkpoint_uri
        self.name = name
        #: score of the version currently serving traffic (None before
        #: the first activation or when no holdout is configured)
        self.active_score: Optional[float] = None
        self.activations = 0
        self.rollbacks = 0

    def publish(self, model: Any,
                source: Optional[str] = None) -> Dict[str, Any]:
        """Snapshot → staged publish → gate → activate or roll back.
        Returns ``{version, activated, score, baseline}``."""
        snapshot = clone_model(model)
        version = self.registry.publish(snapshot, source=source or self.name,
                                        activate=False)
        score = baseline = None
        activated = True
        if self.holdout is not None:
            Xh, yh = self.holdout
            score = self.metric(snapshot, Xh, yh)
            baseline = self.active_score
            if baseline is not None and not (
                    score <= baseline * (1.0 + self.gate) + 1e-12):
                activated = False
        if activated:
            self.registry.activate(version)
            self.activations += 1
            if score is not None:
                self.active_score = score
            if self.checkpoint_uri:
                checkpoint_model(self.checkpoint_uri, snapshot, version)
        else:
            self.rollbacks += 1
            LOG("WARNING", "stream.publisher %s: v%d REJECTED by eval "
                "gate (score %.6g vs active %.6g, tolerance %.3g) — "
                "traffic stays on v%s", self.name, version, score,
                baseline, self.gate, self.registry.current_version())
        if _metrics.enabled():
            _pub_metrics()["refreshes"].inc(
                1, publisher=self.name,
                outcome="activated" if activated else "rolled_back")
        return {"version": version, "activated": activated,
                "score": score, "baseline": baseline}
