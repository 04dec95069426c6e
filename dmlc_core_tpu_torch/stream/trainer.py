"""Long-running online trainer: tail → warm-start boost → publish.

:class:`OnlineTrainer` turns the batch HistGBT engine into a continuous
learner without touching its kernels: each **refresh** gathers one chunk
of fresh events from a :class:`~dmlc_core_tpu_torch.stream.tail.
RecordIOTailer`, rebuilds the sliding training window, and calls the
model's ordinary ``fit`` — which, on a model that already has trees, is
xgb_model-semantics **continued training**: bin cuts are kept (the
existing trees' thresholds are only meaningful against them), margins
replay from the current ensemble on device, and ``param.n_trees`` new
trees are boosted on the window.

Recency weighting: the window holds the last ``window_chunks`` chunks;
chunk age ``a`` (0 = newest) carries sample weight ``decay^a``.  With
``decay == 1.0`` no weights are passed at all, which pins the documented
**warm-start parity contract** (tests/test_stream.py): an OnlineTrainer
with ``window_chunks=1, decay=1.0`` fed chunks A then B produces
*bit-identical* predictions to ``model.fit(A); model.fit(B)`` on the
same parameterization — online learning is exactly repeated continued
fits, not a new training algorithm.

Fixed shapes: a refresh only fits on a **full** chunk of exactly
``chunk_rows`` rows — a partial gather (timeout/stop mid-chunk) stays in
a pending buffer, counts toward the next refresh, and ``refresh``
returns ``None``, so every chunk in the window has the same row count by
construction.  The window grows chunk by chunk until it holds
``window_chunks`` chunks and then stays at that row count.  The JAX
package keeps this policy so that steady-state refreshes re-dispatch
compiled round programs; eager torch compiles nothing, and the port
keeps the policy for its delivery contract and for one fit shape a
refresh.  Pending rows are consumed from the tailer but
**uncommitted** (commits only happen on a fitting refresh), so a crash
replays them — at-least-once is preserved.  A
finite stream's partial tail can be trained explicitly with
:meth:`~OnlineTrainer.flush`.

Each refresh optionally flows through a :class:`~dmlc_core_tpu_torch.stream.
publisher.ModelPublisher` (staged registry publish, holdout eval gate,
rollback on regression) and then commits the tailer cursor — commit
AFTER publish, so a crash between the two re-trains and re-publishes the
chunk instead of silently dropping it (at-least-once end to end).

The PyTorch port's counterpart of ``dmlc_core_tpu/stream/trainer.py``:
the same policy, knobs, metrics and summaries.  Each refresh is the
port's ``HistGBT.fit`` on the model's device, so on a card a refresh
runs the histogram kernels (``hist_kernel`` at the root,
``fused_round_kernel`` below it) and ``descend_kernel`` for the margin
replay of the existing trees.  The warm-start parity contract holds
within the port bit for bit, on the CPU and on a card.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import knobs as _knobs
from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.stream.dataset import decode_dense_events
from dmlc_core_tpu_torch.stream.tail import RecordIOTailer

__all__ = ["OnlineTrainer"]

_TM = None


def _trainer_metrics():
    global _TM
    if _TM is None:
        r = _metrics.default_registry()
        _TM = {
            "refresh_s": r.histogram(
                "stream_refresh_seconds",
                "wall seconds per online refresh (gather + boost + "
                "publish)", labels=("trainer",)),
            "rows": r.counter(
                "stream_refresh_rows_total",
                "fresh event rows consumed by online refreshes",
                labels=("trainer",)),
        }
    return _TM


class OnlineTrainer:
    """Drive continuous warm-start boosting over a tailed event stream.

    ``model`` is any trainer with batch-continuation ``fit(X, y,
    weight=…)`` semantics (HistGBT and family); its ``param.n_trees`` is
    the number of trees added per refresh.  ``decode`` maps a list of
    raw records to ``(X, y)`` — default is the dense event codec
    (:func:`~dmlc_core_tpu_torch.stream.dataset.decode_dense_events`) with
    ``n_features``.
    """

    def __init__(self, model: Any, tailer: RecordIOTailer,
                 n_features: Optional[int] = None,
                 decode: Optional[Callable[[List[bytes]],
                                           Tuple[np.ndarray,
                                                 np.ndarray]]] = None,
                 chunk_rows: Optional[int] = None,
                 window_chunks: Optional[int] = None,
                 decay: Optional[float] = None,
                 publisher: Optional[Any] = None,
                 commit_cursor: bool = True,
                 name: str = "online"):
        CHECK(decode is not None or n_features is not None,
              "OnlineTrainer: pass decode= or n_features= (for the "
              "default dense event codec)")
        self.model = model
        self.tailer = tailer
        self.name = name
        self._decode = decode or (
            lambda recs: decode_dense_events(recs, n_features))
        self.chunk_rows = int(chunk_rows
                              if chunk_rows is not None
                              else _knobs.value("DMLC_STREAM_CHUNK_ROWS"))
        self.window_chunks = int(
            window_chunks if window_chunks is not None
            else _knobs.value("DMLC_STREAM_WINDOW_CHUNKS"))
        self.decay = float(decay if decay is not None
                           else _knobs.value("DMLC_STREAM_DECAY"))
        CHECK(self.chunk_rows > 0, "OnlineTrainer: chunk_rows must be > 0")
        CHECK(self.window_chunks > 0,
              "OnlineTrainer: window_chunks must be > 0")
        CHECK(0.0 < self.decay <= 1.0,
              f"OnlineTrainer: decay must be in (0, 1], got {self.decay}")
        self.publisher = publisher
        self.commit_cursor = commit_cursor
        self._window: Deque[Tuple[np.ndarray, np.ndarray]] = deque(
            maxlen=self.window_chunks)
        #: records gathered but short of a full chunk — consumed from
        #: the tailer, not yet trained on, not yet committed
        self._pending: List[bytes] = []
        self.refreshes = 0
        self.last_refresh: Optional[Dict[str, Any]] = None

    # -- window assembly -------------------------------------------------
    def _window_matrix(self) -> Tuple[np.ndarray, np.ndarray,
                                      Optional[np.ndarray]]:
        """Concatenate the window chunks (oldest first) with per-chunk
        decay weights.  ``decay == 1.0`` returns ``weight=None`` so the
        single-chunk case is bit-identical to an unweighted batch fit
        (the parity contract)."""
        chunks = list(self._window)
        X = (np.concatenate([c[0] for c in chunks])
             if len(chunks) > 1 else chunks[0][0])
        y = (np.concatenate([c[1] for c in chunks])
             if len(chunks) > 1 else chunks[0][1])
        if self.decay == 1.0:
            return X, y, None
        ages = range(len(chunks) - 1, -1, -1)     # oldest chunk first
        w = np.concatenate([
            np.full(len(c[1]), self.decay ** a, np.float32)
            for c, a in zip(chunks, ages)])
        return X, y, w

    # -- the refresh loop ------------------------------------------------
    def refresh(self, timeout: Optional[float] = None,
                stop: Optional[Callable[[], bool]] = None
                ) -> Optional[Dict[str, Any]]:
        """One refresh: gather fresh records until a full chunk of
        exactly ``chunk_rows`` exists (bounded by ``timeout``), boost,
        publish, commit.  A partial gather stays pending for the next
        call — fixed fit shapes — and returns None, as does an empty
        one (timeout/stop)."""
        t0 = time.monotonic()
        got = self.tailer.wait_records(
            self.chunk_rows - len(self._pending),
            timeout=timeout, stop=stop)
        self._pending.extend(got)
        if len(self._pending) < self.chunk_rows:
            return None
        records, self._pending = self._pending, []
        return self._fit_chunk(records, t0)

    def flush(self) -> Optional[Dict[str, Any]]:
        """Train on the pending partial chunk (finite-stream tail); its
        fit shape is off the chunk grid."""
        if not self._pending:
            return None
        records, self._pending = self._pending, []
        return self._fit_chunk(records, time.monotonic())

    def _fit_chunk(self, records: List[bytes],
                   t0: float) -> Dict[str, Any]:
        X, y = self._decode(records)
        self._window.append((X, y))
        Xw, yw, ww = self._window_matrix()
        t_fit = time.monotonic()
        self.model.fit(Xw, yw, weight=ww)
        out: Dict[str, Any] = {
            "refresh": self.refreshes + 1,
            "rows": len(records),
            "window_rows": len(yw),
            "records_total": self.tailer.records_seen,
            "trees_total": len(getattr(self.model, "trees", ())),
            "fit_seconds": round(time.monotonic() - t_fit, 4),
        }
        if self.publisher is not None:
            out.update(self.publisher.publish(
                self.model, source=f"stream:{self.name}"))
        if self.commit_cursor:
            out["cursor_version"] = self.tailer.commit()
        out["refresh_seconds"] = round(time.monotonic() - t0, 4)
        self.refreshes += 1
        self.last_refresh = out
        if _metrics.enabled():
            m = _trainer_metrics()
            m["refresh_s"].observe(out["refresh_seconds"],
                                   trainer=self.name)
            m["rows"].inc(len(records), trainer=self.name)
        LOG("INFO", "stream.trainer %s: refresh %d — %d rows (window %d), "
            "%d trees%s", self.name, out["refresh"], out["rows"],
            out["window_rows"], out["trees_total"],
            (f", v{out['version']} "
             f"{'activated' if out.get('activated') else 'ROLLED BACK'}"
             if "version" in out else ""))
        return out

    def run(self, max_refreshes: Optional[int] = None,
            timeout: Optional[float] = None,
            stop: Optional[Callable[[], bool]] = None
            ) -> List[Dict[str, Any]]:
        """Refresh until ``stop()``, ``max_refreshes``, or a refresh
        that gathers nothing within ``timeout``.  Returns the per-
        refresh summaries."""
        out: List[Dict[str, Any]] = []
        while max_refreshes is None or len(out) < max_refreshes:
            if stop is not None and stop():
                break
            r = self.refresh(timeout=timeout, stop=stop)
            if r is None:
                break
            out.append(r)
        return out
