"""Thread-safe dynamic micro-batcher over the io.concurrency primitives.

The serving analogue of :class:`~dmlc_core_tpu_torch.io.threaded_iter.
ThreadedIter`'s producer/consumer split, built on the same
:class:`~dmlc_core_tpu_torch.io.concurrency.ConcurrentBlockingQueue`: many
request threads push, ONE flush thread pops, coalesces requests into a
batch, and executes.  Where ThreadedIter moves a stream one way, the
batcher closes the loop with per-request futures.

Flush policy (the two-knob latency/throughput trade documented in
``doc/serving.md``):

* **size** — a batch flushes as soon as it holds ``max_batch`` rows;
* **deadline** — else it flushes ``max_delay`` seconds after its FIRST
  request was enqueued, however few rows it holds.  Low traffic pays at
  most ``max_delay`` extra latency; high traffic hits the size trigger
  first and the deadline never fires.

Contracts:

* **backpressure** — the request queue is bounded; ``submit`` on a full
  queue raises :class:`QueueFullError` immediately (the frontend's 503
  admission control) instead of queueing unbounded work.
* **timeout / cancel** — a request's ``timeout`` is checked when its
  batch is assembled: an expired request gets ``TimeoutError`` on its
  future and never executes; a future cancelled while queued is skipped
  (``concurrent.futures`` cancellation protocol).
* **graceful drain** — ``close(drain=True)`` stops admissions, lets the
  flush thread finish EVERY queued request, then joins it: no accepted
  request is dropped.  ``close(drain=False)`` fails queued requests with
  :class:`BatcherClosedError`.

``execute`` receives the concatenated ``[rows, F]`` batch and returns
predictions (optionally ``(predictions, extra)``); each future resolves
to ``(its_rows_slice, extra)``.  The registry's hot-swap relies on the
extra channel to report which model version served the batch.

This package's own copy of ``dmlc_core_tpu.serve.batcher``, over the
port's ``io/concurrency.py``: the same flush, deadline, backpressure,
timeout, cancel and drain contracts.  The JAX package's race-checker
instrumentation (``@instrument_class``) is dropped, as the port's
``io/concurrency.py`` drops it (``base/racecheck.py`` is not copied).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.io.concurrency import ConcurrentBlockingQueue, QueueKilled
from dmlc_core_tpu_torch.serve.instruments import serve_metrics

__all__ = ["DynamicBatcher", "QueueFullError", "BatcherClosedError"]

#: flush-thread poll interval while idle — bounds close() latency, not
#: request latency (a waiting request wakes the pop immediately)
_IDLE_POLL_S = 0.05


class QueueFullError(RuntimeError):
    """submit() on a full request queue — admission control says 503."""


class BatcherClosedError(RuntimeError):
    """submit() after close(), or a queued request failed by a
    non-draining shutdown."""


class _Request:
    __slots__ = ("rows", "n", "future", "t_enq", "deadline")

    def __init__(self, rows: np.ndarray, timeout: Optional[float]):
        self.rows = rows
        self.n = len(rows)
        self.future: Future = Future()
        self.t_enq = get_time()
        self.deadline = None if timeout is None else self.t_enq + timeout


class DynamicBatcher:
    """Coalesce concurrent predict requests into bounded batches.

    ``execute(X) -> preds | (preds, extra)`` runs on the single flush
    thread; ``submit`` is safe from any number of threads.
    """

    def __init__(self, execute: Callable[[np.ndarray], Any],
                 max_batch: int = 1024, max_delay: float = 0.002,
                 max_queue: int = 256, name: str = "default"):
        CHECK(max_batch >= 1, f"max_batch must be >= 1, got {max_batch}")
        CHECK(max_delay >= 0.0, f"max_delay must be >= 0, got {max_delay}")
        CHECK(max_queue >= 1, f"max_queue must be >= 1, got {max_queue}")
        self._execute = execute
        self.max_batch = max_batch
        self.max_delay = max_delay
        #: metrics label — a role name, not a per-instance id
        self.name = name
        self._queue: ConcurrentBlockingQueue[_Request] = \
            ConcurrentBlockingQueue(max_size=max_queue)
        # an Event, not a bool: the closed flag is written by the
        # closing thread and read by submitters AND the flush thread —
        # set()/is_set() gives that handoff a real happens-before edge
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._flush_loop, daemon=True,
            name=f"serve-batcher-{name}")
        self._thread.start()

    # -- producer side ---------------------------------------------------
    def submit(self, rows: np.ndarray,
               timeout: Optional[float] = None) -> Future:
        """Enqueue ``[k, F]`` rows (or one ``[F]`` row) for batched
        prediction; returns a future resolving to
        ``(predictions_for_these_rows, extra)``.

        Raises :class:`QueueFullError` when the queue is at capacity and
        :class:`BatcherClosedError` after :meth:`close` — both BEFORE
        any work is queued, so callers can shed load immediately."""
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        CHECK(rows.ndim == 2 and 1 <= len(rows) <= self.max_batch,
              f"submit: want [k<={self.max_batch}, F] rows, "
              f"got shape {rows.shape}")
        if self._closed.is_set():
            self._count_reject("closed")
            raise BatcherClosedError("batcher is closed")
        req = _Request(rows, timeout)
        try:
            accepted = self._queue.try_push(req)
        except QueueKilled:
            self._count_reject("closed")
            raise BatcherClosedError("batcher is closed") from None
        if not accepted:
            self._count_reject("queue_full")
            raise QueueFullError(
                f"batcher {self.name!r}: request queue full")
        if _metrics.enabled():
            serve_metrics()["queue_depth"].set(
                self._queue.size(), batcher=self.name)
        return req.future

    def depth(self) -> int:
        """Requests currently queued (admission-control visibility)."""
        return self._queue.size()

    # -- flush thread ----------------------------------------------------
    def _flush_loop(self) -> None:
        pending: Optional[_Request] = None
        while True:
            if pending is not None:
                first, pending = pending, None
            else:
                try:
                    first = self._queue.pop(timeout=_IDLE_POLL_S)
                except TimeoutError:
                    if self._closed.is_set() and self._queue.size() == 0:
                        return
                    continue
                except QueueKilled:
                    return
            batch = [first]
            rows = first.n
            reason = "deadline"
            deadline = first.t_enq + self.max_delay
            while rows < self.max_batch:
                if self._closed.is_set():
                    # draining: flush as fast as the queue empties, don't
                    # idle out the deadline on a dead frontend
                    ok, nxt = self._try_pop()
                    if not ok:
                        reason = "drain"
                        break
                else:
                    remaining = deadline - get_time()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._queue.pop(timeout=remaining)
                    except (TimeoutError, QueueKilled):
                        break
                if rows + nxt.n > self.max_batch:
                    pending = nxt           # opens the NEXT batch
                    reason = "full"
                    break
                batch.append(nxt)
                rows += nxt.n
            else:
                reason = "full"
            self._run_batch(batch, reason)

    def _try_pop(self) -> Tuple[bool, Optional[_Request]]:
        try:
            return self._queue.try_pop()
        except QueueKilled:
            return False, None

    def _run_batch(self, batch: List[_Request], reason: str) -> None:
        t_pop = get_time()
        live: List[_Request] = []
        for req in batch:
            if req.deadline is not None and t_pop > req.deadline:
                self._count_reject("timeout")
                req.future.set_exception(TimeoutError(
                    f"request expired after {t_pop - req.t_enq:.3f}s "
                    f"in the batch queue"))
            elif not req.future.set_running_or_notify_cancel():
                self._count_reject("cancelled")
            else:
                live.append(req)
        if not live:
            return
        if _metrics.enabled():
            m = serve_metrics()
            for req in live:
                m["queue_wait"].observe(t_pop - req.t_enq,
                                        batcher=self.name)
            m["batch_rows"].observe(sum(r.n for r in live),
                                    batcher=self.name)
            m["flushes"].inc(1, batcher=self.name, reason=reason)
            m["queue_depth"].set(self._queue.size(), batcher=self.name)
        X = (live[0].rows if len(live) == 1
             else np.concatenate([r.rows for r in live]))
        try:
            out = self._execute(X)
        except BaseException as e:  # noqa: BLE001 — fail the whole batch
            for req in live:
                req.future.set_exception(e)
            return
        preds, extra = out if isinstance(out, tuple) else (out, None)
        preds = np.asarray(preds)
        lo = 0
        for req in live:
            req.future.set_result((preds[lo:lo + req.n], extra))
            lo += req.n

    # -- shutdown --------------------------------------------------------
    def close(self, drain: bool = True, timeout: Optional[float] = 10.0
              ) -> None:
        """Stop admissions; ``drain=True`` completes every queued
        request before returning, ``drain=False`` fails them with
        :class:`BatcherClosedError`.  Idempotent."""
        self._closed.set()
        if not drain:
            self._queue.signal_for_kill()
        self._thread.join(timeout=timeout)
        if not drain:
            while True:
                ok, req = self._try_pop()
                if not ok:
                    break
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(
                        BatcherClosedError("batcher closed without drain"))

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _count_reject(self, reason: str) -> None:
        if _metrics.enabled():
            serve_metrics()["rejected"].inc(
                1, batcher=self.name, reason=reason)
