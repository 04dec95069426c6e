"""Single-producer prefetch pipeline with buffer recycling.

Reference parity: ``include/dmlc/threadediter.h :: ThreadedIter<DType>`` —
``Init(next_fn, beforefirst_fn)`` / producer class, ``Next()``,
``Recycle()``, ``Destroy()``, bounded free/full cell queues
(``max_capacity``), and ``std::exception_ptr`` propagation from the
producer thread to the consumer (SURVEY.md §2a).

This is the template for the TPU host-infeed pipeline: a producer thread
runs storage reads / parsing / host staging while the consumer (the training
loop) overlaps device compute.  ``recycle()`` returns buffers to the
producer so steady state does zero allocation — with numpy-backed cells the
recycled buffer is re-filled in place and re-``device_put``, keeping host
memory traffic flat (SURVEY.md §7 hard part (b)).

Rewind correctness: items are epoch-tagged.  ``before_first()`` bumps the
epoch, so anything a mid-push producer deposits from the previous epoch is
discarded by the consumer instead of leaking across the rewind — the state
machine the reference implements with its producer condition variables.

Observability: the pipeline's THE health question — is the producer
keeping the consumer fed, or is the consumer starving? — is answered by
three instruments in ``base.metrics`` (labelled per iter ``name``):
queue-occupancy samples at every consume, a producer-stall histogram
(time blocked pushing into a full queue — the GOOD kind of wait: the
device is ahead), and a consumer-wait histogram (time the training loop
starved — the infeed stall itself).  With host tracing on
(``utils.profiler.set_tracing``) each produced item also becomes a
``threaded_iter.produce`` scope on the producer thread's trace row.

This package's own copy of ``dmlc_core_tpu.io.threaded_iter``.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Generic, Iterator, Optional, TypeVar

from dmlc_core_tpu_torch.base import faultinject as _fi
from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import LOG
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.io.concurrency import ConcurrentBlockingQueue, QueueKilled
from dmlc_core_tpu_torch.utils.profiler import global_tracer, tracing_enabled

__all__ = ["ThreadedIter"]

T = TypeVar("T")

_END = object()  # end-of-stream marker payload
_ERROR = object()  # producer-exception marker payload

_M = None


def _iter_metrics():
    """Lazily declared instrument handles (shared, module-level — one
    dict lookup per event, no registry traffic on the hot path)."""
    global _M
    if _M is None:
        r = _metrics.default_registry()
        _M = {
            "depth": r.gauge(
                "threaded_iter_queue_depth",
                "current full-queue occupancy", labels=("iter",)),
            "occupancy": r.histogram(
                "threaded_iter_queue_occupancy",
                "full-queue depth sampled at each consume",
                labels=("iter",),
                buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128)),
            "stall": r.histogram(
                "threaded_iter_producer_stall_seconds",
                "producer time blocked pushing into a full queue",
                labels=("iter",)),
            "wait": r.histogram(
                "threaded_iter_consumer_wait_seconds",
                "consumer time blocked waiting for the producer",
                labels=("iter",)),
            "items": r.counter(
                "threaded_iter_items_total",
                "items delivered to the consumer", labels=("iter",)),
            "restarts": r.counter(
                "threaded_iter_producer_restarts_total",
                "producer exceptions absorbed by the bounded restart "
                "budget instead of killing the pipeline",
                labels=("iter",)),
        }
    return _M


class ThreadedIter(Generic[T]):
    """Asynchronous buffered iterator backed by one producer thread.

    Two usage styles, matching the reference:

    * function style::

          it = ThreadedIter(max_capacity=4)
          it.init(next_fn)           # next_fn(reuse_cell) -> item | None
          while (item := it.next()) is not None:
              consume(item)
              it.recycle(item)       # hand the buffer back for reuse

      ``next_fn`` receives a recycled cell (or None) and returns the next
      item, or None at end of stream.  ``before_first_fn`` rewinds the
      underlying source.

    * iterator protocol: ``for item in it: ...`` (no recycling).

    Exceptions raised in the producer are captured and re-raised from
    ``next()`` in the consumer thread — the exception_ptr contract that the
    reference's ``unittest_threaditer_exc_handling`` pins down.  With
    ``max_restarts`` > 0 (or ``DMLC_ITER_PRODUCER_RESTARTS``) up to that
    many producer exceptions are absorbed instead: the failed item is
    skipped, the restart is counted, and the pipeline keeps flowing
    (doc/robustness.md).
    """

    def __init__(self, max_capacity: int = 8, name: str = "default",
                 max_restarts: Optional[int] = None):
        self.max_capacity = max_capacity
        #: bounded producer-restart budget (whole iter lifetime): a
        #: producer exception with budget left is logged, counted on
        #: ``threaded_iter_producer_restarts_total`` and the producer
        #: keeps going (the failed item is skipped) instead of killing
        #: the pipeline.  Default 0 — every exception propagates to the
        #: consumer exactly as before; env ``DMLC_ITER_PRODUCER_RESTARTS``
        #: sets the process-wide default.
        if max_restarts is None:
            try:
                max_restarts = int(
                    os.environ.get("DMLC_ITER_PRODUCER_RESTARTS", "0"))
            except ValueError:
                max_restarts = 0
        self.max_restarts = max_restarts
        self._restarts_left = max_restarts
        #: metrics label — give pipelines distinct names so their
        #: queue-depth/stall series stay separable (bounded cardinality:
        #: use a role name, not a per-instance id)
        self.name = name
        self._full: ConcurrentBlockingQueue = ConcurrentBlockingQueue(max_size=max_capacity)
        self._free: ConcurrentBlockingQueue = ConcurrentBlockingQueue()
        self._thread: Optional[threading.Thread] = None
        self._next_fn: Optional[Callable[[Optional[T]], Optional[T]]] = None
        self._before_first_fn: Optional[Callable[[], None]] = None
        self._producer_exc: Optional[BaseException] = None
        self._epoch = 0  # bumped by before_first(); guarded by _epoch_lock
        self._epoch_lock = threading.Lock()
        self._wake = threading.Event()  # pokes a parked/ended producer
        self._ended_epoch: Optional[int] = None  # epoch whose END was consumed
        self._destroyed = False

    # -- setup -----------------------------------------------------------
    def init(
        self,
        next_fn: Callable[[Optional[T]], Optional[T]],
        before_first_fn: Optional[Callable[[], None]] = None,
    ) -> None:
        """Start the producer thread.  Reference: ``ThreadedIter::Init``."""
        assert self._thread is None, "ThreadedIter.init called twice"
        self._next_fn = next_fn
        self._before_first_fn = before_first_fn
        self._thread = threading.Thread(target=self._producer_loop, daemon=True)
        self._thread.start()

    def _current_epoch(self) -> int:
        with self._epoch_lock:
            return self._epoch

    def _producer_loop(self) -> None:
        last_epoch = 0
        try:
            while not self._destroyed:
                epoch = self._current_epoch()
                if epoch != last_epoch:
                    last_epoch = epoch
                    if self._before_first_fn is not None:
                        self._before_first_fn()
                try:
                    cell = self._free.pop(timeout=0.0) if self._free.size() else None
                except (TimeoutError, QueueKilled):
                    cell = None
                try:
                    fault = _fi.check("iter", ctx=self.name)
                    if fault is not None and fault.kind == "error":
                        raise RuntimeError(
                            f"fault injected: producer error ({self.name})")
                    if tracing_enabled():
                        with global_tracer().scope("threaded_iter.produce",
                                                   iter=self.name):
                            item = self._next_fn(cell)  # type: ignore[misc]
                    else:
                        item = self._next_fn(cell)  # type: ignore[misc]
                except QueueKilled:
                    raise
                except BaseException as e:  # noqa: BLE001
                    if self._restarts_left <= 0:
                        raise
                    # bounded restart: absorb the failure, skip the item,
                    # keep producing — the alternative is a dead pipeline
                    # mid-epoch for a single flaky read
                    self._restarts_left -= 1
                    LOG("WARNING",
                        "ThreadedIter %s: producer raised %s: %s — "
                        "restarting (%d restarts left)", self.name,
                        type(e).__name__, e, self._restarts_left)
                    if _metrics.enabled():
                        _iter_metrics()["restarts"].inc(1, iter=self.name)
                    continue
                if item is None:
                    self._full.push((epoch, _END))
                    # park until rewind or destroy
                    while not self._destroyed and self._current_epoch() == epoch:
                        self._wake.wait(0.02)
                        self._wake.clear()
                    continue
                if _metrics.enabled():
                    m = _iter_metrics()
                    t_push = get_time()
                    self._full.push((epoch, item))
                    m["stall"].observe(get_time() - t_push, iter=self.name)
                    m["depth"].set(self._full.size(), iter=self.name)
                else:
                    self._full.push((epoch, item))
        except QueueKilled:
            pass
        except BaseException as e:  # noqa: BLE001 — exception_ptr semantics
            self._producer_exc = e
            try:
                self._full.push((self._current_epoch(), _ERROR))
            except QueueKilled:
                pass

    # -- consumer API ----------------------------------------------------
    def next(self, timeout: Optional[float] = None) -> Optional[T]:
        """Return the next item, or None at end of stream.

        Re-raises any producer exception here (exception_ptr contract).
        """
        if self._destroyed:
            return None
        if self._ended_epoch == self._current_epoch():
            return None  # already hit END this epoch; don't block forever
        collect = _metrics.enabled()
        while True:
            if collect:
                m = _iter_metrics()
                # occupancy BEFORE the pop: "how much buffer was banked
                # when the consumer came asking" — the number that says
                # whether the producer is ahead (depth > 0) or the
                # consumer is about to stall (depth 0)
                m["occupancy"].observe(self._full.size(), iter=self.name)
                t_wait = get_time()
                epoch, payload = self._full.pop(timeout=timeout)
                m["wait"].observe(get_time() - t_wait, iter=self.name)
                m["depth"].set(self._full.size(), iter=self.name)
            else:
                epoch, payload = self._full.pop(timeout=timeout)
            if payload is _ERROR:
                exc = self._producer_exc
                self._producer_exc = None
                self.destroy()
                raise exc  # type: ignore[misc]
            if epoch != self._current_epoch():
                continue  # stale item produced across a rewind — drop
            if payload is _END:
                self._ended_epoch = epoch
                return None
            if collect:
                m["items"].inc(1, iter=self.name)
            return payload

    def recycle(self, cell: T) -> None:
        """Hand a consumed buffer back to the producer for reuse."""
        if not self._destroyed:
            try:
                self._free.push(cell)
            except QueueKilled:
                pass

    def before_first(self) -> None:
        """Rewind.  Reference: ``BeforeFirst`` (requires before_first_fn)."""
        assert self._before_first_fn is not None, "no before_first_fn given"
        with self._epoch_lock:
            self._epoch += 1
        self._wake.set()
        # No drain here: stale items are filtered by epoch in next(), which
        # also frees queue slots for the producer.  Draining here could pop
        # (and lose) items the producer already tagged with the new epoch.

    def destroy(self) -> None:
        """Stop the producer and release queues.  Idempotent."""
        if self._destroyed:
            return
        self._destroyed = True
        self._wake.set()
        self._full.signal_for_kill()
        self._free.signal_for_kill()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    def __iter__(self) -> Iterator[T]:
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    def __enter__(self) -> "ThreadedIter[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.destroy()

    def __del__(self) -> None:
        try:
            self.destroy()
        except Exception:
            pass
