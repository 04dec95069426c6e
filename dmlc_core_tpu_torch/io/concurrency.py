"""Bounded blocking queue with kill signaling.

Reference parity: ``include/dmlc/concurrency.h ::
ConcurrentBlockingQueue<T, PriorityTag>`` — Push/Pop/SignalForKill/Size
(SURVEY.md §2a).  The reference also vendors moodycamel's lock-free MPMC
queues; in Python the GIL makes a lock-free design meaningless, so a
condvar queue (matching the semantics the reference's own
ConcurrentBlockingQueue provides) is the whole story — true lock-free
paths live in the C++ hot loop (cpp/), not here.

This package's own copy of ``dmlc_core_tpu.io.concurrency``, without the
JAX package's race-checker instrumentation (``base/racecheck.py`` is not
copied).
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Generic, List, Optional, Tuple, TypeVar

__all__ = ["ConcurrentBlockingQueue", "QueueKilled"]

T = TypeVar("T")


class QueueKilled(Exception):
    """Raised to a blocked producer/consumer after signal_for_kill()."""


class ConcurrentBlockingQueue(Generic[T]):
    """Bounded blocking MPMC queue.

    * ``push(v)`` blocks while full; ``pop()`` blocks while empty.
    * ``signal_for_kill()`` wakes all waiters; blocked/later calls raise
      :class:`QueueKilled` (the reference returns false from Pop — an
      exception is the Pythonic spelling of the same contract).
    * ``priority=True`` pops smallest ``(priority, seq)`` first (the
      reference's PriorityTag mode).
    """

    def __init__(self, max_size: int = 0, priority: bool = False):
        self._max = max_size
        self._priority = priority
        self._items: List[Any] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._killed = False

    def _push_locked(self, value: T, priority: int) -> None:
        """Insert + notify; caller holds the lock and checked capacity."""
        if self._priority:
            heapq.heappush(self._items, (priority, self._seq, value))
            self._seq += 1
        else:
            self._items.append(value)
        self._not_empty.notify()

    def _pop_locked(self) -> T:
        """Remove + notify; caller holds the lock and checked emptiness."""
        if self._priority:
            value = heapq.heappop(self._items)[2]
        else:
            value = self._items.pop(0)
        self._not_full.notify()
        return value

    def push(self, value: T, priority: int = 0, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_full:
            while not self._killed and self._max > 0 and len(self._items) >= self._max:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("ConcurrentBlockingQueue.push timed out")
                self._not_full.wait(remaining)
            if self._killed:
                raise QueueKilled()
            self._push_locked(value, priority)

    def pop(self, timeout: Optional[float] = None) -> T:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_empty:
            while not self._killed and not self._items:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("ConcurrentBlockingQueue.pop timed out")
                self._not_empty.wait(remaining)
            if self._killed and not self._items:
                raise QueueKilled()
            return self._pop_locked()

    def try_push(self, value: T, priority: int = 0) -> bool:
        """Non-blocking push; False when full (raises if killed)."""
        with self._not_full:
            if self._killed:
                raise QueueKilled()
            if self._max > 0 and len(self._items) >= self._max:
                return False
            self._push_locked(value, priority)
            return True

    def try_pop(self) -> Tuple[bool, Optional[T]]:
        """Non-blocking pop; (False, None) when empty (raises if killed+empty)."""
        with self._not_empty:
            if not self._items:
                if self._killed:
                    raise QueueKilled()
                return False, None
            return True, self._pop_locked()

    def signal_for_kill(self) -> None:
        with self._lock:
            self._killed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def killed(self) -> bool:
        with self._lock:
            return self._killed
