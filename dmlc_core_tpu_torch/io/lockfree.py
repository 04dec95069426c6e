"""Lock-free MPMC queue and spinlock over the native library.

Reference parity: ``include/dmlc/concurrentqueue.h`` /
``blockingconcurrentqueue.h`` (the vendored moodycamel lock-free MPMC
queue) and ``include/dmlc/concurrency.h :: Spinlock`` (SURVEY.md §2a).
The engine is an original Vyukov-style bounded ring in
``cpp/mpmc_queue.cc``; this module maps Python objects onto its opaque
64-bit payloads via a preallocated slot table: a producer takes a free slot
index (itself handed out by a second native queue, so slot recycling is
also lock-free), stores the object, and enqueues the index.

Falls back to :class:`~dmlc_core_tpu_torch.io.concurrency.ConcurrentBlockingQueue`
(the pure-Python condvar queue with full kill/wake semantics) when the
native library is absent (``base/_native_build.py`` builds it on first
use), so the API works everywhere — ``native_queue_available()``
reports which engine is live.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Any, List, Optional

from dmlc_core_tpu_torch.base import _native_build
from dmlc_core_tpu_torch.io.concurrency import ConcurrentBlockingQueue, QueueKilled

__all__ = [
    "native_queue_available",
    "ConcurrentQueue",
    "BlockingConcurrentQueue",
    "QueueKilledError",
    "Spinlock",
]

_lib: Optional[ctypes.CDLL] = None
_lib_checked = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        # negative results cached too: without this, every queue/lock
        # construction in fallback mode re-stats all candidate paths
        return _lib
    if os.environ.get("DMLC_TPU_NATIVE_IO", "1") == "0":
        _lib_checked = True
        return None
    path = _native_build.library_path()     # raises on a failed build
    _lib_checked = True
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.dmlc_mpmc_create.restype = ctypes.c_void_p
    lib.dmlc_mpmc_create.argtypes = [ctypes.c_uint64]
    lib.dmlc_mpmc_destroy.argtypes = [ctypes.c_void_p]
    lib.dmlc_mpmc_try_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dmlc_mpmc_try_pop.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dmlc_mpmc_push_block.argtypes = [
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_int64,
    ]
    lib.dmlc_mpmc_pop_block.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
    ]
    lib.dmlc_mpmc_kill.argtypes = [ctypes.c_void_p]
    lib.dmlc_mpmc_size_approx.restype = ctypes.c_uint64
    lib.dmlc_mpmc_size_approx.argtypes = [ctypes.c_void_p]
    lib.dmlc_spinlock_create.restype = ctypes.c_void_p
    lib.dmlc_spinlock_destroy.argtypes = [ctypes.c_void_p]
    lib.dmlc_spinlock_lock.argtypes = [ctypes.c_void_p]
    lib.dmlc_spinlock_trylock.argtypes = [ctypes.c_void_p]
    lib.dmlc_spinlock_unlock.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_queue_available() -> bool:
    """True when the native lock-free MPMC queue (cpp/mpmc_queue.cc) is
    built and loadable; consumers fall back to the Python queue otherwise."""
    return _load() is not None


class QueueKilledError(QueueKilled, RuntimeError):
    """Raised from blocking ops after :meth:`kill` (SignalForKill parity).

    Subclasses :class:`~dmlc_core_tpu_torch.io.concurrency.QueueKilled` so code
    written against either queue catches kills with one except clause."""


class ConcurrentQueue:
    """Bounded MPMC queue of Python objects over the native lock-free ring.

    Non-blocking API (moodycamel ``ConcurrentQueue`` shape):
    ``try_enqueue(obj) -> bool`` and ``try_dequeue() -> (ok, obj)``.
    """

    def __init__(self, capacity: int = 1024):
        self._capacity = max(2, capacity)
        self._lib = _load()
        if self._lib is not None:
            self._q = self._lib.dmlc_mpmc_create(self._capacity)
            self._free = self._lib.dmlc_mpmc_create(self._capacity)
            # Slot table: plain CPython list assignment is atomic under the
            # GIL; slot *ownership* is serialized by the native queues.
            self._slots: List[Any] = [None] * self._capacity
            for i in range(self._capacity):
                self._lib.dmlc_mpmc_try_push(self._free, i)
        else:
            self._pyq: ConcurrentBlockingQueue = ConcurrentBlockingQueue(
                max_size=self._capacity
            )
        self._killed = False

    # -- non-blocking ----------------------------------------------------
    def try_enqueue(self, obj: Any) -> bool:
        if self._killed:
            raise QueueKilledError("queue killed")
        if self._lib is None:
            try:
                return self._pyq.try_push(obj)
            except QueueKilled:
                raise QueueKilledError("queue killed")
        idx = ctypes.c_uint64()
        if not self._lib.dmlc_mpmc_try_pop(self._free, ctypes.byref(idx)):
            return False
        self._slots[idx.value] = obj
        ok = self._lib.dmlc_mpmc_try_push(self._q, idx.value)
        assert ok, "data queue can never be full while a free slot existed"
        return True

    def try_dequeue(self):
        if self._lib is None:
            try:
                return self._pyq.try_pop()
            except QueueKilled:
                raise QueueKilledError("queue killed")
        idx = ctypes.c_uint64()
        if not self._lib.dmlc_mpmc_try_pop(self._q, ctypes.byref(idx)):
            # drain semantics match the fallback: raise only once killed AND
            # empty — items pushed before the kill still come out
            if self._killed:
                raise QueueKilledError("queue killed")
            return False, None
        obj = self._slots[idx.value]
        self._slots[idx.value] = None
        self._lib.dmlc_mpmc_try_push(self._free, idx.value)
        return True, obj

    def size_approx(self) -> int:
        if self._lib is None:
            return self._pyq.size()
        return int(self._lib.dmlc_mpmc_size_approx(self._q))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.dmlc_mpmc_destroy(self._q)
            lib.dmlc_mpmc_destroy(self._free)
            self._lib = None


class BlockingConcurrentQueue(ConcurrentQueue):
    """Blocking variant (moodycamel ``BlockingConcurrentQueue`` /
    ``concurrency.h ConcurrentBlockingQueue`` shape): ``enqueue``/``dequeue``
    park after a bounded lock-free spin; :meth:`kill` is ``SignalForKill``.
    """

    def enqueue(self, obj: Any, timeout: Optional[float] = None) -> bool:
        if self._killed:
            raise QueueKilledError("queue killed")
        if self._lib is None:
            try:
                self._pyq.push(obj, timeout=timeout)
                return True
            except TimeoutError:
                return False
            except QueueKilled:
                raise QueueKilledError("queue killed")
        to_ms = -1 if timeout is None else int(timeout * 1000)
        idx = ctypes.c_uint64()
        rc = self._lib.dmlc_mpmc_pop_block(self._free, ctypes.byref(idx), to_ms)
        if rc == -1:
            raise QueueKilledError("queue killed")
        if rc == 0:
            return False
        self._slots[idx.value] = obj
        rc = self._lib.dmlc_mpmc_push_block(self._q, idx.value, -1)
        if rc == -1:
            raise QueueKilledError("queue killed")
        return True

    def dequeue(self, timeout: Optional[float] = None):
        if self._lib is None:
            try:
                return True, self._pyq.pop(timeout=timeout)
            except TimeoutError:
                return False, None
            except QueueKilled:
                raise QueueKilledError("queue killed")
        to_ms = -1 if timeout is None else int(timeout * 1000)
        idx = ctypes.c_uint64()
        rc = self._lib.dmlc_mpmc_pop_block(self._q, ctypes.byref(idx), to_ms)
        if rc == -1:
            raise QueueKilledError("queue killed")
        if rc == 0:
            return False, None
        obj = self._slots[idx.value]
        self._slots[idx.value] = None
        self._lib.dmlc_mpmc_try_push(self._free, idx.value)
        return True, obj

    def kill(self) -> None:
        """SignalForKill: wake all blocked threads; they raise
        :class:`QueueKilledError`."""
        self._killed = True
        if self._lib is not None:
            self._lib.dmlc_mpmc_kill(self._q)
            self._lib.dmlc_mpmc_kill(self._free)
        else:
            self._pyq.signal_for_kill()


class Spinlock:
    """Native test-and-set spinlock (``concurrency.h :: Spinlock``).

    Context-manager usable.  Falls back to ``threading.Lock`` without the
    native library (a Python busy-wait would burn the GIL for nothing).
    """

    def __init__(self):
        self._lib = _load()
        if self._lib is not None:
            self._l = self._lib.dmlc_spinlock_create()
        else:
            self._pylock = threading.Lock()

    def acquire(self) -> None:
        if self._lib is not None:
            self._lib.dmlc_spinlock_lock(self._l)
        else:
            # this IS the lock primitive; callers own release pairing
            self._pylock.acquire()  # dmlcheck: off:lock-release

    def try_acquire(self) -> bool:
        if self._lib is not None:
            return bool(self._lib.dmlc_spinlock_trylock(self._l))
        return self._pylock.acquire(blocking=False)

    def release(self) -> None:
        if self._lib is not None:
            self._lib.dmlc_spinlock_unlock(self._l)
        else:
            self._pylock.release()

    def __enter__(self):
        self.acquire()  # dmlcheck: off:lock-release — paired by __exit__
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            lib.dmlc_spinlock_destroy(self._l)
            self._lib = None
