"""Object and buffer pools.

Reference parity: ``include/dmlc/memory.h :: MemoryPool,
ThreadlocalSharedPtr`` (SURVEY.md §2a) — pooled allocation so hot loops
never hit the allocator.  The TPU-relevant reinterpretation is
:class:`BufferPool`: the host→device infeed path repeatedly needs
same-shaped numpy staging buffers, and reusing them keeps the host's
memory footprint flat and malloc out of the feed loop (an asynchronous
copy from a pinned buffer reads it after the call returns, so buffers are
only recycled when the caller proves the transfer is done — the same
recycle discipline ``ThreadedIter`` uses).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["MemoryPool", "BufferPool"]


class MemoryPool:
    """Fixed-type object pool: ``alloc()`` reuses released objects.

    ``factory`` makes a fresh object when the free list is empty;
    ``reset`` (optional) scrubs a released object before reuse.
    Thread-safe; unbounded unless ``max_free`` is given.
    """

    def __init__(self, factory: Callable[[], Any],
                 reset: Optional[Callable[[Any], None]] = None,
                 max_free: int = 0):
        self._factory = factory
        self._reset = reset
        self._max_free = max_free
        self._free: List[Any] = []
        self._lock = threading.Lock()
        self.allocated = 0          # total objects ever created

    def alloc(self) -> Any:
        with self._lock:
            if self._free:
                return self._free.pop()
            self.allocated += 1
        return self._factory()

    def free(self, obj: Any) -> None:
        if self._reset is not None:
            self._reset(obj)
        with self._lock:
            if self._max_free == 0 or len(self._free) < self._max_free:
                self._free.append(obj)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)


class BufferPool:
    """Pool of numpy arrays keyed by (shape, dtype) — infeed staging.

    ``take(shape, dtype)`` returns a (possibly recycled) C-contiguous
    array; ``give(arr)`` returns it to the pool.  Useful when a feed
    thread fills identical batches every step.
    """

    def __init__(self, max_free_per_key: int = 4):
        self._max = max_free_per_key
        self._free: Dict[Tuple[Tuple[int, ...], Any], List[np.ndarray]] = {}
        self._lock = threading.Lock()

    def take(self, shape: Tuple[int, ...], dtype: Any = np.float32) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype))
        with self._lock:
            lst = self._free.get(key)
            if lst:
                return lst.pop()
        return np.empty(shape, dtype)

    def give(self, arr: np.ndarray) -> None:
        key = (arr.shape, arr.dtype)
        with self._lock:
            lst = self._free.setdefault(key, [])
            if len(lst) < self._max:
                lst.append(arr)
