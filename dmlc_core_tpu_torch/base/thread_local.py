"""Per-thread singleton store.

Reference parity: ``include/dmlc/thread_local.h :: ThreadLocalStore<T>``
(SURVEY.md §2a) — lazily constructs one instance of a type per thread and
keeps a registry so instances can be enumerated/cleared (the reference
uses this for per-thread scratch buffers and error strings).
``threading.local`` alone loses the registry, so this keeps one — keyed
weakly by the Thread object and pruned of dead threads, so a long-lived
process spawning short-lived workers doesn't pin their scratch instances
forever, and OS thread-id reuse can't alias entries.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Generic, List, Tuple, TypeVar

__all__ = ["ThreadLocalStore"]

T = TypeVar("T")


class ThreadLocalStore(Generic[T]):
    """``store.get()`` → this thread's lazily-created instance.

    >>> store = ThreadLocalStore(list)
    >>> store.get() is store.get()        # same object within a thread
    True
    """

    def __init__(self, factory: Callable[[], T]):
        self._factory = factory
        self._local = threading.local()
        self._lock = threading.Lock()
        self._registry: "weakref.WeakKeyDictionary[threading.Thread, T]" = (
            weakref.WeakKeyDictionary()
        )

    def get(self) -> T:
        try:
            return self._local.value
        except AttributeError:
            value = self._factory()
            self._local.value = value
            with self._lock:
                self._registry[threading.current_thread()] = value
            return value

    def instances(self) -> List[Tuple[str, T]]:
        """(thread name, instance) for every *live* thread that called get()."""
        with self._lock:
            return [
                (th.name, value)
                for th, value in list(self._registry.items())
                if th.is_alive()
            ]

    def clear(self) -> None:
        """Drop the registry (existing threads re-create on next get())."""
        with self._lock:
            self._registry = weakref.WeakKeyDictionary()
        self._local = threading.local()
