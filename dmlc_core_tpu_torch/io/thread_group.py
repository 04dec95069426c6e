"""Managed named-thread group with shutdown signaling.

Reference parity: ``include/dmlc/thread_group.h :: ThreadGroup,
ThreadGroup::Thread, request_shutdown_all()`` (SURVEY.md §2a).  The
reference manages named std::threads whose lifecycle is owned by a group
object so a consumer (e.g. an engine with many worker loops) can launch,
enumerate, signal and join them as a unit.  Same contract here on
``threading.Thread``; the launched callables receive a
:class:`ShutdownEvent` they must poll (the Pythonic spelling of the
reference's per-thread shutdown request).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK

__all__ = ["ThreadGroup", "ShutdownEvent"]


class ShutdownEvent:
    """Cooperative shutdown flag handed to every group thread.

    ``requested`` flips to True after ``request_shutdown_all``; loops
    should poll it (or ``wait(timeout)`` instead of sleeping).
    """

    def __init__(self) -> None:
        self._ev = threading.Event()

    @property
    def requested(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)

    def _set(self) -> None:
        self._ev.set()


class _GroupThread:
    """One named, managed thread (reference: ThreadGroup::Thread)."""

    def __init__(self, name: str, target: Callable[[ShutdownEvent], None],
                 daemon: bool = True):
        self.name = name
        self.shutdown = ShutdownEvent()
        self.exc: Optional[BaseException] = None

        def _run() -> None:
            try:
                target(self.shutdown)
            except BaseException as e:  # noqa: BLE001 — surfaced via join
                self.exc = e

        self._thread = threading.Thread(target=_run, name=name, daemon=daemon)

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def is_alive(self) -> bool:
        return self._thread.is_alive()


class ThreadGroup:
    """Launch/enumerate/signal/join a set of named worker threads.

    >>> grp = ThreadGroup()
    >>> grp.create("worker-0", lambda sd: ...)   # target polls sd.requested
    >>> grp.request_shutdown_all()
    >>> grp.join_all()

    ``join_all`` re-raises the first exception any thread died with, so
    worker failures are not silently swallowed (mirrors the exception_ptr
    discipline of the reference's ThreadedIter-style components).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._threads: Dict[str, _GroupThread] = {}

    def create(self, name: str, target: Callable[[ShutdownEvent], None],
               daemon: bool = True) -> _GroupThread:
        """Create AND start a named thread; names must be unique."""
        with self._lock:
            CHECK(name not in self._threads,
                  f"ThreadGroup: duplicate thread name {name!r}")
            t = _GroupThread(name, target, daemon=daemon)
            # start before publishing: a concurrent join_all must never see
            # an unstarted thread (Thread.join would raise RuntimeError)
            t.start()
            self._threads[name] = t
        return t

    def get(self, name: str) -> Optional[_GroupThread]:
        with self._lock:
            return self._threads.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._threads)

    def size(self) -> int:
        with self._lock:
            return len(self._threads)

    def request_shutdown_all(self) -> None:
        with self._lock:
            threads = list(self._threads.values())
        for t in threads:
            t.shutdown._set()

    def join_all(self, timeout: Optional[float] = None) -> List[str]:
        """Join every thread; ``timeout`` bounds the TOTAL wait (one shared
        deadline, not per-thread).  Returns the names of threads still alive
        at the deadline (empty list = clean join); re-raises the first
        worker exception."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads.values())
        still_alive: List[str] = []
        for t in threads:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            t.join(remaining)
            if t.is_alive():
                still_alive.append(t.name)
        for t in threads:
            if t.exc is not None:
                raise t.exc
        return still_alive

    def __enter__(self) -> "ThreadGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.request_shutdown_all()
        self.join_all()
