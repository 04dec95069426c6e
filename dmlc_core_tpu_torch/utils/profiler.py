"""Tracing & profiling — a strict superset of the reference's timing story.

The reference's only primitive is ``include/dmlc/timer.h :: GetTime()``
(SURVEY.md §5: "tracing/profiling: essentially none").  The TPU substrate
owes more: step time vs infeed stall is THE number that decides whether
the host pipeline (ThreadedIter → device_put) keeps the chip busy.  This
module provides

* :class:`Tracer` — a dependency-free host-side event tracer writing
  Chrome ``chrome://tracing`` / Perfetto JSON, so host pipeline phases
  (read, parse, device_put, step) can be eyeballed against each other
  without TensorBoard.

All host events go through ``base.timer.get_time`` so Tracer timestamps
line up with the rest of the framework's timing.

Hot-path integration (PR: observability substrate): the instrumented
pipelines (ThreadedIter, parsers, collectives, the GBT engines) emit
scopes/instants to :func:`global_tracer` ONLY while host tracing is
switched on (:func:`set_tracing` / ``DMLC_TRACE=1``) — tracing is
event-per-item and unbounded-ish in volume, so unlike the aggregate
metrics layer (``base.metrics``) it defaults OFF.  The Tracer buffer is
capped (``max_events``) so a scope left enabled for a long run degrades
to dropped events, never to unbounded host memory.

This package's own copy of the host side of ``dmlc_core_tpu.utils.profiler``
(:class:`Tracer`, :func:`global_tracer`, the tracing switch), which the
data plane's copies emit into; the JAX package's device-trace helpers
(``device_trace``, ``annotate``, ``step_annotation``, over
``jax.profiler``) have no counterpart here yet.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from dmlc_core_tpu_torch.base.timer import get_time

__all__ = ["Tracer", "global_tracer", "tracing_enabled", "set_tracing"]

_TRACING = os.environ.get("DMLC_TRACE", "0").lower() in ("1", "true", "on",
                                                         "yes")


def tracing_enabled() -> bool:
    """Fast global switch read by hot-path call sites before they touch
    :func:`global_tracer` — one global read + branch when off."""
    return _TRACING


def set_tracing(on: bool) -> None:
    """Enable/disable host-event tracing process-wide (also:
    ``DMLC_TRACE=1``)."""
    global _TRACING
    _TRACING = bool(on)


class Tracer:
    """Host-side event tracer → Chrome/Perfetto trace JSON.

    >>> tr = Tracer()
    >>> with tr.scope("parse"):
    ...     ...
    >>> tr.counter("queue_depth", 3)
    >>> tr.save("/tmp/trace.json")   # open in chrome://tracing / Perfetto

    Thread-safe; events carry real thread ids so producer/consumer
    overlap (the ThreadedIter pipeline) is visible on separate rows.
    The buffer is bounded: past ``max_events`` new events are dropped
    (and counted — ``dropped`` rides into the saved trace's metadata)
    rather than growing host memory without limit.
    """

    def __init__(self, max_events: int = 200_000) -> None:
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        # _t0 (monotonic) timestamps events; _wall0 is the SAME instant
        # on the wall clock, so cross-process merges (trace_collect) can
        # line shards up on a shared epoch despite per-process _t0s
        self._t0 = get_time()
        self._wall0 = time.time()
        self._max_events = max_events
        self.dropped = 0
        #: process identity stamped into saved traces (set_meta)
        self.role = ""
        self.rank = -1

    def set_meta(self, role: Optional[str] = None,
                 rank: Optional[int] = None) -> None:
        """Stamp this process's fleet identity (role/rank) into every
        subsequent :meth:`save` — the Perfetto ``process_name`` row and
        the merge metadata ``trace_collect`` keys shards by."""
        with self._lock:
            if role is not None:
                self.role = str(role)
            if rank is not None:
                self.rank = int(rank)

    def _us(self) -> float:
        return (get_time() - self._t0) * 1e6

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    @contextlib.contextmanager
    def scope(self, name: str, **args: Any) -> Iterator[None]:
        """A complete ("X") duration event on the calling thread's row."""
        start = self._us()
        try:
            yield
        finally:
            end = self._us()
            self._append({
                "name": name, "ph": "X", "ts": start,
                "dur": end - start, "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": args or {},
            })

    def instant(self, name: str, **args: Any) -> None:
        self._append({
            "name": name, "ph": "i", "ts": self._us(), "s": "t",
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args or {},
        })

    def counter(self, name: str, value: float, series: str = "value") -> None:
        self._append({
            "name": name, "ph": "C", "ts": self._us(),
            "pid": os.getpid(), "args": {series: value},
        })

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    @staticmethod
    def _metadata_events(events: List[Dict[str, Any]], role: str,
                         rank: int) -> List[Dict[str, Any]]:
        """Chrome-trace "M" metadata rows: without them, two processes'
        traces opened together in Perfetto are indistinguishable."""
        pid = os.getpid()
        pname = (f"{role}-{rank}" if role else "process")
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{pname} pid={pid}"},
        }]
        tids = {ev["tid"] for ev in events if "tid" in ev}
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid in sorted(tids):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": names.get(tid, f"thread-{tid}")},
            })
        return meta

    def save(self, path: str) -> str:
        with self._lock:
            events = list(self._events)
            payload: Dict[str, Any] = {
                "traceEvents": self._metadata_events(
                    events, self.role, self.rank) + events,
                "displayTimeUnit": "ms",
                "otherData": {
                    "dropped_events": self.dropped,
                    "epoch_us": self._wall0 * 1e6,
                    "pid": os.getpid(),
                    "role": self.role,
                    "rank": self.rank,
                },
            }
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


_global: Optional[Tracer] = None
_global_lock = threading.Lock()


def global_tracer() -> Tracer:
    """Process-wide Tracer (created on first use)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = Tracer()
        return _global
