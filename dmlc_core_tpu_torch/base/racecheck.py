"""Vector-clock happens-before race detector (``DMLC_RACECHECK=1``).

This package's own copy of ``dmlc_core_tpu/base/racecheck.py`` (the standard
library only), installed by ``dmlc_core_tpu_torch/__init__.py`` under
the same ``DMLC_*`` switch as the JAX package's.

Third layer of the concurrency suite: dmlcheck's ``lock-discipline`` /
``atomicity`` passes prove locking *shape* statically, ``lockcheck``
proves lock *order* dynamically — this module proves the absence of
**data races**: two accesses to the same attribute from different
threads, at least one a write, with no happens-before path between
them.  Unlike lockcheck it does not care which lock you used, only
whether *some* synchronization orders the pair — so it also blesses
handoffs through queues, events and thread start/join.

Mechanics (FastTrack-style, full vector clocks for simplicity):

* every thread carries a vector clock in thread-local storage;
* happens-before edges come from the traced-sync vocabulary:

  - ``Lock`` / ``RLock`` / ``Condition`` — via the listener hooks on
    :mod:`~dmlc_core_tpu_torch.base.lockcheck`'s traced wrappers (install
    pulls lockcheck in; ``Condition.wait`` releases and reacquires
    through the same hooks, which also covers
    ``ConcurrentBlockingQueue`` push→pop handoffs);
  - ``Event`` — ``set()`` publishes the setter's clock, ``wait()`` /
    a true ``is_set()`` joins it (flag handoffs become visible order);
  - ``Thread.start`` / ``Thread.join`` — fork and join edges
    (construction in the parent happens-before everything in the
    child; the child's writes happen-before a successful join).

* attribute reads/writes are only tracked on **opt-in** classes
  (decorated with :func:`instrument_class`: the tracker, router,
  batcher, autoscaler, registry and ``ConcurrentBlockingQueue``), only
  for single-underscore instance attributes, and never for values that
  are themselves synchronizers.  A class exempts deliberately
  lock-free attributes via ``_racecheck_exempt`` (the registry's
  ``_current`` hot-path pointer), with the same rationale-comment duty
  as a dmlcheck suppression.

Each race is reported once per (class, attr, kind, stack pair) with
BOTH short stacks.  ``check()`` raises; the chaos drills call it and
archive :func:`write_report` JSON.  Identity caveat: sync objects and
instrumented instances are keyed by ``id()`` — collectible locks could
in principle alias after gc, which may *miss* (never fabricate) an
edge; the drill-scoped objects here live for the whole run.
"""

from __future__ import annotations

import _thread
import itertools
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["RaceError", "install", "uninstall", "installed",
           "instrument_class", "races", "reset", "check",
           "write_report", "env_enabled"]


class RaceError(RuntimeError):
    """At least one data race (unordered conflicting access pair) was
    observed."""


_ORIG_EVENT = threading.Event
_ORIG_THREAD_START = threading.Thread.start
_ORIG_THREAD_JOIN = threading.Thread.join

#: guards every shared table below; a RAW interpreter lock, immune to
#: lockcheck's factory patching regardless of import order
_state_lock = _thread.allocate_lock()

_enabled = False
_we_installed_lockcheck = False
_tls = threading.local()
_thread_idx = itertools.count(1)

#: id(sync object) -> last published vector clock
_sync_clocks: Dict[int, Dict[int, int]] = {}
#: id(Thread) -> the thread's final clock (published as its run() exits)
_final_clocks: Dict[int, Dict[int, int]] = {}
#: (id(obj), attr) -> {"write": epoch|None, "reads": {idx: epoch}}
#: where epoch = (thread idx, clock value, short stack)
_accesses: Dict[Tuple[int, str], Dict[str, Any]] = {}
_races: List[Dict[str, Any]] = []
_seen_races: set = set()
_tracked_access_count = 0

#: classes opted in via the decorator (instrumented on install)
_TARGETS: List[type] = []
#: cls -> (orig __getattribute__, orig __setattr__) for uninstall
_applied: Dict[type, Tuple[Any, Any]] = {}
_exempt_cache: Dict[type, frozenset] = {}


# -- vector clocks ----------------------------------------------------------

def _my_state() -> Tuple[int, Dict[int, int]]:
    """(thread index, clock) for the calling thread.

    MUST NOT call ``threading.current_thread()``: during thread
    bootstrap (3.10 sets ``_started`` before registering in
    ``_active``) that fabricates a ``_DummyThread`` whose ``__init__``
    sets another traced Event — infinite recursion.  The fork edge is
    instead seeded into TLS by ``_rc_run`` inside the child itself."""
    idx = getattr(_tls, "idx", None)
    if idx is None:
        idx = next(_thread_idx)
        _tls.idx = idx
        _tls.clock = {idx: 1}
    return idx, _tls.clock


def _join_into(clock: Dict[int, int], other: Dict[int, int]) -> None:
    for k, v in other.items():
        if v > clock.get(k, 0):
            clock[k] = v


def _publish(obj: Any) -> None:
    """Release-side edge: store my clock on ``obj``, then advance my
    own component so later accesses are NOT covered by it."""
    idx, clock = _my_state()
    with _state_lock:
        stored = _sync_clocks.setdefault(id(obj), {})
        _join_into(stored, clock)
    clock[idx] = clock.get(idx, 0) + 1


def _acquire_from(obj: Any) -> None:
    """Acquire-side edge: join whatever was last published on ``obj``."""
    _, clock = _my_state()
    with _state_lock:
        stored = _sync_clocks.get(id(obj))
        if stored:
            _join_into(clock, stored)


# -- sync-vocabulary hooks --------------------------------------------------

class _LockListener:
    """Bridges lockcheck's traced Lock/RLock/Condition transitions into
    happens-before edges."""

    def on_acquire(self, lock: Any, site: str) -> None:
        if _enabled:
            _acquire_from(lock)

    def on_release(self, lock: Any, site: str) -> None:
        if _enabled:
            _publish(lock)


_listener = _LockListener()


class _TracedEvent(_ORIG_EVENT):
    """Event whose set→wait (and set→true-is_set) pairs are HB edges —
    the synchronization a ``closed``/``done`` flag actually provides."""

    def set(self) -> None:  # noqa: A003 — stdlib name
        if _enabled:
            _publish(self)
        _ORIG_EVENT.set(self)

    def wait(self, timeout: Optional[float] = None) -> bool:
        ok = _ORIG_EVENT.wait(self, timeout)
        if ok and _enabled:
            _acquire_from(self)
        return ok

    def is_set(self) -> bool:
        ok = _ORIG_EVENT.is_set(self)
        if ok and _enabled:
            _acquire_from(self)
        return ok


def _traced_start(self: threading.Thread) -> None:
    if _enabled:
        idx, clock = _my_state()
        parent_snap = dict(clock)       # the fork edge
        clock[idx] = clock.get(idx, 0) + 1
        orig_run = self.run

        def _rc_run() -> None:
            # runs IN the child: seed its clock with the parent's
            # snapshot (construction happens-before everything here)
            cidx, child_clock = _my_state()
            _join_into(child_clock, parent_snap)
            child_clock[cidx] = child_clock.get(cidx, 0) + 1
            try:
                orig_run()
            finally:
                with _state_lock:
                    _final_clocks[id(self)] = dict(child_clock)

        self.run = _rc_run  # type: ignore[method-assign]
    _ORIG_THREAD_START(self)


def _traced_join(self: threading.Thread,
                 timeout: Optional[float] = None) -> None:
    _ORIG_THREAD_JOIN(self, timeout)
    if _enabled and not self.is_alive():
        _, clock = _my_state()
        with _state_lock:
            final = _final_clocks.get(id(self))
        if final:
            _join_into(clock, final)


# -- attribute instrumentation ----------------------------------------------

def _sync_value(value: Any) -> bool:
    """True for values that ARE synchronizers (or threads/timers) —
    reading the reference is not reading shared data."""
    from dmlc_core_tpu_torch.base import lockcheck as _lc

    return isinstance(value, (_lc._TracedLock, threading.Condition,
                              _ORIG_EVENT, threading.Thread))


def _exempt_for(cls: type) -> frozenset:
    ex = _exempt_cache.get(cls)
    if ex is None:
        ex = frozenset(getattr(cls, "_racecheck_exempt", ()))
        _exempt_cache[cls] = ex
    return ex


def _site(depth: int) -> str:
    """Up to three repo-relative ``file:line(func)`` frames above the
    instrumentation — the 'stack' half of a race report."""
    frames = []
    try:
        f: Any = sys._getframe(depth)
    except ValueError:
        return "<unknown>"
    while f is not None and len(frames) < 3:
        fn = f.f_code.co_filename
        for marker in ("dmlc_core_tpu_torch", "tests", "scripts"):
            i = fn.find(os.sep + marker + os.sep)
            if i >= 0:
                fn = fn[i + 1:]
                break
        frames.append(f"{fn}:{f.f_lineno}({f.f_code.co_name})")
        f = f.f_back
    return " <- ".join(frames)


def _report(cls_name: str, attr: str, kind: str,
            prior: Tuple[int, int, str], cur: Tuple[int, int, str]) -> None:
    key = (cls_name, attr, kind, prior[2], cur[2])
    if key in _seen_races:
        return
    _seen_races.add(key)
    _races.append({
        "class": cls_name, "attr": attr, "kind": kind,
        "prior": {"thread": prior[0], "stack": prior[2]},
        "current": {"thread": cur[0], "stack": cur[2]},
    })


def _record(obj: Any, attr: str, is_write: bool) -> None:
    global _tracked_access_count
    idx, clock = _my_state()
    site = _site(3)
    epoch = (idx, clock.get(idx, 0), site)
    cls_name = type(obj).__name__
    key = (id(obj), attr)

    def _ordered(e: Tuple[int, int, str]) -> bool:
        return e[1] <= clock.get(e[0], 0)

    with _state_lock:
        _tracked_access_count += 1
        st = _accesses.get(key)
        if st is None:
            st = _accesses[key] = {"write": None, "reads": {}}
        w = st["write"]
        if is_write:
            if w is not None and w[0] != idx and not _ordered(w):
                _report(cls_name, attr, "write-write", w, epoch)
            for ridx, r in st["reads"].items():
                if ridx != idx and not _ordered(r):
                    _report(cls_name, attr, "read-write", r, epoch)
            st["write"] = epoch
            st["reads"] = {}
        else:
            if w is not None and w[0] != idx and not _ordered(w):
                _report(cls_name, attr, "write-read", w, epoch)
            st["reads"][idx] = epoch


def _tracked(obj: Any, name: str) -> bool:
    return (_enabled and name.startswith("_")
            and not name.startswith("__")
            and name not in _exempt_for(type(obj)))


def _apply(cls: type) -> None:
    if cls in _applied:
        return
    orig_get = cls.__getattribute__
    orig_set = cls.__setattr__

    def __getattribute__(self: Any, name: str) -> Any:
        value = orig_get(self, name)
        if _tracked(self, name) and not _sync_value(value):
            # class-level lookups (methods, defaults) are not instance
            # state — only instance-dict hits are shared data
            if name in orig_get(self, "__dict__"):
                _record(self, name, is_write=False)
        return value

    def __setattr__(self: Any, name: str, value: Any) -> None:
        if _tracked(self, name) and not _sync_value(value):
            _record(self, name, is_write=True)
        orig_set(self, name, value)

    cls.__getattribute__ = __getattribute__  # type: ignore[assignment]
    cls.__setattr__ = __setattr__            # type: ignore[assignment]
    _applied[cls] = (orig_get, orig_set)


def instrument_class(cls: type) -> type:
    """Class decorator: opt ``cls``'s ``self._*`` attributes into race
    tracking.  Free when racecheck is disabled (the decorator only
    registers); instrumented lazily on :func:`install`."""
    if cls not in _TARGETS:
        _TARGETS.append(cls)
    if _enabled:
        _apply(cls)
    return cls


# -- lifecycle --------------------------------------------------------------

def install() -> None:
    """Enable tracking: pulls in lockcheck (HB via traced locks), hooks
    Event/Thread, instruments every opted-in class.  Idempotent."""
    global _enabled, _we_installed_lockcheck
    if _enabled:
        return
    from dmlc_core_tpu_torch.base import lockcheck

    if not lockcheck.installed():
        lockcheck.install()
        _we_installed_lockcheck = True
    lockcheck.add_listener(_listener)
    threading.Event = _TracedEvent            # type: ignore[misc]
    threading.Thread.start = _traced_start    # type: ignore[method-assign]
    threading.Thread.join = _traced_join      # type: ignore[method-assign]
    _enabled = True
    for cls in _TARGETS:
        _apply(cls)


def uninstall() -> None:
    """Disable tracking and restore every patched class/hook.
    Idempotent."""
    global _enabled, _we_installed_lockcheck
    if not _enabled:
        return
    from dmlc_core_tpu_torch.base import lockcheck

    _enabled = False
    lockcheck.remove_listener(_listener)
    if _we_installed_lockcheck:
        lockcheck.uninstall()
        _we_installed_lockcheck = False
    threading.Event = _ORIG_EVENT             # type: ignore[misc]
    threading.Thread.start = _ORIG_THREAD_START  # type: ignore
    threading.Thread.join = _ORIG_THREAD_JOIN    # type: ignore
    for cls, (orig_get, orig_set) in _applied.items():
        cls.__getattribute__ = orig_get       # type: ignore[assignment]
        cls.__setattr__ = orig_set            # type: ignore[assignment]
    _applied.clear()


def installed() -> bool:
    """True while racecheck is actively tracking."""
    return _enabled


def races() -> List[Dict[str, Any]]:
    """Every distinct race observed so far (class, attr, kind, both
    stacks)."""
    with _state_lock:
        return [dict(r) for r in _races]


def reset() -> None:
    """Clear access history and race reports (test isolation).  Thread
    clocks survive — they only ever merge forward."""
    with _state_lock:
        _accesses.clear()
        _races.clear()
        _seen_races.clear()
        _sync_clocks.clear()
        _final_clocks.clear()
        global _tracked_access_count
        _tracked_access_count = 0


def check() -> None:
    """Raise :class:`RaceError` if any race was observed."""
    r = races()
    if r:
        lines = [f"{x['class']}.{x['attr']} [{x['kind']}] "
                 f"prior={x['prior']['stack']} "
                 f"current={x['current']['stack']}" for x in r]
        raise RaceError(f"{len(r)} data race(s): " + "; ".join(lines))


def write_report(path: str) -> Dict[str, Any]:
    """Archive the race report as JSON (the chaos drills' artifact);
    returns the report dict."""
    with _state_lock:
        report = {
            "enabled": _enabled,
            "tracked_accesses": _tracked_access_count,
            "instrumented_classes": sorted(
                c.__name__ for c in _applied or _TARGETS),
            "races": [dict(r) for r in _races],
        }
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    return report


def env_enabled() -> bool:
    """The ``DMLC_RACECHECK`` import-time gate."""
    return os.environ.get("DMLC_RACECHECK", "0").lower() in (
        "1", "true", "on", "yes", "raise")
