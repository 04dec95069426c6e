"""Dynamic lock-order verifier (``DMLC_LOCKCHECK=1``).

This package's own copy of ``dmlc_core_tpu/base/lockcheck.py`` (the standard
library only), installed by ``dmlc_core_tpu_torch/__init__.py`` under
the same ``DMLC_*`` switch as the JAX package's.

The runtime counterpart of dmlcheck's static ``lock-discipline`` pass:
where the AST pass proves accesses stay *behind* locks, this module
proves the locks themselves are acquired in a consistent *order* across
threads — the property whose violation is a deadlock, which no amount
of single-threaded testing surfaces.

How: :func:`install` replaces ``threading.Lock`` / ``threading.RLock``
with factories returning a traced wrapper (locks created *before*
install are untouched).  Each wrapper records its creation site
(``file:line``) as its identity — one node per *site*, so every
``ConcurrentBlockingQueue`` instance maps to the same node and an
ordering observed on one instance constrains all of them (the
cross-instance generalization is what makes short tests predictive).
On every acquisition, an edge ``held-site -> acquired-site`` is added
to a process-wide digraph; a new edge that closes a directed cycle is a
lock-order violation, recorded (and raised from :func:`check`).
Self-edges (site -> itself) are skipped: two instances from one site
have no static order, and flagging them would condemn every per-series
metric lock.

Validation hook: the chaos-soak test installs this around its
train+serve+faults workload and asserts :func:`violations` stays empty
— and ``DMLC_LOCKCHECK=1`` turns it on for any process at import
(``dmlc_core_tpu_torch/__init__``).  Condition objects built on a traced lock
participate automatically (waits release and reacquire through the
wrapper).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

__all__ = ["LockOrderError", "install", "uninstall", "installed",
           "violations", "reset", "check", "add_listener",
           "remove_listener"]


class LockOrderError(RuntimeError):
    """A cross-thread lock-order cycle was observed."""


_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

#: guards the graph; a RAW lock so the verifier never traces itself
_graph_lock = _ORIG_LOCK()
_edges: Dict[str, Set[str]] = {}
#: (edge, thread) examples for reporting
_edge_info: Dict[Tuple[str, str], str] = {}
_violations: List[str] = []
_seen_cycles: Set[frozenset] = set()
_installed = False

#: observers of traced-lock transitions (``base/racecheck`` layers its
#: vector clocks on these). Protocol: ``on_acquire(lock, site)`` fires
#: AFTER the underlying acquire succeeds, ``on_release(lock, site)``
#: fires BEFORE the underlying release — so a happens-before listener
#: publishes the holder's state before any other thread can acquire.
_listeners: List[Any] = []

_tls = threading.local()


def add_listener(listener: Any) -> None:
    """Register a traced-lock observer (see ``_listeners``)."""
    if listener not in _listeners:
        _listeners.append(listener)


def remove_listener(listener: Any) -> None:
    """Remove a previously registered observer (no-op if absent)."""
    if listener in _listeners:
        _listeners.remove(listener)


def _held() -> List[str]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = []
        _tls.held = h
    return h


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS: a path src -> ... -> dst in the edge graph, or None."""
    stack = [(src, [src])]
    visited = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in visited:
                visited.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquire(site: str) -> None:
    held = _held()
    if held:
        tname = threading.current_thread().name
        with _graph_lock:
            for h in set(held):
                if h == site or site in _edges.get(h, ()):
                    continue
                # adding h -> site: a pre-existing site -> ... -> h path
                # means both orders have now been observed — a cycle
                path = _find_path(site, h)
                _edges.setdefault(h, set()).add(site)
                _edge_info[(h, site)] = tname
                if path is not None:
                    cyc = path + [site]
                    key = frozenset(cyc)
                    if key not in _seen_cycles:
                        _seen_cycles.add(key)
                        legs = " -> ".join(cyc)
                        owners = ", ".join(
                            f"{a}->{b} on {_edge_info.get((a, b), '?')}"
                            for a, b in zip(cyc, cyc[1:]))
                        _violations.append(
                            f"lock-order cycle: {legs} (edges: {owners})")
    held.append(site)


def _note_release(site: str) -> None:
    held = _held()
    # remove the most recent acquisition of this site (LIFO typical,
    # but out-of-order release is legal for raw acquire/release)
    for i in range(len(held) - 1, -1, -1):
        if held[i] == site:
            del held[i]
            return


class _TracedLock:
    """Wraps one plain Lock; quacks enough for ``with``, Condition's
    plain-lock fallback, and raw acquire/release call sites.

    NOTE: ``__getattr__`` delegates unknown attributes to the inner
    lock, so ``hasattr(lock, '_release_save')`` stays False here (the
    inner plain lock has none) and Condition takes its acquire/release
    fallback — which routes through the traced methods."""

    __slots__ = ("_inner", "_site")

    def __init__(self, inner: Any, site: str) -> None:
        self._inner = inner
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquire(self._site)
            for lst in _listeners:
                lst.on_acquire(self, self._site)
        return ok

    def release(self) -> None:
        for lst in _listeners:
            lst.on_release(self, self._site)
        self._inner.release()
        _note_release(self._site)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TracedLock {self._site} {self._inner!r}>"

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)


class _TracedRLock(_TracedLock):
    """RLock variant: defines the Condition protocol ON THE CLASS so
    Condition binds the traced versions (``__getattr__`` delegation
    would hand it the inner RLock's methods and waits would release
    invisibly)."""

    __slots__ = ()

    def _release_save(self) -> Any:
        # Condition.wait drops the monitor: that IS a release for
        # happens-before purposes, so listeners fire first (publish,
        # then let waiters in)
        for lst in _listeners:
            lst.on_release(self, self._site)
        state = self._inner._release_save()
        # a reentrant owner held this site k times; wait() drops them all
        held = _held()
        k = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self._site:
                del held[i]
                k += 1
        return (state, k)

    def _acquire_restore(self, state: Any) -> None:
        inner_state, k = state
        self._inner._acquire_restore(inner_state)
        held = _held()
        held.extend([self._site] * k)
        for lst in _listeners:
            lst.on_acquire(self, self._site)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def _site_of_caller() -> str:
    f = sys._getframe(2)
    fn = f.f_code.co_filename
    # repo-relative where possible: stable across checkouts
    for marker in ("dmlc_core_tpu_torch", "tests", "scripts"):
        idx = fn.find(os.sep + marker + os.sep)
        if idx >= 0:
            fn = fn[idx + 1:]
            break
    return f"{fn}:{f.f_lineno}"


def _lock_factory() -> _TracedLock:
    return _TracedLock(_ORIG_LOCK(), _site_of_caller())


def _rlock_factory() -> _TracedRLock:
    return _TracedRLock(_ORIG_RLOCK(), _site_of_caller())


def install() -> None:
    """Start tracing: locks created from here on are order-checked.
    Idempotent."""
    global _installed
    if _installed:
        return
    threading.Lock = _lock_factory          # type: ignore[assignment]
    threading.RLock = _rlock_factory        # type: ignore[assignment]
    _installed = True


def uninstall() -> None:
    """Stop tracing (existing traced locks keep working — they only
    stop growing the graph once released and re-created)."""
    global _installed
    if not _installed:
        return
    threading.Lock = _ORIG_LOCK             # type: ignore[assignment]
    threading.RLock = _ORIG_RLOCK           # type: ignore[assignment]
    _installed = False


def installed() -> bool:
    """True while the factories are patched in."""
    return _installed


def violations() -> List[str]:
    """Every distinct lock-order cycle observed so far."""
    with _graph_lock:
        return list(_violations)


def reset() -> None:
    """Clear the graph and violation history (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _edge_info.clear()
        _violations.clear()
        _seen_cycles.clear()


def check() -> None:
    """Raise :class:`LockOrderError` if any cycle was observed."""
    v = violations()
    if v:
        raise LockOrderError("; ".join(v))


def env_enabled() -> bool:
    """The ``DMLC_LOCKCHECK`` import-time gate."""
    return os.environ.get("DMLC_LOCKCHECK", "0").lower() in (
        "1", "true", "on", "yes", "raise")
