"""Process-resource leak tracer (``DMLC_LEAKCHECK=1``).

This package's own copy of ``dmlc_core_tpu/base/leakcheck.py`` (the standard
library only), installed by ``dmlc_core_tpu_torch/__init__.py`` under
the same ``DMLC_*`` switch as the JAX package's.

Sixth layer of the verification suite: dmlcheck's ``resource-leak`` /
``thread-lifecycle`` passes prove acquisition *shape* statically — this
module proves the dynamic half: at drill exit, **zero** repo-created
sockets, threads, subprocesses or tempfiles are still live.  A leaked
server socket keeps a port wedged for the next drill, an unjoined
thread can segfault interpreter teardown, an unwaited child is a
zombie the CI host accumulates — exactly the rot that long-lived
tracker/PS/fleet processes die of in production.

Mechanics — creation hooks only, liveness evaluated lazily:

* ``socket.socket`` is replaced by a recording subclass (``accept``,
  ``create_connection`` and ``socketpair`` all construct through the
  module global, so accepted connections are traced too);
* ``threading.Thread.start``, ``subprocess.Popen.__init__``,
  ``tempfile.NamedTemporaryFile`` and ``tempfile.mkstemp`` are wrapped
  to record each creation.

Every record keeps a short repo-relative creation stack; creations
whose stack never touches this repo (jax compile pools, stdlib
internals) are ignored.  Nothing hooks the release side — ``leaks()``
asks each recorded object whether it is *still* live: a socket whose
``_closed`` is false, a thread that ``is_alive()``, a ``Popen`` whose
``returncode`` was never reaped (an exited-but-unwaited child — a
zombie — stays live on purpose), an unclosed ``NamedTemporaryFile``,
an ``mkstemp`` fd that still fstats to the inode it was created as.

The CI drills install this next to lockcheck/racecheck, archive
:func:`write_report` JSON (``*_LEAKCHECK_OUT``) and gate GREEN on
:func:`check`; each detected leak also increments the
``dmlc_leaks_detected_total`` counter by resource kind.  When the env
gate is off nothing is patched — creation paths run at full speed.
"""

from __future__ import annotations

import _thread
import os
import socket as _socket_mod
import subprocess as _subprocess_mod
import sys
import tempfile as _tempfile_mod
import threading
from typing import Any, Dict, List, Optional

__all__ = ["LeakError", "install", "uninstall", "installed", "leaks",
           "reset", "check", "write_report", "env_enabled"]

_KINDS = ("socket", "thread", "subprocess", "tempfile")


class LeakError(RuntimeError):
    """At least one repo-created resource was still live at check()."""


#: guards the record table; a RAW interpreter lock, immune to
#: lockcheck's factory patching regardless of import order
_state_lock = _thread.allocate_lock()

_enabled = False
#: id(obj) -> record dict; strong refs on purpose — a resource that was
#: never explicitly released must not escape detection via gc
_records: Dict[int, Dict[str, Any]] = {}
_created_count: Dict[str, int] = {k: 0 for k in _KINDS}

#: originals captured at install() time (NOT import time) so the hooks
#: chain correctly with racecheck's Thread.start tracing
_saved: Dict[str, Any] = {}


def _repo_site(depth: int) -> Optional[str]:
    """Up to three repo-relative ``file:line(func)`` frames above the
    hook, or ``None`` when the creation never passes through this repo
    (third-party resources are not ours to police)."""
    frames: List[str] = []
    try:
        f: Any = sys._getframe(depth)
    except ValueError:
        return None
    hops = 0
    while f is not None and len(frames) < 3 and hops < 30:
        fn = f.f_code.co_filename
        if fn == __file__:                  # our own hooks are not a site
            f = f.f_back
            hops += 1
            continue
        for marker in ("dmlc_core_tpu_torch", "tests", "scripts"):
            i = fn.find(os.sep + marker + os.sep)
            if i >= 0:
                frames.append(f"{fn[i + 1:]}:{f.f_lineno}"
                              f"({f.f_code.co_name})")
                break
        f = f.f_back
        hops += 1
    return " <- ".join(frames) if frames else None


def _record(kind: str, obj: Any, detail: str, depth: int,
            extra: Optional[Dict[str, Any]] = None) -> None:
    site = _repo_site(depth)
    if site is None:
        return
    rec = {"kind": kind, "detail": detail, "site": site, "obj": obj}
    if extra:
        rec.update(extra)
    with _state_lock:
        _created_count[kind] += 1
        _records[id(obj)] = rec


# -- liveness (lazy, per kind) ----------------------------------------------

def _live(rec: Dict[str, Any]) -> bool:
    kind, obj = rec["kind"], rec["obj"]
    if kind == "socket":
        return not getattr(obj, "_closed", True)
    if kind == "thread":
        return bool(obj.is_alive())
    if kind == "subprocess":
        # returncode (NOT poll()): poll() would reap the zombie we are
        # here to report — an exited child nobody waited stays a leak
        return obj.returncode is None
    if kind == "tempfile":
        fd = rec.get("fd")
        if fd is None:                       # NamedTemporaryFile wrapper
            return not getattr(obj, "closed", True)
        try:
            st = os.fstat(fd)
        except OSError:
            return False
        # fd numbers are recycled: only the original inode counts
        return (st.st_dev, st.st_ino) == rec["stat"]
    return False


# -- creation hooks ---------------------------------------------------------

class _TracedSocket(_socket_mod.socket):
    """Socket subclass recording its creation site.  ``accept()``/
    ``create_connection``/``dup()`` construct via the module global or
    ``self.__class__`` — accepted and duped sockets are traced too."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        if _enabled:
            _record("socket", self, "socket", depth=2)


def _traced_thread_start(self: threading.Thread, *a: Any, **kw: Any) -> Any:
    if _enabled:
        _record("thread", self,
                f"thread {self.name!r}"
                f"{' daemon' if self.daemon else ''}", depth=2)
    return _saved["thread_start"](self, *a, **kw)


def _traced_popen_init(self: Any, *a: Any, **kw: Any) -> None:
    _saved["popen_init"](self, *a, **kw)
    if _enabled:
        args = a[0] if a else kw.get("args")
        _record("subprocess", self, f"Popen pid={self.pid} "
                f"argv={str(args)[:120]}", depth=2)


def _traced_ntf(*a: Any, **kw: Any) -> Any:
    f = _saved["ntf"](*a, **kw)
    if _enabled:
        _record("tempfile", f, f"NamedTemporaryFile {f.name}", depth=2)
    return f


def _traced_mkstemp(*a: Any, **kw: Any) -> Any:
    fd, path = _saved["mkstemp"](*a, **kw)
    if _enabled:
        try:
            st = os.fstat(fd)
            _record("tempfile", path, f"mkstemp fd={fd} {path}", depth=2,
                    extra={"fd": fd, "stat": (st.st_dev, st.st_ino)})
        except OSError:
            pass
    return fd, path


# -- lifecycle --------------------------------------------------------------

def install() -> None:
    """Patch the creation vocabulary and start recording.  Idempotent.
    Originals are captured here (not at import) so the Thread hook
    chains with whatever racecheck already installed."""
    global _enabled
    if _enabled:
        return
    _saved["socket_cls"] = _socket_mod.socket
    _saved["thread_start"] = threading.Thread.start
    _saved["popen_init"] = _subprocess_mod.Popen.__init__
    _saved["ntf"] = _tempfile_mod.NamedTemporaryFile
    _saved["mkstemp"] = _tempfile_mod.mkstemp
    if _saved["socket_cls"] is not _TracedSocket:
        _socket_mod.socket = _TracedSocket       # type: ignore[misc]
    threading.Thread.start = _traced_thread_start  # type: ignore
    _subprocess_mod.Popen.__init__ = _traced_popen_init  # type: ignore
    _tempfile_mod.NamedTemporaryFile = _traced_ntf  # type: ignore
    _tempfile_mod.mkstemp = _traced_mkstemp      # type: ignore[assignment]
    _enabled = True


def uninstall() -> None:
    """Stop recording and restore every patched hook.  Idempotent."""
    global _enabled
    if not _enabled:
        return
    _enabled = False
    _socket_mod.socket = _saved["socket_cls"]    # type: ignore[misc]
    threading.Thread.start = _saved["thread_start"]  # type: ignore
    _subprocess_mod.Popen.__init__ = _saved["popen_init"]  # type: ignore
    _tempfile_mod.NamedTemporaryFile = _saved["ntf"]  # type: ignore
    _tempfile_mod.mkstemp = _saved["mkstemp"]    # type: ignore[assignment]
    _saved.clear()


def installed() -> bool:
    """True while leakcheck is actively recording creations."""
    return _enabled


def leaks() -> List[Dict[str, Any]]:
    """Every recorded resource that is STILL live right now, each with
    kind, detail and creation stack."""
    with _state_lock:
        recs = list(_records.values())
    return [{"kind": r["kind"], "detail": r["detail"], "site": r["site"]}
            for r in recs if _live(r)]


def reset() -> None:
    """Forget every recorded creation (test isolation)."""
    with _state_lock:
        _records.clear()
        for k in _KINDS:
            _created_count[k] = 0


def check() -> None:
    """Raise :class:`LeakError` when any recorded resource is still
    live; bumps ``dmlc_leaks_detected_total`` per leak by kind."""
    found = leaks()
    if not found:
        return
    from dmlc_core_tpu_torch.base import metrics as _metrics

    if _metrics.enabled():
        c = _metrics.default_registry().counter(
            "leaks_detected_total",
            "live leaked resources found by leakcheck at drill exit, "
            "by resource kind (socket|thread|subprocess|tempfile)",
            labels=("kind",))
        for x in found:
            c.inc(1, kind=x["kind"])
    lines = [f"{x['kind']}: {x['detail']} created at {x['site']}"
             for x in found]
    raise LeakError(f"{len(found)} leaked resource(s): " + "; ".join(lines))


def write_report(path: str) -> Dict[str, Any]:
    """Archive the leak report as JSON (the drills' ``*_LEAKCHECK_OUT``
    artifact); returns the report dict."""
    import json

    with _state_lock:
        created = dict(_created_count)
    report = {"enabled": _enabled, "created": created, "leaks": leaks()}
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    return report


def env_enabled() -> bool:
    """The ``DMLC_LEAKCHECK`` import-time gate."""
    return os.environ.get("DMLC_LEAKCHECK", "0").lower() in (
        "1", "true", "on", "yes", "raise")
