"""Distributed trace context: one request id across every process hop.

``utils/profiler.Tracer`` gives each process a private Chrome-trace
timeline; this module is the *correlation* layer that lets
``scripts/trace_collect.py`` stitch those timelines back into one story.
A :class:`TraceContext` is a W3C ``traceparent``-style triple —
``00-<32 hex trace id>-<16 hex span id>-01`` — generated once at the
edge of a request (serve client, bench driver, trainer round) and
propagated through every wire the repo speaks:

* HTTP: the ``X-Dmlc-Trace`` header (:data:`HTTP_HEADER`) through
  ``serve/client.py`` → ``serve/frontend.py`` → fleet router → replica;
* PS data plane: the optional ``trace`` header key (:data:`WIRE_KEY`)
  that ``parallel/ps/wire.send_msg`` stamps on every framed message
  (declared in ``base/wire_schemas.WIRE_FRAMING``);
* tracker line protocol: the same ``trace`` key on control cmds;
* process spawn: the ``DMLC_TRACE_CTX`` env overlay (:data:`ENV_KEY`)
  that ``launch/jobset.py`` injects into children.

The context rides thread-local state (``current()``), falling back to
``DMLC_TRACE_CTX`` so a launched child adopts its parent's trace with
zero code.  Everything here respects the ``DMLC_TRACE=0`` no-op
discipline: with tracing off, :func:`span` yields ``None`` without
generating ids, taking locks or touching the tracer.

This package's own copy of ``dmlc_core_tpu.base.tracectx``, over the
port's ``utils/profiler.py`` host tracer.  Of the wires above the port
speaks HTTP (``serve/client.py`` → ``serve/frontend.py``); the fleet
router, the PS data plane, the tracker and the JobSet launcher are not
ported yet, and the ``DMLC_TRACE_CTX`` overlay is read all the same.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
from typing import Any, Iterator, NamedTuple, Optional

from dmlc_core_tpu_torch.utils import profiler as _profiler

__all__ = [
    "TraceContext", "HTTP_HEADER", "WIRE_KEY", "ENV_KEY",
    "current", "current_header", "attach", "span", "decode",
]

#: HTTP request/response header carrying the encoded context.
HTTP_HEADER = "X-Dmlc-Trace"
#: JSON header key on tracker / PS-wire messages (see
#: ``base/wire_schemas.WIRE_FRAMING``).
WIRE_KEY = "trace"
#: Environment variable a launcher sets so children adopt the trace.
ENV_KEY = "DMLC_TRACE_CTX"

_ENCODED_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


class TraceContext(NamedTuple):
    """An immutable (trace id, span id) pair.

    ``trace_id`` names the whole distributed request; ``span_id`` names
    one operation within it.  ``encode()`` renders the wire form.
    """

    #: 32 lowercase hex chars shared by every span of one request
    trace_id: str
    #: 16 lowercase hex chars naming this hop's operation
    span_id: str

    def encode(self) -> str:
        """Wire encoding: ``00-<trace_id>-<span_id>-01``."""
        return f"00-{self.trace_id}-{self.span_id}-01"


def decode(encoded: str) -> Optional[TraceContext]:
    """Parse a wire-encoded context; ``None`` for anything malformed
    (a hostile or truncated header must degrade, never raise)."""
    if not encoded:
        return None
    m = _ENCODED_RE.match(encoded.strip().lower())
    if m is None:
        return None
    return TraceContext(m.group(1), m.group(2))


def _new_context(trace_id: Optional[str] = None) -> TraceContext:
    tid = trace_id if trace_id is not None else os.urandom(16).hex()
    return TraceContext(tid, os.urandom(8).hex())


_UNSET = object()
_tls = threading.local()


def _ambient() -> Optional[TraceContext]:
    """The process-ambient context a launcher handed us via env."""
    return decode(os.environ.get(ENV_KEY, ""))


def current() -> Optional[TraceContext]:
    """The calling thread's active context (``None`` when tracing is off
    or no trace reached this thread).  A thread that never attached one
    adopts the ``DMLC_TRACE_CTX`` env overlay — that single fallback is
    how a JobSet child lands inside its launcher's trace."""
    if not _profiler.tracing_enabled():
        return None
    ctx = getattr(_tls, "ctx", _UNSET)
    if ctx is _UNSET:
        ctx = _ambient()
        _tls.ctx = ctx
    return ctx


def current_header() -> Optional[str]:
    """``current()`` in wire form, or ``None`` — the one-liner carrier
    injection sites use."""
    ctx = current()
    return ctx.encode() if ctx is not None else None


@contextlib.contextmanager
def attach(encoded: Optional[str]) -> Iterator[Optional[TraceContext]]:
    """Adopt an inbound wire-encoded context for the calling thread.

    The server half of propagation: wrap request handling in
    ``with attach(header):`` and every :func:`span` inside joins the
    sender's trace.  Malformed/absent input (or tracing off) yields
    ``None`` and changes nothing; the previous context is restored on
    exit either way."""
    ctx = decode(encoded) if encoded else None
    if ctx is None or not _profiler.tracing_enabled():
        yield None
        return
    prev = getattr(_tls, "ctx", _UNSET)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        if prev is _UNSET:
            del _tls.ctx
        else:
            _tls.ctx = prev


@contextlib.contextmanager
def span(name: str, **args: Any) -> Iterator[Optional[TraceContext]]:
    """One traced operation: a child context of ``current()`` (or a
    brand-new trace at the edge) + a Tracer scope stamped with
    ``trace``/``span``/``parent`` ids so cross-process merges can follow
    the request.  Yields the new context — forward ``ctx.encode()`` on
    whatever wire the block writes.  With ``DMLC_TRACE=0`` this yields
    ``None`` and does no work at all."""
    if not _profiler.tracing_enabled():
        yield None
        return
    prev = current()
    ctx = _new_context(prev.trace_id if prev is not None else None)
    _tls.ctx = ctx
    try:
        with _profiler.global_tracer().scope(
                name, trace=ctx.trace_id, span=ctx.span_id,
                parent=prev.span_id if prev is not None else "", **args):
            yield ctx
    finally:
        _tls.ctx = prev
