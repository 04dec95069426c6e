"""Logging and assertion layer.

Reference parity: ``include/dmlc/logging.h :: LOG(severity), CHECK*,
CHECK_NOTNULL, dmlc::Error, LogMessage/LogMessageFatal`` (SURVEY.md §2a).

This package's own copy of ``dmlc_core_tpu.base.logging`` (the PyTorch
port imports nothing of the JAX package).

Design notes:

* Fatal checks raise :class:`Error` (the reference's ``DMLC_LOG_FATAL_THROW=1``
  behaviour, which is what every DMLC consumer uses in practice).  There is no
  abort() mode — an exception that unwinds through the Python frame is
  strictly more useful than a core dump.
* ``LOG`` routes through a standard :mod:`logging` logger named ``"dmlc"`` so
  host applications can redirect/format it (the reference's
  ``DMLC_LOG_CUSTOMIZE`` hook generalised).
* CHECK macros become functions: host-side control checks.  A CHECK on a
  device tensor's value synchronises with the device, so keep them out of
  per-level loops.
"""

from __future__ import annotations

import logging as _pylogging
import sys
import traceback
from typing import Any, NoReturn, Optional, TypeVar

__all__ = [
    "Error",
    "LOG",
    "LogMessage",
    "CHECK",
    "CHECK_EQ",
    "CHECK_NE",
    "CHECK_LT",
    "CHECK_GT",
    "CHECK_LE",
    "CHECK_GE",
    "CHECK_NOTNULL",
    "log_fatal",
    "set_log_level",
    "get_logger",
]

T = TypeVar("T")


class Error(RuntimeError):
    """Exception thrown by fatal checks.

    Reference parity: ``dmlc::Error`` (include/dmlc/logging.h).  Carries an
    optional captured stack trace like ``DMLC_LOG_STACK_TRACE``.
    """

    def __init__(self, message: str, stack_trace: Optional[str] = None):
        self.stack_trace = stack_trace
        super().__init__(message)


_logger = _pylogging.getLogger("dmlc")
if not _logger.handlers:  # default handler: stderr, glog-ish format
    _handler = _pylogging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        _pylogging.Formatter("[%(asctime)s] %(levelname)s %(filename)s:%(lineno)d: %(message)s")
    )
    _logger.addHandler(_handler)
    _logger.setLevel(_pylogging.INFO)

_LEVELS = {
    "DEBUG": _pylogging.DEBUG,
    "INFO": _pylogging.INFO,
    "WARNING": _pylogging.WARNING,
    "ERROR": _pylogging.ERROR,
    "FATAL": _pylogging.CRITICAL,
}


def get_logger() -> _pylogging.Logger:
    """Return the shared ``"dmlc"`` logger (the DMLC_LOG_CUSTOMIZE hook)."""
    return _logger


def set_log_level(level: str) -> None:
    """Set the minimum severity, one of DEBUG/INFO/WARNING/ERROR/FATAL."""
    _logger.setLevel(_LEVELS[level.upper()])


def _capture_stack(skip: int = 2) -> str:
    return "".join(traceback.format_stack()[: -skip or None])


def log_fatal(message: str) -> NoReturn:
    """Log at FATAL severity and raise :class:`Error`.

    Reference parity: ``dmlc::LogMessageFatal`` with ``DMLC_LOG_FATAL_THROW``.
    """
    stack = _capture_stack()
    _logger.critical(message, stacklevel=3)
    raise Error(message, stack_trace=stack)


def LOG(severity: str, message: str, *args: Any) -> None:
    """``LOG(INFO/WARNING/ERROR/FATAL, msg)``.  FATAL raises :class:`Error`."""
    severity = severity.upper()
    if severity == "FATAL":
        log_fatal(message % args if args else message)
    if severity not in _LEVELS:
        raise Error(f"unknown log severity {severity!r}; valid: {sorted(_LEVELS)}")
    _logger.log(_LEVELS[severity], message, *args, stacklevel=2)


class LogMessage:
    """Stream-style log message, for code that prefers the C++ idiom::

        with LogMessage("INFO") as log:
            log << "read " << n << " records"
    """

    def __init__(self, severity: str = "INFO"):
        self._severity = severity.upper()
        self._parts: list[str] = []

    def __lshift__(self, other: Any) -> "LogMessage":
        self._parts.append(str(other))
        return self

    def __enter__(self) -> "LogMessage":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            LOG(self._severity, "".join(self._parts))


def _fail(op: str, lhs: Any, rhs: Any, msg: str) -> NoReturn:
    detail = f"Check failed: {lhs!r} {op} {rhs!r}"
    if msg:
        detail += f": {msg}"
    log_fatal(detail)


def CHECK(cond: Any, msg: str = "") -> None:
    """Fatal unless ``cond`` is truthy.  Reference: ``CHECK(x)``."""
    if not cond:
        log_fatal(f"Check failed: {msg or cond!r}")


def CHECK_EQ(lhs: Any, rhs: Any, msg: str = "") -> None:
    """Fatal unless ``lhs == rhs`` (reference ``CHECK_EQ``); the failure
    message prints both operands."""
    if not (lhs == rhs):
        _fail("==", lhs, rhs, msg)


def CHECK_NE(lhs: Any, rhs: Any, msg: str = "") -> None:
    """Fatal unless ``lhs != rhs`` (reference ``CHECK_NE``)."""
    if not (lhs != rhs):
        _fail("!=", lhs, rhs, msg)


def CHECK_LT(lhs: Any, rhs: Any, msg: str = "") -> None:
    """Fatal unless ``lhs < rhs`` (reference ``CHECK_LT``)."""
    if not (lhs < rhs):
        _fail("<", lhs, rhs, msg)


def CHECK_GT(lhs: Any, rhs: Any, msg: str = "") -> None:
    """Fatal unless ``lhs > rhs`` (reference ``CHECK_GT``)."""
    if not (lhs > rhs):
        _fail(">", lhs, rhs, msg)


def CHECK_LE(lhs: Any, rhs: Any, msg: str = "") -> None:
    """Fatal unless ``lhs <= rhs`` (reference ``CHECK_LE``)."""
    if not (lhs <= rhs):
        _fail("<=", lhs, rhs, msg)


def CHECK_GE(lhs: Any, rhs: Any, msg: str = "") -> None:
    """Fatal unless ``lhs >= rhs`` (reference ``CHECK_GE``)."""
    if not (lhs >= rhs):
        _fail(">=", lhs, rhs, msg)


def CHECK_NOTNULL(value: Optional[T], msg: str = "") -> T:
    """Fatal if ``value`` is None; returns it otherwise (chainable like C++)."""
    if value is None:
        log_fatal(f"Check notnull failed: {msg}")
    return value
