"""Retry/backoff policies and circuit breaking — the resilience layer.

dmlc-core's upstream value is that rabit-style recovery can TRUST the
substrate: a flaky object store, a restarting namenode or a briefly
overloaded serving frontend must look like latency, not like failure
(SURVEY.md §2b — the reference's S3/HDFS backends simply died on the
first bad round trip).  This module is the one place that policy lives:

* :class:`RetryPolicy` — bounded retries with exponential backoff and
  **full jitter** (each delay is uniform in ``[0, min(cap, base·2^k)]``,
  the AWS-recommended variant that decorrelates client herds), an
  overall deadline, a retryable-error predicate, and ``Retry-After``
  awareness (an exception carrying a ``retry_after`` attribute — e.g.
  :class:`~dmlc_core_tpu_torch.io.http_util.HttpError` from a 429/503 —
  overrides the computed backoff with the server's own hint).
* :class:`CircuitBreaker` — closed → open after N consecutive failures,
  half-open probe after a reset timeout; callers shed load instantly
  (:class:`CircuitOpenError`) instead of queueing doomed work.

Every knob is env-tunable (``DMLC_RETRY_MAX_ATTEMPTS``,
``DMLC_RETRY_DEADLINE_S``, ``DMLC_RETRY_BASE_S``,
``DMLC_RETRY_MAX_BACKOFF_S``, ``DMLC_CB_THRESHOLD``,
``DMLC_CB_RESET_S``) and every decision leaves evidence in
``base.metrics``: ``dmlc_retries_total{op}``,
``dmlc_retry_backoff_seconds{op}``, ``dmlc_retry_giveups_total{op}``,
``dmlc_circuit_state{circuit}`` (0 closed / 1 open / 2 half-open).

The policy re-raises the LAST failure unwrapped when it gives up, so
callers' exception contracts (``except HttpError: if e.status == 404``)
survive the retry layer unchanged.  See ``doc/robustness.md``.

This package's own copy of ``dmlc_core_tpu.base.resilience``: the
same policies, knobs and metric names.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, Dict, Optional, TypeVar

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.timer import get_time

__all__ = ["RetryPolicy", "CircuitBreaker", "CircuitOpenError"]

T = TypeVar("T")

_M = None


def _res_metrics() -> Dict[str, Any]:
    """Lazily declared instrument handles shared by every policy."""
    global _M
    if _M is None:
        r = _metrics.default_registry()
        _M = {
            "retries": r.counter(
                "retries_total",
                "retry attempts actually performed, by operation",
                labels=("op",)),
            "backoff": r.histogram(
                "retry_backoff_seconds",
                "backoff slept before each retry", labels=("op",)),
            "giveups": r.counter(
                "retry_giveups_total",
                "operations that exhausted their retry budget",
                labels=("op",)),
            "circuit": r.gauge(
                "circuit_state",
                "circuit breaker state (0 closed, 1 open, 2 half-open)",
                labels=("circuit",)),
            "circuit_opens": r.counter(
                "circuit_opens_total",
                "closed/half-open to open transitions",
                labels=("circuit",)),
        }
    return _M


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        LOG("WARNING", "resilience: bad %s=%r, using %s", name, raw, default)
        return default


class RetryPolicy:
    """Composable retry loop: exponential backoff + full jitter, attempt
    and deadline caps, a retryable-error predicate, Retry-After hints.

    ``sleep``/``rng`` are injectable so tests assert exact backoff
    sequences without wall time.  A policy object is immutable state +
    a reentrant :meth:`run`; one instance may serve many threads.
    """

    def __init__(self,
                 max_attempts: int = 4,
                 deadline_s: float = 60.0,
                 base_backoff_s: float = 0.05,
                 max_backoff_s: float = 5.0,
                 retry_after_cap_s: float = 30.0,
                 retryable: Optional[Callable[[BaseException], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        CHECK(max_attempts >= 1, f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = max_attempts
        self.deadline_s = deadline_s
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.retry_after_cap_s = retry_after_cap_s
        self.retryable = retryable
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()

    @classmethod
    def from_env(cls, **overrides: Any) -> "RetryPolicy":
        """Build a policy from the ``DMLC_RETRY_*`` env knobs; explicit
        keyword ``overrides`` win over the environment."""
        kw: Dict[str, Any] = {
            "max_attempts": int(_env_float("DMLC_RETRY_MAX_ATTEMPTS", 4)),
            "deadline_s": _env_float("DMLC_RETRY_DEADLINE_S", 60.0),
            "base_backoff_s": _env_float("DMLC_RETRY_BASE_S", 0.05),
            "max_backoff_s": _env_float("DMLC_RETRY_MAX_BACKOFF_S", 5.0),
        }
        kw.update(overrides)
        return cls(**kw)

    def backoff_for(self, attempt: int,
                    retry_after: Optional[float] = None) -> float:
        """Delay before retry number ``attempt`` (1-based).  Full jitter
        unless the server supplied ``retry_after`` (honored, capped)."""
        if retry_after is not None:
            return min(max(float(retry_after), 0.0), self.retry_after_cap_s)
        cap = min(self.max_backoff_s,
                  self.base_backoff_s * (2.0 ** (attempt - 1)))
        return self._rng.uniform(0.0, cap)

    def run(self, fn: Callable[[], T], op: str = "op",
            retryable: Optional[Callable[[BaseException], bool]] = None) -> T:
        """Call ``fn`` until it succeeds, the error is non-retryable, or
        the attempt/deadline budget is spent — then re-raise the last
        error unwrapped.  ``op`` labels the metrics series."""
        pred = retryable or self.retryable
        t0 = get_time()
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — predicate decides
                attempt += 1
                if pred is not None and not pred(e):
                    raise
                if attempt >= self.max_attempts:
                    if _metrics.enabled():
                        _res_metrics()["giveups"].inc(1, op=op)
                    raise
                delay = self.backoff_for(
                    attempt, getattr(e, "retry_after", None))
                if get_time() - t0 + delay > self.deadline_s:
                    if _metrics.enabled():
                        _res_metrics()["giveups"].inc(1, op=op)
                    raise
                if _metrics.enabled():
                    m = _res_metrics()
                    m["retries"].inc(1, op=op)
                    m["backoff"].observe(delay, op=op)
                if delay > 0:
                    self._sleep(delay)


class CircuitOpenError(RuntimeError):
    """Raised by :meth:`CircuitBreaker.call` while the circuit is open —
    the caller should shed the request, not queue it."""


class CircuitBreaker:
    """Consecutive-failure circuit: closed → open → half-open probe.

    ``failure_threshold`` consecutive failures open the circuit; while
    open every :meth:`call` raises :class:`CircuitOpenError` instantly.
    After ``reset_timeout_s`` ONE probe call is let through (half-open):
    success closes the circuit, failure re-opens it for another window.
    Thread-safe; state transitions are published on the
    ``dmlc_circuit_state{circuit}`` gauge.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, name: str = "default",
                 failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = get_time):
        CHECK(failure_threshold >= 1,
              f"failure_threshold must be >= 1, got {failure_threshold}")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._publish_locked()

    @classmethod
    def from_env(cls, name: str = "default", **overrides: Any
                 ) -> "CircuitBreaker":
        """Build a breaker from ``DMLC_CB_THRESHOLD`` /
        ``DMLC_CB_RESET_S``; keyword ``overrides`` win."""
        kw: Dict[str, Any] = {
            "failure_threshold": int(_env_float("DMLC_CB_THRESHOLD", 5)),
            "reset_timeout_s": _env_float("DMLC_CB_RESET_S", 30.0),
        }
        kw.update(overrides)
        return cls(name, **kw)

    def _publish_locked(self) -> None:
        """Export the state gauge; caller holds ``_lock`` (``__init__``
        runs pre-publication, which is the same happens-before)."""
        if _metrics.enabled():
            _res_metrics()["circuit"].set(self._GAUGE[self._state],
                                          circuit=self.name)

    @property
    def state(self) -> str:
        """Current state name (``closed`` / ``open`` / ``half_open``)."""
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self) -> None:
        """Open -> half-open once the reset window lapses; caller holds
        ``_lock``."""
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = self.HALF_OPEN
            self._probing = False
            self._publish_locked()

    def allow(self) -> bool:
        """May a request proceed right now?  (half-open admits ONE
        probe; concurrent callers beyond it are shed)"""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        """Report a successful call — closes a half-open circuit."""
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self._publish_locked()
                LOG("INFO", "circuit %s: closed", self.name)

    def record_failure(self) -> None:
        """Report a failed call — trips the circuit at the threshold and
        re-opens a failed half-open probe immediately."""
        with self._lock:
            self._failures += 1
            tripped = (self._state == self.HALF_OPEN
                       or self._failures >= self.failure_threshold)
            self._probing = False
            if tripped and self._state != self.OPEN:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._publish_locked()
                if _metrics.enabled():
                    _res_metrics()["circuit_opens"].inc(1, circuit=self.name)
                LOG("WARNING", "circuit %s: OPEN after %d failures "
                    "(reset in %.1fs)", self.name, self._failures,
                    self.reset_timeout_s)
            elif tripped:
                self._opened_at = self._clock()

    def call(self, fn: Callable[[], T]) -> T:
        """Run ``fn`` through the breaker: :class:`CircuitOpenError` when
        shedding, otherwise the call's own result/exception (recorded)."""
        if not self.allow():
            # self.state (not ._state): the raw read raced record_*
            raise CircuitOpenError(
                f"circuit {self.name!r} is {self.state}")
        try:
            out = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return out
