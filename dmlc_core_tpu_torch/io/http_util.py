"""Shared HTTP plumbing for remote filesystem backends (S3/WebHDFS/Azure/GCS).

The reference's remote backends (``src/io/s3_filesys.cc`` etc., SURVEY.md
§2b) are libcurl-based; here the transport is stdlib ``urllib`` so the
backends work with zero extra dependencies, and every backend is testable
against an in-process fake server via its ``*_ENDPOINT`` env override.

Resilience (doc/robustness.md): every round trip runs under a
:class:`~dmlc_core_tpu_torch.base.resilience.RetryPolicy` — 408/429/5xx
statuses and (for idempotent requests) connection resets/timeouts are
retried with full-jitter backoff, honoring ``Retry-After``.  Methods
GET/HEAD/PUT/DELETE are idempotent by default; POST callers opt in per
call site (S3 initiate-multipart yes, WebHDFS APPEND data no — an
ambiguous transport failure there could double-append).  Status-level
errors are retried for ALL methods: the server answered, so it did not
apply the request.  The ``http`` / ``stream`` fault-injection points
(``base.faultinject``) sit on this path, which is how the chaos tests
prove the whole URI stack survives a lossy wire bit-identically.

This package's own copy of ``dmlc_core_tpu.io.http_util``'s round trip
(``http_request``, ``HttpError``, the retry classification), whose users
here are the serving client and the fleet's router, rollouts and
autoscale.  It builds its redirect-following opener once per process,
where the JAX module builds one per request (loading the CA store
each time: a serving round trip's floor there).  The JAX module's ranged-read and buffered
write streams come with the remote filesystem backends that use them
(ROADMAP item 18).
"""

from __future__ import annotations

import http.client
import socket
import urllib.error
import urllib.request
from typing import Dict, Optional, Tuple

from dmlc_core_tpu_torch.base import faultinject as _fi
from dmlc_core_tpu_torch.base.resilience import RetryPolicy

__all__ = ["http_request", "HttpError", "default_http_policy"]

#: statuses that mean "try again" regardless of method: the server
#: answered without applying the request
_RETRYABLE_STATUSES = (408, 429)

#: ambiguous transport failures — request may or may not have been
#: applied, so only idempotent requests retry these
_TRANSPORT_ERRORS = (ConnectionError, TimeoutError, socket.timeout,
                     http.client.HTTPException, urllib.error.URLError)

_IDEMPOTENT_METHODS = ("GET", "HEAD", "PUT", "DELETE")


class HttpError(IOError):
    def __init__(self, status: int, url: str, body: bytes = b"",
                 retry_after: Optional[float] = None):
        # strip the query string: it can carry credentials (Azure SAS sig=,
        # WebHDFS user.name) that must not leak into logs/tracebacks
        safe_url = url.split("?", 1)[0]
        super().__init__(f"HTTP {status} for {safe_url}: {body[:200]!r}")
        self.status = status
        self.body = body
        #: server's Retry-After hint in seconds (None when absent) —
        #: RetryPolicy.run reads this attribute to override its backoff
        self.retry_after = retry_after


class _NoRedirect(urllib.request.HTTPErrorProcessor):
    """Leave 3xx responses to the caller (WebHDFS two-step writes)."""

    def http_response(self, request, response):  # noqa: N802
        return response

    https_response = http_response


_opener = urllib.request.build_opener(_NoRedirect)

#: the redirect-following opener, built once on first use: building one
#: (``build_opener()``: its HTTPS handler loads the CA store) costs more
#: than a local round trip, which the JAX package pays on every request
_follow_opener: Optional[urllib.request.OpenerDirector] = None


def _redirecting_opener() -> urllib.request.OpenerDirector:
    global _follow_opener
    if _follow_opener is None:
        _follow_opener = urllib.request.build_opener()
    return _follow_opener


def _parse_retry_after(hdrs: Dict[str, str]) -> Optional[float]:
    raw = hdrs.get("retry-after")
    if raw is None:
        return None
    try:
        return max(0.0, float(raw))
    except ValueError:
        return None  # HTTP-date form: treat as "no usable hint"


def default_http_policy() -> RetryPolicy:
    """The retry policy remote round trips run under — rebuilt from the
    ``DMLC_RETRY_*`` env knobs on every call so tests and operators can
    retune without restarting (a policy build is ~4 env reads, noise
    next to a network round trip)."""
    return RetryPolicy.from_env()


def _retryable_status(status: int) -> bool:
    return status in _RETRYABLE_STATUSES or 500 <= status < 600


def http_request(
    method: str,
    url: str,
    headers: Optional[Dict[str, str]] = None,
    body: bytes = b"",
    ok: Tuple[int, ...] = (200, 201, 204, 206),
    follow_redirects: bool = True,
    retry: Optional[RetryPolicy] = None,
    idempotent: Optional[bool] = None,
    op: Optional[str] = None,
) -> Tuple[int, Dict[str, str], bytes]:
    """One logical HTTP round trip → (status, lowercase headers, body),
    with policy-driven retries on retryable failures.

    Raises :class:`HttpError` for statuses outside ``ok`` (redirects are
    returned, not raised, when ``follow_redirects`` is False).  ``retry``
    overrides the env-tuned default policy (pass a 1-attempt policy to
    disable); ``idempotent`` overrides the method-based default (GET/
    HEAD/PUT/DELETE retry ambiguous transport errors, POST does not) —
    retryable *statuses* (408/429/5xx) are retried for every method.
    ``op`` labels the ``dmlc_retries_total`` series (default
    ``http_<method>``).
    """
    method = method.upper()
    if idempotent is None:
        idempotent = method in _IDEMPOTENT_METHODS
    policy = retry if retry is not None else default_http_policy()
    opname = op or f"http_{method.lower()}"

    def _attempt() -> Tuple[int, Dict[str, str], bytes]:
        fault = _fi.check("http", ctx=f"{method} {url}")
        if fault is not None:
            if fault.kind == "reset":
                raise ConnectionResetError(
                    f"fault injected: connection reset ({method} {url.split('?', 1)[0]})")
            if fault.kind == "error":
                raise HttpError(fault.int_value(503), url,
                                b"fault injected", retry_after=0.0)
        req = urllib.request.Request(url, data=body if body else None,
                                     method=method)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        opener = _redirecting_opener() if follow_redirects else _opener
        try:
            with opener.open(req, timeout=60) as resp:
                status = resp.status
                hdrs = {k.lower(): v for k, v in resp.headers.items()}
                data = resp.read()
        except urllib.error.HTTPError as e:  # raised by the default opener
            status = e.code
            hdrs = {k.lower(): v for k, v in e.headers.items()}
            data = e.read()
        if status in ok or (not follow_redirects and 300 <= status < 400):
            return status, hdrs, data
        raise HttpError(status, url, data,
                        retry_after=_parse_retry_after(hdrs))

    def _retryable(e: BaseException) -> bool:
        if isinstance(e, HttpError):
            return _retryable_status(e.status)
        if isinstance(e, _TRANSPORT_ERRORS):
            return idempotent
        return False

    return policy.run(_attempt, op=opname, retryable=_retryable)
