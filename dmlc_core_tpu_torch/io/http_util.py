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

This package's own copy of ``dmlc_core_tpu.io.http_util``: the round trip
(``http_request``, ``HttpError``, the retry classification), the ranged
read and buffered write streams of the remote filesystems
(``io/*_filesys.py``) and the range probe.  Its users are those
filesystems, the serving client and the fleet's router, rollouts and
autoscale.  It builds its redirect-following opener once per process,
where the JAX module builds one per request (loading the CA store each
time: a serving round trip's floor there).
"""

from __future__ import annotations

import http.client
import socket
import urllib.error
import urllib.request
from typing import Callable, Dict, Optional, Tuple

from dmlc_core_tpu_torch.base import faultinject as _fi
from dmlc_core_tpu_torch.base.logging import log_fatal
from dmlc_core_tpu_torch.base.resilience import RetryPolicy
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream

__all__ = ["http_request", "HttpError", "RangedReadStream",
           "BufferedWriteStream", "default_http_policy"]

# sign(method, url, headers, payload) -> headers to actually send
SignFn = Callable[[str, str, Dict[str, str], bytes], Dict[str, str]]

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


def http_probe_range(url: str) -> bool:
    """Does the server honor Range requests?  Sends ``Range: bytes=0-0``
    and reads ONLY the status — never the body, so a Range-ignoring
    server's full-object 200 costs nothing.  416 (empty object) also
    proves the server parses Range."""
    req = urllib.request.Request(url, method="GET")
    req.add_header("Range", "bytes=0-0")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status in (206, 416)
    except urllib.error.HTTPError as e:
        return e.code == 416
    except urllib.error.URLError:
        return False


class RangedReadStream(SeekStream):
    """SeekStream over HTTP ranged GETs with a readahead buffer.

    ``url_fn()`` yields the object URL and ``sign`` (optional) produces
    per-request auth headers — each backend supplies its own.  Reads fetch
    ``max(want, readahead)`` bytes per round trip, mirroring the reference
    S3 stream's buffered reads.

    Truncation-safe: the object size is known up front, so a response
    shorter than requested (connection dropped mid-body, lossy proxy,
    ``stream:truncate`` fault injection) is not an error — the missing
    suffix is re-fetched with a fresh ranged request and ``read(n)``
    still returns exactly ``min(n, remaining)`` bytes.
    """

    def __init__(self, url: str, size: int, sign: Optional[SignFn] = None,
                 readahead: int = 1 << 20,
                 range_header: str = "Range"):
        self._url = url
        self._size = size
        self._sign = sign
        self._readahead = readahead
        self._range_header = range_header
        self._pos = 0
        self._buf = b""
        self._buf_start = 0

    def read(self, nbytes: int) -> bytes:
        if nbytes < 0:
            nbytes = self._size - self._pos
        nbytes = min(nbytes, self._size - self._pos)
        if nbytes <= 0:
            return b""
        # serve from buffer when possible
        boff = self._pos - self._buf_start
        if 0 <= boff < len(self._buf):
            out = self._buf[boff:boff + nbytes]
            self._pos += len(out)
            if len(out) == nbytes:
                return out
            return out + self.read(nbytes - len(out))
        fetch = min(max(nbytes, self._readahead), self._size - self._pos)
        data = self._fetch(self._pos, fetch)
        fault = _fi.check("stream", ctx=self._url)
        if fault is not None and fault.kind == "truncate" and len(data) > 1:
            data = data[:max(1, len(data) // 2)]
        if not data:
            log_fatal("RangedReadStream: empty ranged response")
        self._buf = data
        self._buf_start = self._pos
        out = data[:nbytes]
        self._pos += len(out)
        if len(out) < nbytes:
            # short body: re-fetch the missing suffix (progress is
            # guaranteed — an empty response above is fatal)
            return out + self.read(nbytes - len(out))
        return out

    def _fetch(self, pos: int, nbytes: int) -> bytes:
        """One ranged round trip — the only part backends override."""
        headers = {self._range_header: f"bytes={pos}-{pos + nbytes - 1}"}
        if self._sign is not None:
            headers = self._sign("GET", self._url, headers, b"")
        status, _, data = http_request("GET", self._url, headers,
                                       op="http_ranged_read")
        if status == 200 and len(data) > nbytes:
            # server ignored Range: slice what we asked for
            data = data[pos:pos + nbytes]
        return data

    def write(self, data: bytes) -> int:
        log_fatal("read-only stream")

    def seek(self, pos: int) -> None:
        self._pos = pos

    def tell(self) -> int:
        return self._pos


class BufferedWriteStream(Stream):
    """Write stream that buffers and commits on close (or streams parts).

    Subclasses override :meth:`_commit` (whole-object upload) and may
    override :meth:`_flush_part` to stream fixed-size parts (S3 multipart).
    ``part_size <= 0`` disables part streaming.
    """

    def __init__(self, part_size: int = 0):
        self._chunks: list = []
        self._buffered = 0
        self._part_size = part_size
        self._closed = False

    def read(self, nbytes: int) -> bytes:
        log_fatal("write-only stream")

    def write(self, data: bytes) -> int:
        self._chunks.append(bytes(data))
        self._buffered += len(data)
        if self._part_size > 0:
            while self._buffered >= self._part_size:
                blob = b"".join(self._chunks)
                part, rest = blob[:self._part_size], blob[self._part_size:]
                self._chunks = [rest] if rest else []
                self._buffered = len(rest)
                self._flush_part(part)
        return len(data)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._finish(b"".join(self._chunks))
        self._chunks = []

    def abort(self) -> None:
        """Discard buffered data without committing the object."""
        self._closed = True
        self._chunks = []

    def __exit__(self, exc_type, exc, tb) -> None:
        # an exception inside the `with` block must NOT publish a
        # truncated object — discard instead of committing partial parts
        if exc_type is not None:
            self.abort()
        else:
            self.close()

    # -- backend hooks ---------------------------------------------------
    def _flush_part(self, part: bytes) -> None:
        raise NotImplementedError

    def _finish(self, tail: bytes) -> None:
        self._commit(tail)

    def _commit(self, data: bytes) -> None:
        raise NotImplementedError
