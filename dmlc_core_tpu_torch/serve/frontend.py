"""Stdlib-sockets HTTP/JSON serving frontend.

Same socket idioms as ``tracker/tracker.py``'s RabitTracker: bind an
ephemeral TCP port, a daemon accept-loop thread with a short accept
timeout (so shutdown is prompt), one daemon thread per connection.  The
protocol is minimal HTTP/1.1 (one request per connection,
``Connection: close``) because the payloads are small JSON bodies and
the hard problems — batching, admission control, hot-swap — live behind
the socket, not in it.

The socket plumbing is factored into :class:`HttpServer` so the fleet
tier (``serve.fleet.router.FleetRouter``, the replica admin surface)
reuses one audited request loop instead of three copies of it.

Routes:

* ``POST /predict`` — body ``{"rows": [[...], ...]}`` (one request may
  carry several rows).  Rows are submitted to the shared
  :class:`~dmlc_core_tpu_torch.serve.batcher.DynamicBatcher`; the response is
  ``{"predictions": [...], "version": v}`` where ``v`` is the model
  version that executed the batch.  A full queue answers **503**
  immediately (admission control with ``Retry-After``), an expired
  request **504**, a malformed body **400**.
* ``POST /drain`` — stop admitting new predicts (503 + ``Retry-After``)
  while in-flight and queued requests finish; ``/healthz`` flips to
  ``draining``.  This is the zero-downtime retire path: a router stops
  sending traffic on the health flip, then the process exits clean.
* ``GET /healthz`` — liveness + current model version + queue depth +
  in-flight request count.
* ``GET /metrics`` — Prometheus text exposition of the process-wide
  registry (``base.metrics.default_registry``): every serve instrument
  plus whatever training/io metrics the process has recorded.

Instrumentation per request: ``serve_requests_total{path, code}``,
end-to-end latency ``serve_request_seconds{path}``, and on success the
per-model-version counter ``serve_version_requests_total{version}``.

This package's own copy of ``dmlc_core_tpu.serve.frontend``: the same
routes (``/predict``, ``/drain``, ``/healthz``, ``/metrics``), codes (400,
503 with ``Retry-After``, 504) and ``base.faultinject`` hook.
``tenants=`` takes the port's ``serve.tenancy.TenantRegistry``: a
predict with the ``X-Dmlc-Tenant`` header runs on that tenant's runner
(paged in when it was evicted), on the registry's device.  The fleet
tier (``serve.fleet``) reuses :class:`HttpServer` for its router and
subclasses :class:`ServeFrontend` for its replicas.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import faultinject as _fi
from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base import tracectx as _tracectx
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.serve.batcher import (BatcherClosedError, DynamicBatcher,
                                         QueueFullError)
from dmlc_core_tpu_torch.serve.instruments import serve_metrics
from dmlc_core_tpu_torch.serve.registry import ModelRegistry

__all__ = ["HttpServer", "ServeFrontend", "TENANT_HEADER"]

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 408: "Request Timeout",
            429: "Too Many Requests", 500: "Internal Server Error",
            502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}

#: request header carrying the tenant namespace a predict belongs to;
#: set by clients, honored by the router (admission + routing key) and
#: by replicas (tenant-registry dispatch) — doc/serving.md
TENANT_HEADER = "X-Dmlc-Tenant"

#: request-body cap — a predict batch of max_batch × a few thousand
#: features in JSON stays far below this; anything bigger is abuse
_MAX_BODY = 64 << 20


class HttpServer:
    """Minimal threaded HTTP/1.1 server over raw stdlib sockets.

    One request per connection (``Connection: close``), a daemon accept
    loop with a short timeout so :meth:`close` is prompt, one daemon
    thread per connection — the RabitTracker socket idioms, packaged.
    Subclasses implement :meth:`_route` (and optionally
    :meth:`_observe` for per-request instrumentation).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 name: str = "http"):
        self.name = name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conn_lock = threading.Lock()
        self._conn_threads: List[threading.Thread] = []

    @property
    def url(self) -> str:
        """Base URL clients should hit (host:port resolved at bind)."""
        return f"http://{self.host}:{self.port}"

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "HttpServer":
        """Begin accepting connections (idempotent)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._accept_loop, daemon=True,
                name=f"http-{self.name}")
            self._thread.start()
            LOG("INFO", "serve.http %s: listening on %s", self.name,
                self.url)
        return self

    def close(self) -> None:
        """Stop accepting, join the accept loop, then reap connection
        threads (each finishes its one request) with a bounded wait."""
        self._done.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        with self._conn_lock:
            conn_threads = list(self._conn_threads)
            self._conn_threads.clear()
        for t in conn_threads:
            t.join(timeout=2.0)

    def __enter__(self) -> "HttpServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- hooks -----------------------------------------------------------
    def _route(self, method: str, path: str, body: bytes,
               headers: Optional[Dict[str, str]] = None
               ) -> Tuple[int, Any, str, Dict[str, str]]:
        """Handle one request → ``(code, payload, content_type,
        extra_headers)``; ``payload`` is JSON-dumped unless bytes.
        ``headers`` are the request headers, lowercased."""
        return 404, {"error": f"no route {path}"}, "application/json", {}

    def _observe(self, path: str, code: int, seconds: float) -> None:
        """Per-request instrumentation hook (default: none)."""

    # -- socket plumbing (tracker.py idioms) -----------------------------
    def _accept_loop(self) -> None:
        while not self._done.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            with self._conn_lock:
                self._conn_threads = [x for x in self._conn_threads
                                      if x.is_alive()]
                self._conn_threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        t0 = get_time()
        path = "?"
        code = 500
        try:
            parsed = self._read_request(conn)
            if parsed is None:
                return
            method, path, req_headers, body = parsed
            # join the caller's distributed trace (X-Dmlc-Trace) and
            # wrap the whole handler in this hop's span; the context is
            # echoed back so clients can correlate responses.  All of
            # this is a no-op when DMLC_TRACE is off.
            inbound = req_headers.get(_tracectx.HTTP_HEADER.lower(), "")
            with _tracectx.attach(inbound):
                with _tracectx.span(f"http.{path}",
                                    server=self.name) as ctx:
                    code, payload, ctype, headers = self._route(
                        method, path, body, req_headers)
                    if ctx is not None:
                        headers = dict(headers)
                        headers[_tracectx.HTTP_HEADER] = ctx.encode()
            self._respond(conn, code, payload, ctype, headers)
        except Exception:  # noqa: BLE001 — client went away / raw-socket
            pass           # garbage: nothing useful to answer
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if path != "?":
                self._observe(path, code, get_time() - t0)

    @staticmethod
    def _read_request(conn: socket.socket
                      ) -> Optional[Tuple[str, str, Dict[str, str],
                                          bytes]]:
        conn.settimeout(10.0)
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = conn.recv(65536)
            if not chunk:
                return None
            data += chunk
            CHECK(len(data) < _MAX_BODY, "request headers too large")
        head, _, body = data.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        CHECK(len(parts) >= 2, f"malformed request line {lines[0]!r}")
        method, target = parts[0].upper(), parts[1]
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", "0"))
        CHECK(0 <= length < _MAX_BODY, f"bad content-length {length}")
        while len(body) < length:
            chunk = conn.recv(min(65536, length - len(body)))
            if not chunk:
                break
            body += chunk
        return method, target.split("?", 1)[0], headers, body

    @staticmethod
    def _respond(conn: socket.socket, code: int, payload: Any,
                 ctype: str, headers: Dict[str, str]) -> None:
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        extra = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        head = (f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"{extra}Connection: close\r\n\r\n")
        conn.sendall(head.encode("latin-1") + body)


class ServeFrontend(HttpServer):
    """HTTP face of a :class:`ModelRegistry` + :class:`DynamicBatcher`.

    The frontend owns the batcher; its execute hook resolves
    ``registry.current()`` ONCE per batch, so a hot-swap lands between
    batches and in-flight work finishes on the version it started on.
    """

    def __init__(self, registry: ModelRegistry,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 1024, max_delay: float = 0.002,
                 max_queue: int = 256, request_timeout: float = 30.0,
                 tenants: Optional[Any] = None):
        super().__init__(host=host, port=port, name=registry.name)
        self.registry = registry
        #: optional TenantRegistry (serve.tenancy) — requests carrying
        #: the X-Dmlc-Tenant header resolve through it instead of the
        #: default registry; None answers such requests with 400
        self.tenants = tenants
        self.request_timeout = request_timeout
        self._batcher = DynamicBatcher(
            self._execute, max_batch=max_batch, max_delay=max_delay,
            max_queue=max_queue, name=registry.name)
        #: drain flag: set → new predicts are shed with 503 while queued
        #: and in-flight work completes (Event: atomic, no lock needed)
        self._draining = threading.Event()
        self._inflight_lock = threading.Lock()
        self._inflight = 0

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "ServeFrontend":
        """Begin accepting connections (idempotent)."""
        super().start()
        return self

    def drain(self) -> None:
        """Stop admitting new predicts (they answer 503 + Retry-After);
        queued and in-flight requests keep executing.  ``/healthz``
        reports ``draining`` so routers take this replica out of
        rotation before :meth:`close` retires it."""
        if not self._draining.is_set():
            self._draining.set()
            LOG("INFO", "serve.frontend %s: draining (queue depth %d, "
                "inflight %d)", self.registry.name,
                self._batcher.depth(), self.inflight())

    def inflight(self) -> int:
        """Predict requests currently inside the frontend (accepted but
        not yet answered) — the in-flight work :meth:`close` waits on."""
        with self._inflight_lock:
            return self._inflight

    def close(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Graceful shutdown: stop admitting (drain mode), stop
        accepting connections, flush the batcher, then wait for every
        in-flight response to go out before returning.
        ``drain=False`` aborts queued requests instead of finishing
        them (their futures get :class:`BatcherClosedError`)."""
        if drain:
            self.drain()
        super().close()
        self._batcher.close(drain=drain)
        # batcher futures are resolved; connection threads may still be
        # serializing responses — bounded wait so "close then exit"
        # cannot cut a response mid-write
        deadline = get_time() + timeout
        while self.inflight() > 0 and get_time() < deadline:
            self._done.wait(0.01)

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- batch execution -------------------------------------------------
    def _execute(self, X: np.ndarray):
        version, runner = self.registry.current()
        return runner.predict(X), version

    def _observe(self, path: str, code: int, seconds: float) -> None:
        if _metrics.enabled():
            # clamp unknown paths to one label value — client-chosen
            # URLs must not mint unbounded metric series
            p = (path if path in ("/predict", "/healthz", "/metrics",
                                  "/drain")
                 else "other")
            m = serve_metrics()
            m["requests"].inc(1, path=p, code=str(code))
            m["e2e"].observe(seconds, path=p)

    # -- routing ---------------------------------------------------------
    def _route(self, method: str, path: str, body: bytes,
               headers: Optional[Dict[str, str]] = None
               ) -> Tuple[int, Any, str, Dict[str, str]]:
        if path == "/predict":
            if method != "POST":
                return (405, {"error": "POST only"},
                        "application/json", {})
            with self._inflight_lock:
                self._inflight += 1
            try:
                return self._handle_predict(body, headers)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
        if path == "/drain":
            if method != "POST":
                return (405, {"error": "POST only"},
                        "application/json", {})
            self.drain()
            return (200, {"status": "draining",
                          "queue_depth": self._batcher.depth(),
                          "inflight": self.inflight()},
                    "application/json", {})
        if path == "/healthz":
            return 200, self._health(), "application/json", {}
        if path == "/metrics":
            text = _metrics.default_registry().to_prometheus()
            return (200, text.encode(),
                    "text/plain; version=0.0.4; charset=utf-8", {})
        return super()._route(method, path, body, headers)

    def _health(self) -> Dict[str, Any]:
        version = self.registry.current_version()
        has_model = version is not None or (
            self.tenants is not None and bool(self.tenants.tenants()))
        status = ("draining" if self._draining.is_set()
                  else "ok" if has_model else "no_model")
        out = {"status": status,
               "version": version,
               "queue_depth": self._batcher.depth(),
               "inflight": self.inflight()}
        if version is not None:
            runner = self.registry.get(version)
            out["batch_buckets"] = sorted(runner.compiled_shapes)
        if self.tenants is not None:
            out["tenants"] = self.tenants.summary()
        return out

    def _handle_predict(self, body: bytes,
                        headers: Optional[Dict[str, str]] = None
                        ) -> Tuple[int, Any, str, Dict[str, str]]:
        fault = _fi.check("serve", ctx="/predict")
        if fault is not None and fault.kind == "error":
            # chaos drill: answer a shed exactly as admission control
            # would, with an immediate-retry hint so drills stay fast
            return (fault.int_value(503), {"error": "fault injected"},
                    "application/json", {"Retry-After": "0"})
        if self._draining.is_set():
            return (503, {"error": "draining"},
                    "application/json", {"Retry-After": "1"})
        tenant = (headers or {}).get(TENANT_HEADER.lower())
        if tenant:
            return self._handle_tenant_predict(tenant, body)
        if self.registry.current_version() is None:
            return (503, {"error": "no model published"},
                    "application/json", {"Retry-After": "1"})
        try:
            rows, timeout = self._parse_predict(body)
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            return (400, {"error": f"bad request: {e}"},
                    "application/json", {})
        try:
            with _tracectx.span("batcher.submit",
                                batcher=self._batcher.name):
                fut = self._batcher.submit(rows, timeout=timeout)
                preds, version = fut.result(timeout=timeout + 5.0)
        except QueueFullError:
            return (503, {"error": "queue full"},
                    "application/json", {"Retry-After": "1"})
        except BatcherClosedError:
            return (503, {"error": "shutting down"},
                    "application/json", {})
        except TimeoutError:
            return (504, {"error": "request timed out"},
                    "application/json", {})
        except Exception as e:  # noqa: BLE001 — model failure != crash
            return (500, {"error": f"{type(e).__name__}: {e}"},
                    "application/json", {})
        if _metrics.enabled():
            serve_metrics()["version_requests"].inc(
                1, version=str(version))
        return (200, {"predictions": np.asarray(preds).tolist(),
                      "version": version},
                "application/json", {})

    def _parse_predict(self, body: bytes) -> Tuple[np.ndarray, float]:
        """Shared predict-body validation → ``(rows, timeout_s)``;
        raises ValueError/KeyError/JSONDecodeError on abuse."""
        payload = json.loads(body)
        rows = np.asarray(payload["rows"], np.float32)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or len(rows) == 0:
            raise ValueError(f"bad rows shape {rows.shape}")
        if len(rows) > self._batcher.max_batch:
            raise ValueError(
                f"too many rows in one request: {len(rows)} > "
                f"max_batch {self._batcher.max_batch}")
        # client-supplied end-to-end deadline: the batcher sheds a
        # request whose deadline lapsed while it queued (504) instead
        # of executing it late — see serve.client.ResilientClient
        timeout = self.request_timeout
        if "timeout_ms" in payload:
            timeout_ms = float(payload["timeout_ms"])
            if timeout_ms <= 0:
                raise ValueError(f"bad timeout_ms {timeout_ms}")
            timeout = min(timeout, timeout_ms / 1000.0)
        return rows, timeout

    def _handle_tenant_predict(self, tenant: str, body: bytes
                               ) -> Tuple[int, Any, str, Dict[str, str]]:
        """Predict against a tenant namespace (X-Dmlc-Tenant header).

        Tenant rows execute directly on the tenant's resolved runner —
        the pow-2 bucket ladder still bounds compiled shapes, but there
        is no cross-request coalescing (per-tenant micro-batching would
        need one batcher per resident tenant; the direct path is what
        keeps a page-in's latency attributable to ONE tenant).  The
        resolve may transparently warm-restore an evicted model."""
        if self.tenants is None:
            return (400, {"error": "tenancy not enabled on this server"},
                    "application/json", {})
        try:
            rows, _timeout = self._parse_predict(body)
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            return (400, {"error": f"bad request: {e}"},
                    "application/json", {})
        try:
            version, runner = self.tenants.current(tenant)
        except KeyError:
            return (404, {"error": f"unknown tenant {tenant!r}"},
                    "application/json", {})
        except Exception as e:  # noqa: BLE001 — no version activated yet
            return (503, {"error": f"tenant {tenant!r}: {e}"},
                    "application/json", {"Retry-After": "1"})
        try:
            with _tracectx.span("tenant.predict", tenant=tenant):
                preds = runner.predict(rows)
        except Exception as e:  # noqa: BLE001 — model failure != crash
            return (500, {"error": f"{type(e).__name__}: {e}"},
                    "application/json", {})
        if _metrics.enabled():
            serve_metrics()["version_requests"].inc(
                1, version=str(version))
        return (200, {"predictions": np.asarray(preds).tolist(),
                      "version": version, "tenant": tenant},
                "application/json", {})
