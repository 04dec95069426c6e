"""Resilient HTTP client for the serving frontend and fleet.

The frontend already speaks admission control — a full queue or a
fault answers **503 + Retry-After**, an expired request **504** — and
the caller decides what to do about it.  This client
closes the loop with the ``base.resilience`` layer:

* retries through a :class:`~dmlc_core_tpu_torch.base.resilience.RetryPolicy`
  (env ``DMLC_RETRY_*``), honoring the frontend's ``Retry-After`` hint
  via :class:`~dmlc_core_tpu_torch.io.http_util.HttpError.retry_after` — a
  503 shed is a *backpressure signal*, and the client is the half of
  the contract that turns it into spaced-out retries instead of a
  thundering herd;
* accepts a **list of endpoints** (replica URLs, or one router URL):
  each retry attempt targets the next endpoint in rotation, so a
  hard-down replica costs one failed attempt, not the whole budget —
  the fleet's retry-on-another-replica contract for idempotent
  predicts;
* keeps **per-endpoint** :class:`~dmlc_core_tpu_torch.base.resilience.
  CircuitBreaker` state, so a down endpoint is skipped instantly
  (one ``allow()`` check) while its siblings keep serving, and probed
  again after the reset window;
* forwards an end-to-end deadline (``timeout_ms``) that the frontend
  hands to the batcher, so a request that would expire in the queue is
  **shed at batch-assembly time** (504) rather than executed late —
  deadline shedding happens server-side where the queue wait is known.

Predictions come back bit-identical to ``model.predict`` (JSON carries
exact float32 values) — the property the chaos soak test pins down
under active fault injection, and that holds whether the rows were
scored via one frontend, a failover sibling, or the fleet router.

This package's own copy of ``dmlc_core_tpu.serve.client``: host code,
the same retry, failover and breaker contracts.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from dmlc_core_tpu_torch.base import tracectx as _tracectx
from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.base.resilience import (CircuitBreaker, CircuitOpenError,
                                           RetryPolicy)
from dmlc_core_tpu_torch.io.http_util import HttpError, http_request

__all__ = ["ResilientClient"]

#: inner policy for one physical attempt — the OUTER policy owns the
#: retry budget so each retry can rotate to a different endpoint
_ONE_ATTEMPT = RetryPolicy(max_attempts=1)

#: transport failures a multi-endpoint predict may fail over on —
#: mirrors http_util's classification (predict is idempotent)
_TRANSPORT = (ConnectionError, TimeoutError, OSError)


class ResilientClient:
    """Retry/breaker-aware client for one or many
    :class:`~dmlc_core_tpu_torch.serve.frontend.ServeFrontend` endpoints (or
    anything speaking the same HTTP/JSON API — a fleet router included).

    ``endpoints`` is a base URL or a sequence of them.  With several
    endpoints, each endpoint gets its own :class:`CircuitBreaker` and
    every retry attempt rotates to the next non-open endpoint —
    failover rides the ordinary retry budget.  With a single endpoint
    the original contract is unchanged: ``breaker=None`` means no
    breaker (every caller shares the endpoint's error budget).

    ``policy=None`` builds one from the ``DMLC_RETRY_*`` env knobs;
    ``breaker`` is only meaningful for a single endpoint (pass one to
    shed instantly while that frontend is hard-down) — multi-endpoint
    clients always build per-endpoint breakers from ``DMLC_CB_*``.
    """

    def __init__(self, endpoints: Union[str, Sequence[str]],
                 policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        eps = [endpoints] if isinstance(endpoints, str) else list(endpoints)
        CHECK(len(eps) >= 1, "ResilientClient needs at least one endpoint")
        self.endpoints = [e.rstrip("/") for e in eps]
        #: back-compat: the single-host attribute predating endpoint lists
        self.base_url = self.endpoints[0]
        self._policy = policy if policy is not None else RetryPolicy.from_env()
        if len(self.endpoints) == 1:
            self._breakers: Dict[str, Optional[CircuitBreaker]] = {
                self.base_url: breaker}
        else:
            CHECK(breaker is None,
                  "pass per-endpoint breakers implicitly: a single shared "
                  "breaker cannot track multiple endpoints")
            self._breakers = {
                ep: CircuitBreaker.from_env(name=f"client:{ep}")
                for ep in self.endpoints}
        self._lock = threading.Lock()
        self._cursor = 0

    # -- introspection ---------------------------------------------------
    def breaker_states(self) -> Dict[str, Optional[str]]:
        """Per-endpoint breaker state (``closed``/``open``/``half_open``,
        or None when the endpoint has no breaker)."""
        return {ep: (br.state if br is not None else None)
                for ep, br in self._breakers.items()}

    # -- plumbing --------------------------------------------------------
    def _next_endpoint(self, advance: bool = False) -> str:
        """Current rotation target; ``advance`` moves the cursor first
        (called after a failed attempt so the retry lands elsewhere)."""
        with self._lock:
            if advance:
                self._cursor += 1
            return self.endpoints[self._cursor % len(self.endpoints)]

    @staticmethod
    def _failover_worthy(e: BaseException) -> bool:
        """Errors a sibling endpoint might not reproduce.  A 503 shed or
        breaker-open IS retryable (next endpoint / after Retry-After);
        a 400/404 is the request's fault and retries nowhere."""
        if isinstance(e, CircuitOpenError):
            return True
        if isinstance(e, HttpError):
            return e.status in (408, 429) or 500 <= e.status < 600
        return isinstance(e, _TRANSPORT)

    def _request(self, method: str, path: str, body: bytes = b"",
                 op: str = "serve_request",
                 headers: Optional[Dict[str, str]] = None
                 ) -> Tuple[int, Dict[str, str], bytes]:
        def attempt() -> Tuple[int, Dict[str, str], bytes]:
            # skip past endpoints whose breaker is open (bounded scan:
            # one pass over the ring; all-open falls through to the
            # breaker raising, which the outer policy spaces out)
            ep = self._next_endpoint()
            br = self._breakers.get(ep)
            allowed = br is None or br.allow()  # ONE allow per attempt:
            for _ in range(len(self.endpoints) - 1):  # half-open admits
                if allowed:                           # a single probe
                    break
                ep = self._next_endpoint(advance=True)
                br = self._breakers.get(ep)
                allowed = br is None or br.allow()
            try:
                if not allowed:
                    raise CircuitOpenError(
                        f"circuit open for every endpoint (at {ep})")
                # predict is idempotent (pure function of the rows), so
                # the POST may retry ambiguous transport failures too
                with _tracectx.span(f"client.{op}", endpoint=ep) as ctx:
                    hdrs = ({"Content-Type": "application/json"}
                            if body else {})
                    if headers:
                        hdrs.update(headers)
                    if ctx is not None:
                        hdrs[_tracectx.HTTP_HEADER] = ctx.encode()
                    out = http_request(
                        method, ep + path, hdrs or None,
                        body, ok=(200,), retry=_ONE_ATTEMPT,
                        idempotent=True, op=op)
            except CircuitOpenError:
                self._next_endpoint(advance=True)
                raise
            except BaseException as e:  # noqa: BLE001 — classify + rethrow
                self._next_endpoint(advance=True)
                if br is not None:
                    if isinstance(e, HttpError) and e.status in (503, 429):
                        br.record_success()  # alive, just shedding
                    else:
                        br.record_failure()
                raise
            if br is not None:
                br.record_success()
            return out

        return self._policy.run(attempt, op=op,
                                retryable=self._failover_worthy)

    # -- API -------------------------------------------------------------
    def predict(self, rows: Any,
                timeout_ms: Optional[int] = None,
                tenant: Optional[str] = None
                ) -> Tuple[np.ndarray, int]:
        """Score ``[k, F]`` rows (or one ``[F]`` row) →
        ``(predictions, model_version)``.

        ``timeout_ms`` rides in the request body as the end-to-end
        deadline the frontend enforces: a request that would expire in
        the batch queue is shed server-side (504 → retried here while
        budget remains, then raised).

        ``tenant`` adds the ``X-Dmlc-Tenant`` header, so the rows
        resolve against that tenant's namespace (router admission +
        replica tenant registry — doc/serving.md, multi-tenant)."""
        rows = np.asarray(rows, np.float32)
        payload: Dict[str, Any] = {"rows": rows.tolist()}
        if timeout_ms is not None:
            payload["timeout_ms"] = int(timeout_ms)
        extra = None
        if tenant is not None:
            from dmlc_core_tpu_torch.serve.frontend import TENANT_HEADER
            extra = {TENANT_HEADER: tenant}
        _, _, body = self._request(
            "POST", "/predict", json.dumps(payload).encode(),
            op="serve_predict", headers=extra)
        doc = json.loads(body)
        return (np.asarray(doc["predictions"], np.float32),
                int(doc["version"]))

    def healthz(self) -> Dict[str, Any]:
        """The frontend's liveness document (version, queue depth...)."""
        _, _, body = self._request("GET", "/healthz", op="serve_healthz")
        return json.loads(body)

    def metrics_text(self) -> str:
        """Prometheus text exposition scraped from ``/metrics``."""
        _, _, body = self._request("GET", "/metrics", op="serve_metrics")
        return body.decode()
