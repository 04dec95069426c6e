"""Fleet router: consistent hashing, health probes, failover, admission.

One HTTP tier in front of N replicas, built from pieces the repo
already trusts: the :class:`~dmlc_core_tpu_torch.serve.frontend.HttpServer`
request loop, per-replica
:class:`~dmlc_core_tpu_torch.base.resilience.CircuitBreaker` state, and the
:class:`~dmlc_core_tpu_torch.serve.fleet.replica.FleetTracker` membership
view.

**Routing** is consistent hashing over the request body
(:class:`HashRing`, MD5, ``DMLC_FLEET_VNODES`` virtual nodes per
replica): identical predict payloads land on the same replica while it
is healthy — warm-runner and bucket affinity — and a membership change moves
only ~1/N of the keyspace (pinned by ``tests/test_fleet.py``).

**Failover**: predict is idempotent (a pure function of the rows), so
a failed attempt walks the ring to the next distinct replica, up to
``DMLC_FLEET_FAILOVER`` extra tries.  The breaker discipline is
deliberate: a transport error or 5xx records a failure (enough of them
open the circuit and the replica is skipped instantly until its
half-open probe); a **503 shed records a success** — the replica is
alive and protecting itself, and opening its circuit for doing so
would amplify overload into blackout.

**Admission control**: when the fleet-wide queued-request count (sum
of healthy replicas' probed queue depth) exceeds
``DMLC_FLEET_MAX_QUEUE``, the router sheds with 503 + ``Retry-After``
*before* burning a replica round trip — the fleet-level analogue of
the batcher's full-queue 503.

The response body of a routed predict is passed through **verbatim** —
the router adds zero serialization steps, so fleet predictions stay
bit-identical to single-replica ones.

The PyTorch port's counterpart of ``dmlc_core_tpu/serve/fleet/router.py``:
the same names, env ABI and metric names.  :class:`HashRing` hashes
the same strings with MD5, so a fleet's key → replica map is the
same in both packages.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base import tracectx as _tracectx
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.resilience import CircuitBreaker, RetryPolicy
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.io.http_util import HttpError, http_request
from dmlc_core_tpu_torch.serve.fleet.instruments import fleet_metrics
from dmlc_core_tpu_torch.serve.fleet.replica import FleetTracker
from dmlc_core_tpu_torch.serve.frontend import TENANT_HEADER, HttpServer
from dmlc_core_tpu_torch.serve.tenancy.instruments import tenant_metrics
from dmlc_core_tpu_torch.serve.tenancy.policy import TenantPolicy

__all__ = ["HashRing", "FleetRouter"]

#: one physical attempt per candidate replica — the router's ring walk
#: IS the retry loop, an inner retry would multiply tail latency
_ONE_ATTEMPT = RetryPolicy(max_attempts=1)


class HashRing:
    """Consistent-hash ring over an immutable node set.

    Pure and deterministic (MD5 of ``"{node}#{vnode}"``), so every
    router process — and the stability test — derives the identical
    ring from the same membership.  Build a NEW ring on membership
    change; lookups are lock-free reads of immutable state.
    """

    def __init__(self, nodes: Sequence[Any], vnodes: Optional[int] = None):
        if vnodes is None:
            vnodes = int(os.environ.get("DMLC_FLEET_VNODES", "64"))
        CHECK(vnodes >= 1, f"vnodes must be >= 1, got {vnodes}")
        self.nodes = sorted(set(nodes))
        points: List[Tuple[int, Any]] = []
        for node in self.nodes:
            for i in range(vnodes):
                points.append((self._hash(f"{node}#{i}".encode()), node))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._owners = [n for _, n in points]

    @staticmethod
    def _hash(data: bytes) -> int:
        return int.from_bytes(hashlib.md5(data).digest()[:8], "big")

    def lookup(self, key: bytes) -> Any:
        """Owning node for ``key`` (first vnode clockwise)."""
        CHECK(self.nodes, "lookup on an empty HashRing")
        return self._owners[self._index(key)]

    def sequence(self, key: bytes) -> List[Any]:
        """All nodes in preference order for ``key``: the owner, then
        each DISTINCT next node clockwise — the failover walk."""
        if not self.nodes:
            return []
        out: List[Any] = []
        i = self._index(key)
        for k in range(len(self._owners)):
            node = self._owners[(i + k) % len(self._owners)]
            if node not in out:
                out.append(node)
                if len(out) == len(self.nodes):
                    break
        return out

    def _index(self, key: bytes) -> int:
        h = self._hash(key)
        i = bisect.bisect_right(self._hashes, h)
        return i % len(self._hashes)


class _ReplicaState:
    """Router-side view of one replica (mutable fields guarded by the
    router's lock; the breaker is internally thread-safe)."""

    def __init__(self, rank: int, url: str):
        self.rank = rank
        self.url = url
        self.breaker = CircuitBreaker.from_env(name=f"fleet:replica{rank}")
        self.healthy = False
        self.queue_depth = 0
        self.version: Optional[int] = None
        self.status = "unknown"

    def doc(self) -> Dict[str, Any]:
        return {"url": self.url, "healthy": self.healthy,
                "status": self.status, "queue_depth": self.queue_depth,
                "version": self.version, "breaker": self.breaker.state}


class FleetRouter(HttpServer):
    """HTTP router/load-balancer over a :class:`FleetTracker`'s fleet.

    A background thread refreshes membership from the tracker and
    health-probes every replica (``GET /healthz``) each
    ``DMLC_FLEET_PROBE_S``; the ring only contains replicas whose last
    probe answered ``status: ok``.  ``/predict`` routes by body hash
    with breaker-guarded failover; ``/healthz`` answers the router's
    own fleet view; ``/metrics`` exposes the process registry.
    """

    def __init__(self, tracker: FleetTracker, host: str = "127.0.0.1",
                 port: int = 0, max_queue: Optional[int] = None,
                 probe_s: Optional[float] = None,
                 failover: Optional[int] = None,
                 policy: Optional[TenantPolicy] = None):
        super().__init__(host=host, port=port, name="fleet-router")
        self._tracker = tracker
        self.max_queue = (max_queue if max_queue is not None else
                          int(os.environ.get("DMLC_FLEET_MAX_QUEUE", "512")))
        self.probe_s = (probe_s if probe_s is not None else
                        float(os.environ.get("DMLC_FLEET_PROBE_S", "0.5")))
        self.failover = (failover if failover is not None else
                         int(os.environ.get("DMLC_FLEET_FAILOVER", "2")))
        #: tenant admission policy (SLO classes, quotas, hedging) —
        #: resolved from the DMLC_TENANT_* knobs unless injected
        self.policy = policy if policy is not None else TenantPolicy()
        self._lock = threading.Lock()
        self._replicas: Dict[int, _ReplicaState] = {}
        self._ring = HashRing([])
        self._tenant_inflight: Dict[str, int] = {}
        self._tenant_inflight_total = 0
        self._hedge_threads: List[threading.Thread] = []
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="fleet-probe")

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "FleetRouter":
        """Probe once (so the first request already has a fleet view),
        then begin accepting and probing."""
        self.probe_now()
        super().start()
        self._probe_thread.start()
        return self

    def close(self) -> None:
        super().close()          # sets _done → probe loop exits
        if self._probe_thread.is_alive():
            self._probe_thread.join(timeout=2.0)
        with self._lock:
            hedges = list(self._hedge_threads)
            self._hedge_threads.clear()
        for t in hedges:
            t.join(timeout=2.0)

    # -- membership / health ---------------------------------------------
    def _probe_loop(self) -> None:
        while not self._done.wait(self.probe_s):
            try:
                self.probe_now()
            except Exception as e:  # noqa: BLE001 — probes must not die
                LOG("WARNING", "fleet.router: probe pass failed: %s", e)

    def probe_now(self) -> None:
        """One membership-refresh + health-probe pass (also callable
        from tests/drills to skip the probe interval)."""
        endpoints = self._tracker.serve_endpoints()
        results: Dict[int, Tuple[str, Dict[str, Any]]] = {}
        for rank, url in endpoints.items():
            try:
                _, _, body = http_request(
                    "GET", url + "/healthz", retry=_ONE_ATTEMPT,
                    op="fleet_probe")
                results[rank] = (url, json.loads(body))
            except Exception:  # noqa: BLE001 — unreachable == unhealthy
                results[rank] = (url, {"status": "unreachable"})
        with self._lock:
            before = self._routable_locked()
            for rank in list(self._replicas):
                if rank not in results:
                    del self._replicas[rank]
            for rank, (url, doc) in results.items():
                st = self._replicas.get(rank)
                if st is None or st.url != url:
                    st = self._replicas[rank] = _ReplicaState(rank, url)
                st.status = str(doc.get("status", "unreachable"))
                st.healthy = st.status == "ok"
                st.queue_depth = int(doc.get("queue_depth") or 0)
                st.version = doc.get("version")
            after = self._routable_locked()
            if after != before:
                self._ring = HashRing(after)
                LOG("INFO", "fleet.router: routable set now %s", after)
            depth = sum(self._replicas[r].queue_depth for r in after)
        if _metrics.enabled():
            m = fleet_metrics()
            m["healthy"].set(len(after))
            m["queue_depth"].set(depth)

    def _routable_locked(self) -> List[int]:
        return sorted(r for r, st in self._replicas.items() if st.healthy)

    def replica_docs(self) -> Dict[int, Dict[str, Any]]:
        """Router-side state per replica (health doc for ``/healthz``)."""
        with self._lock:
            return {r: st.doc() for r, st in self._replicas.items()}

    # -- routing ---------------------------------------------------------
    def _observe(self, path: str, code: int, seconds: float) -> None:
        if _metrics.enabled():
            p = path if path in ("/predict", "/healthz", "/metrics") else "other"
            fleet_metrics()["router_e2e"].observe(seconds, path=p)

    def _route(self, method: str, path: str, body: bytes,
               headers: Optional[Dict[str, str]] = None
               ) -> Tuple[int, Any, str, Dict[str, str]]:
        if path == "/predict":
            if method != "POST":
                return 405, {"error": "POST only"}, "application/json", {}
            tenant = (headers or {}).get(TENANT_HEADER.lower())
            return self._route_predict(body, tenant=tenant)
        if path == "/healthz":
            docs = self.replica_docs()
            healthy = sum(1 for d in docs.values() if d["healthy"])
            return (200, {"status": "ok" if healthy else "no_replicas",
                          "healthy": healthy,
                          "replicas": {str(r): d for r, d in docs.items()}},
                    "application/json", {})
        if path == "/metrics":
            text = _metrics.default_registry().to_prometheus()
            return (200, text.encode(),
                    "text/plain; version=0.0.4; charset=utf-8", {})
        return super()._route(method, path, body, headers)

    def _route_predict(self, body: bytes, tenant: Optional[str] = None
                       ) -> Tuple[int, Any, str, Dict[str, str]]:
        with _tracectx.span("fleet.route"):
            if tenant:
                return self._route_tenant_predict(tenant, body)
            return self._route_predict_traced(body)

    def _route_predict_traced(self, body: bytes
                              ) -> Tuple[int, Any, str, Dict[str, str]]:
        m = fleet_metrics() if _metrics.enabled() else None
        candidates, depth = self._candidates_for(body)
        if not candidates:
            if m:
                m["shed"].inc(1, reason="no_replicas")
            return (503, {"error": "no healthy replicas"},
                    "application/json", {"Retry-After": "1"})
        if depth > self.max_queue:
            if m:
                m["shed"].inc(1, reason="queue")
            return (503, {"error": f"fleet queue depth {depth} > "
                                   f"{self.max_queue}"},
                    "application/json", {"Retry-After": "1"})
        return self._walk(candidates, body)

    # -- tenant-aware routing (doc/serving.md, "Multi-tenant serving") ---
    def _route_tenant_predict(self, tenant: str, body: bytes
                              ) -> Tuple[int, Any, str, Dict[str, str]]:
        tm = tenant_metrics() if _metrics.enabled() else None
        t0 = get_time()
        out = self._admit_tenant(tenant, body)
        if tm:
            tm["requests"].inc(1, tenant=tenant, code=str(out[0]))
            tm["e2e"].observe(get_time() - t0, tenant=tenant)
        return out

    def _admit_tenant(self, tenant: str, body: bytes
                      ) -> Tuple[int, Any, str, Dict[str, str]]:
        """Per-tenant admission: quota first (one hot tenant cannot
        monopolize the fleet), then the class-graded in-flight ladder —
        bronze sheds with 429 at ``shed_fraction * max_inflight`` while
        gold/silver ride to the full cap (503 there: the FLEET is
        saturated, not the tenant's class)."""
        pol = self.policy
        tm = tenant_metrics() if _metrics.enabled() else None
        with self._lock:
            mine = self._tenant_inflight.get(tenant, 0)
            if pol.quota and mine >= pol.quota:
                if tm:
                    tm["shed"].inc(1, tenant=tenant, reason="quota")
                return (429, {"error": f"tenant {tenant!r} over quota "
                                       f"({mine} >= {pol.quota} in flight)"},
                        "application/json", {"Retry-After": "1"})
            total = self._tenant_inflight_total
            if total >= pol.shed_threshold(tenant):
                if pol.class_of(tenant) == "bronze" \
                        and total < pol.max_inflight:
                    if tm:
                        tm["shed"].inc(1, tenant=tenant, reason="class")
                    return (429, {"error": f"tenant {tenant!r} (bronze) "
                                           f"shed under overload"},
                            "application/json", {"Retry-After": "1"})
                if tm:
                    tm["shed"].inc(1, tenant=tenant, reason="inflight")
                return (503, {"error": f"router tenant in-flight {total} "
                                       f">= {pol.max_inflight}"},
                        "application/json", {"Retry-After": "1"})
            self._tenant_inflight[tenant] = mine + 1
            self._tenant_inflight_total += 1
        try:
            return self._forward_tenant(tenant, body)
        finally:
            with self._lock:
                self._tenant_inflight[tenant] -= 1
                self._tenant_inflight_total -= 1

    def _forward_tenant(self, tenant: str, body: bytes
                        ) -> Tuple[int, Any, str, Dict[str, str]]:
        m = fleet_metrics() if _metrics.enabled() else None
        # the ring key is (tenant, body): one tenant's identical rows
        # keep replica affinity (warm runner, no paging churn) without
        # colliding with another tenant's identical payload
        candidates, depth = self._candidates_for(
            tenant.encode("utf-8") + b"\x00" + body)
        if not candidates:
            if m:
                m["shed"].inc(1, reason="no_replicas")
            return (503, {"error": "no healthy replicas"},
                    "application/json", {"Retry-After": "1"})
        if depth > self.max_queue:
            if m:
                m["shed"].inc(1, reason="queue")
            return (503, {"error": f"fleet queue depth {depth} > "
                                   f"{self.max_queue}"},
                    "application/json", {"Retry-After": "1"})
        if self.policy.hedges(tenant) and len(candidates) >= 2:
            return self._hedged(candidates, body, tenant)
        return self._walk(candidates, body, tenant)

    # -- forwarding machinery --------------------------------------------
    def _candidates_for(self, key: bytes
                        ) -> Tuple[List[Tuple[int, str, CircuitBreaker]],
                                   int]:
        """Ring-ordered routable candidates for ``key`` (capped at
        1 + failover) plus the fleet-wide probed queue depth."""
        with self._lock:
            routable = self._routable_locked()
            ring = self._ring
            depth = sum(self._replicas[r].queue_depth for r in routable)
            candidates = [(r, self._replicas[r].url,
                           self._replicas[r].breaker)
                          for r in ring.sequence(key)
                          if r in routable][:1 + self.failover]
        return candidates, depth

    def _attempt(self, rank: int, url: str, breaker: CircuitBreaker,
                 body: bytes, tenant: Optional[str] = None
                 ) -> Tuple[str, Any]:
        """One forward to one replica with the breaker discipline →
        ``("ok", data)`` / ``("shed", HttpError)`` (alive, 503) /
        ``("client", HttpError)`` (the request's own fault) /
        ``("skip", None)`` (breaker open) / ``("fail", None)``."""
        m = fleet_metrics() if _metrics.enabled() else None
        if not breaker.allow():
            if m:
                m["failover"].inc(1, reason="open")
            return "skip", None
        try:
            with _tracectx.span("fleet.forward",
                                replica=str(rank)) as fwd:
                hdrs_out = {"Content-Type": "application/json"}
                if tenant:
                    hdrs_out[TENANT_HEADER] = tenant
                if fwd is not None:
                    hdrs_out[_tracectx.HTTP_HEADER] = fwd.encode()
                _, _, data = http_request(
                    "POST", url + "/predict", hdrs_out, body,
                    ok=(200,), retry=_ONE_ATTEMPT, idempotent=True,
                    op="fleet_route")
        except HttpError as e:
            if e.status == 503:
                # alive-but-shedding: NOT a breaker failure (see
                # module docstring) — walk to the next replica
                breaker.record_success()
                if m:
                    m["failover"].inc(1, reason="shed")
                return "shed", e
            if 400 <= e.status < 500 and e.status not in (408, 429):
                # the request's own fault — identical everywhere,
                # pass the replica's verdict through
                return "client", e
            breaker.record_failure()
            if m:
                m["failover"].inc(1, reason="transport")
            return "fail", None
        except Exception:  # noqa: BLE001 — refused/reset/timeout
            breaker.record_failure()
            self._mark_unhealthy(rank)
            if m:
                m["failover"].inc(1, reason="transport")
            return "fail", None
        breaker.record_success()
        if m:
            m["routed"].inc(1, replica=str(rank))
        return "ok", data

    def _walk(self, candidates: List[Tuple[int, str, CircuitBreaker]],
              body: bytes, tenant: Optional[str] = None,
              last_shed: Optional[HttpError] = None
              ) -> Tuple[int, Any, str, Dict[str, str]]:
        """Sequential failover walk over ``candidates`` — the router's
        retry loop (one physical attempt per replica)."""
        for rank, url, breaker in candidates:
            kind, payload = self._attempt(rank, url, breaker, body,
                                          tenant=tenant)
            if kind == "ok":
                return 200, payload, "application/json", {}
            if kind == "shed":
                last_shed = payload
            elif kind == "client":
                return payload.status, payload.body, "application/json", {}
        if last_shed is not None:
            retry_after = last_shed.retry_after
            hdrs = {"Retry-After": str(retry_after if retry_after
                                       is not None else 1)}
            return 503, last_shed.body, "application/json", hdrs
        return (502, {"error": "no replica answered"},
                "application/json", {"Retry-After": "1"})

    def _hedged(self, candidates: List[Tuple[int, str, CircuitBreaker]],
                body: bytes, tenant: str
                ) -> Tuple[int, Any, str, Dict[str, str]]:
        """Gold-tenant hedge: race the ring owner against the next
        candidate when the owner is still in flight after
        ``DMLC_TENANT_HEDGE_MS``; first success wins (predict is
        idempotent, so the duplicate is wasted work, not wrong work).
        Falls back to the ordinary walk over the remaining candidates
        when both racers fail."""
        tm = tenant_metrics() if _metrics.enabled() else None
        cond = threading.Condition()
        results: List[Tuple[str, str, Any]] = []

        def run(cand: Tuple[int, str, CircuitBreaker], which: str) -> None:
            kind, payload = self._attempt(cand[0], cand[1], cand[2],
                                          body, tenant=tenant)
            with cond:
                results.append((which, kind, payload))
                cond.notify_all()

        def spawn(cand: Tuple[int, str, CircuitBreaker],
                  which: str) -> threading.Thread:
            t = threading.Thread(target=run, args=(cand, which),
                                 daemon=True,
                                 name=f"fleet-hedge-{tenant}-{which}")
            with self._lock:
                self._hedge_threads = [x for x in self._hedge_threads
                                       if x.is_alive()]
                self._hedge_threads.append(t)
            t.start()
            return t

        spawn(candidates[0], "primary")
        launched = 1
        with cond:
            cond.wait_for(lambda: len(results) >= 1,
                          timeout=self.policy.hedge_ms / 1000.0)
            primary_done = len(results) >= 1
        if not primary_done:
            # owner still in flight after the hedge delay: race it
            if tm:
                tm["hedge"].inc(1, outcome="launched")
            spawn(candidates[1], "hedge")
            launched = 2
        with cond:
            cond.wait_for(lambda: any(k == "ok" for _, k, _ in results)
                          or len(results) >= launched)
            snapshot = list(results)
        for which, kind, payload in snapshot:
            if kind == "ok":
                if tm and launched == 2:
                    tm["hedge"].inc(1, outcome=("won" if which == "hedge"
                                                else "lost"))
                return 200, payload, "application/json", {}
        # both racers failed — keep walking the rest of the ring,
        # carrying any shed verdict so saturation still answers 503
        last_shed = next((p for _, k, p in snapshot if k == "shed"), None)
        for which, kind, payload in snapshot:
            if kind == "client":
                return payload.status, payload.body, "application/json", {}
        return self._walk(candidates[launched:], body, tenant=tenant,
                          last_shed=last_shed)

    def _mark_unhealthy(self, rank: int) -> None:
        """Drop a replica from the ring immediately after a transport
        failure — the next probe pass re-adds it if it recovered."""
        with self._lock:
            st = self._replicas.get(rank)
            if st is not None and st.healthy:
                st.healthy = False
                st.status = "unreachable"
                self._ring = HashRing(self._routable_locked())
