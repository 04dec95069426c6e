"""Fleet replica: a supervised serve process, and the tracker that
supervises it.

The composition the paper's layering implies: ``dmlc_tracker`` launched
and supervised N training workers; here the SAME tracker machinery
(persistent :class:`~dmlc_core_tpu_torch.tracker.tracker.WorkerSession`
connections, rank assignment, death detection, grace windows) supervises
N *inference* replicas.  A replica is the whole single-process serve
stack — :class:`~dmlc_core_tpu_torch.serve.registry.ModelRegistry` +
:class:`~dmlc_core_tpu_torch.serve.batcher.DynamicBatcher` +
:class:`~dmlc_core_tpu_torch.serve.frontend.ServeFrontend` — plus:

* **registration**: on start it handshakes a rank and sends
  ``serve_register`` with its predict URL, so the router learns the
  fleet from the tracker instead of static config;
* **heartbeat**: every ``DMLC_FLEET_HEARTBEAT_S`` it sends
  ``serve_report`` with its load document (queue depth, inflight,
  queue-wait p99, active version, draining flag) — the signal the
  autoscale policy and the router's admission control read;
* **admin surface**: ``POST /admin/load`` (publish a checkpoint URI,
  optionally staged), ``POST /admin/activate`` (switch/rollback the
  active version), ``POST /drain`` (stop admitting, finish in-flight),
  ``POST /admin/shutdown`` (drain then exit) — the RPCs the rollout
  driver and the local autoscale backend speak.

Death is detected the rabit way: the replica's persistent tracker
socket closes without a clean ``shutdown`` → the tracker frees the
rank, records the death, and drops the endpoint so the router stops
routing there (its breaker has usually opened already).

The PyTorch port's counterpart of ``dmlc_core_tpu/serve/fleet/replica.py``:
the same tracker commands, admin routes, ``FLEET_*`` env ABI and metric
names, so a replica of either package registers with a tracker of the
other.  :class:`Replica` takes ``device=`` (``None``: ``cuda``) and hands
it to its :class:`ModelRegistry` and :class:`TenantRegistry`, so every
served batch of a ``HistGBT`` runs ``descend_kernel`` on that card.  A
replica subprocess (:data:`REPLICA_COMMAND`, ``python -m
dmlc_core_tpu_torch.serve.fleet.replica``) takes its device from
``FLEET_DEVICE`` — unset means ``cuda`` — the port's counterpart of the
``JAX_PLATFORMS=cpu`` the JAX package's callers put in a child's env;
callers pass it through ``extra_env`` / ``spawn_env`` as they pass
theirs.  A replica that cannot reach its device raises before it
registers, and its process exits non-zero: it never serves from the CPU.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.serve.fleet.instruments import fleet_metrics
from dmlc_core_tpu_torch.serve.frontend import ServeFrontend
from dmlc_core_tpu_torch.serve.instruments import serve_metrics
from dmlc_core_tpu_torch.serve.registry import ModelRegistry
from dmlc_core_tpu_torch.tracker.tracker import RabitTracker, WorkerSession
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["FleetTracker", "ReplicaFrontend", "Replica", "REPLICA_COMMAND",
           "replica_env", "spawn_replica", "replica_main"]


def _heartbeat_s() -> float:
    return float(os.environ.get("DMLC_FLEET_HEARTBEAT_S", "0.5"))


class FleetTracker(RabitTracker):
    """RabitTracker serving a replica fleet's control plane.

    Two extra commands ride the ordinary JSON-lines protocol via the
    ``_handle_ext`` hook: ``serve_register`` {rank, url} announces a
    replica's predict endpoint, ``serve_report`` {rank, load} refreshes
    its load document.  ``serve_endpoints`` answers the current
    endpoint map (for out-of-process routers/clients; in-process
    callers use :meth:`serve_endpoints` directly).

    Membership rides the base tracker's liveness machinery: a replica
    whose persistent socket dies (or whose grace window lapses) has its
    endpoint and load dropped atomically with the death record, so
    ``serve_endpoints()`` never returns a rank the tracker knows is
    gone.
    """

    def __init__(self, host_ip: str = "127.0.0.1", nworker: int = 1,
                 port: int = 0, grace_s: Optional[float] = None):
        super().__init__(host_ip=host_ip, nworker=nworker, port=port,
                         grace_s=grace_s)
        # guarded by the base tracker's self._lock, like all membership
        self._endpoints: Dict[int, str] = {}
        self._loads: Dict[int, Dict[str, Any]] = {}

    # -- protocol extension ----------------------------------------------
    def _handle_ext(self, cmd: Any, msg: Dict[str, Any],
                    conn: Optional[socket.socket],
                    state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if cmd == "serve_register":
            rank, url = int(msg["rank"]), str(msg["url"])
            with self._lock:
                self._endpoints[rank] = url
                self._loads.pop(rank, None)
                n = len(self._endpoints)
            LOG("INFO", "fleet.tracker: replica rank %d registered at %s",
                rank, url)
            if _metrics.enabled():
                fleet_metrics()["replicas"].set(n)
            return {"ok": True}
        if cmd == "serve_report":
            with self._lock:
                load = dict(msg.get("load") or {})
                if "tenants" in msg:
                    # tenancy-enabled replicas heartbeat their tenant
                    # map (version + residency per tenant) so rollout
                    # gates and autoscale can read it fleet-wide
                    load["tenants"] = msg["tenants"]
                self._loads[int(msg["rank"])] = load
            return {"ok": True}
        if cmd == "serve_endpoints":
            with self._lock:
                eps = {str(r): u for r, u in self._endpoints.items()}
            return {"endpoints": eps}
        return None

    def _membership_event_locked(self, kind: str, rank: int) -> None:
        super()._membership_event_locked(kind, rank)
        if kind in ("lost", "death", "shutdown"):
            if self._endpoints.pop(rank, None) is not None:
                LOG("WARNING", "fleet.tracker: replica rank %d %s — "
                    "endpoint dropped", rank, kind)
            self._loads.pop(rank, None)
            if _metrics.enabled():
                fleet_metrics()["replicas"].set(len(self._endpoints))

    # -- fleet view ------------------------------------------------------
    def serve_endpoints(self) -> Dict[int, str]:
        """Registered replica predict URLs by rank (live ranks only)."""
        with self._lock:
            return dict(self._endpoints)

    def serve_loads(self) -> Dict[int, Dict[str, Any]]:
        """Last heartbeat load document per rank."""
        with self._lock:
            return {r: dict(d) for r, d in self._loads.items()}


class ReplicaFrontend(ServeFrontend):
    """ServeFrontend plus the fleet admin surface.

    Admin routes are POST-only and answer JSON:

    * ``/admin/load`` ``{"uri": ..., "activate": bool}`` → ``{"version"}``
      — publish a serving checkpoint; ``activate=false`` stages it
      (the rollout's publish-everywhere-first step).
    * ``/admin/activate`` ``{"version": v}`` → switch traffic to an
      already-retained version (wave activate, or rollback).
    * ``/admin/shutdown`` → drain, then fire ``on_shutdown`` (the
      replica's run loop exits and the process leaves cleanly) — the
      autoscale scale-in path.
    """

    def __init__(self, registry: ModelRegistry, rank: int = -1,
                 on_shutdown: Optional[Any] = None, **kw: Any):
        super().__init__(registry, **kw)
        self.rank = rank
        self._on_shutdown = on_shutdown

    def load_report(self) -> Dict[str, Any]:
        """The load document heartbeats carry (== ``/healthz`` body)."""
        return self._health()

    def _health(self) -> Dict[str, Any]:
        doc = super()._health()
        doc["rank"] = self.rank
        p99 = None
        if _metrics.enabled():
            p99 = serve_metrics()["queue_wait"].quantile(
                0.99, batcher=self.registry.name)
        doc["queue_wait_p99_s"] = p99
        return doc

    def _route(self, method: str, path: str, body: bytes,
               headers: Optional[Dict[str, str]] = None
               ) -> Tuple[int, Any, str, Dict[str, str]]:
        if path.startswith("/admin/"):
            if method != "POST":
                return (405, {"error": "POST only"},
                        "application/json", {})
            try:
                payload = json.loads(body) if body else {}
                return self._handle_admin(path, payload)
            except Exception as e:  # noqa: BLE001 — bad admin call != crash
                return (400, {"error": f"{type(e).__name__}: {e}"},
                        "application/json", {})
        return super()._route(method, path, body, headers)

    def _handle_admin(self, path: str, payload: Dict[str, Any]
                      ) -> Tuple[int, Any, str, Dict[str, str]]:
        if path == "/admin/load":
            version = self.registry.load(
                str(payload["uri"]),
                activate=bool(payload.get("activate", True)))
            return (200, {"version": version,
                          "active": self.registry.current_version()},
                    "application/json", {})
        if path == "/admin/activate":
            self.registry.activate(int(payload["version"]))
            return (200, {"active": self.registry.current_version()},
                    "application/json", {})
        if path == "/admin/tenant/load":
            if self.tenants is None:
                return (400, {"error": "tenancy not enabled"},
                        "application/json", {})
            tenant = str(payload["tenant"])
            version = self.tenants.load(
                tenant, str(payload["uri"]),
                activate=bool(payload.get("activate", True)))
            return (200, {"version": version, "tenant": tenant,
                          "active": self.tenants.current_version(tenant)},
                    "application/json", {})
        if path == "/admin/tenant/activate":
            if self.tenants is None:
                return (400, {"error": "tenancy not enabled"},
                        "application/json", {})
            tenant = str(payload["tenant"])
            self.tenants.activate(tenant, int(payload["version"]))
            return (200, {"tenant": tenant,
                          "active": self.tenants.current_version(tenant)},
                    "application/json", {})
        if path == "/admin/shutdown":
            self.drain()
            if self._on_shutdown is not None:
                self._on_shutdown()
            return 200, {"status": "shutting_down"}, "application/json", {}
        return 404, {"error": f"no admin route {path}"}, "application/json", {}


class Replica:
    """One supervised serve process: frontend + tracker session +
    heartbeat.  Construct, then :meth:`run` (blocks until
    ``/admin/shutdown`` or :meth:`stop`), then :meth:`close`.
    ``device`` is where its models live (``None``: ``cuda``).
    """

    def __init__(self, tracker_uri: str, tracker_port: int,
                 name: str = "fleet", host: str = "127.0.0.1",
                 port: int = 0, model_uri: Optional[str] = None,
                 max_batch: int = 64, max_delay: float = 0.002,
                 max_queue: int = 256, tenancy: bool = False,
                 heartbeat_s: Optional[float] = None, device: Any = None,
                 **runner_opts: Any):
        self._stop = threading.Event()
        self.device = device
        self.registry = ModelRegistry(name=name, device=device,
                                      max_batch=max_batch, **runner_opts)
        if model_uri:
            self.registry.load(model_uri)
        self.tenants = None
        if tenancy:
            from dmlc_core_tpu_torch.serve.tenancy import TenantRegistry
            self.tenants = TenantRegistry(device=device,
                                          max_batch=max_batch,
                                          **runner_opts)
        self.frontend = ReplicaFrontend(
            self.registry, on_shutdown=self._stop.set, host=host,
            port=port, max_batch=max_batch, max_delay=max_delay,
            max_queue=max_queue, tenants=self.tenants)
        self.frontend.start()
        # the persistent session IS the liveness contract: if this
        # process dies, the tracker sees the socket close and evicts us
        self.session = WorkerSession(tracker_uri, tracker_port,
                                     host=f"{host}:{self.frontend.port}")
        self.rank = int(self.session.info["rank"])
        self.frontend.rank = self.rank
        reply = self.session.request({"cmd": "serve_register",
                                      "rank": self.rank,
                                      "url": self.frontend.url})
        CHECK(reply.get("ok"), f"fleet registration refused: {reply}")
        self._heartbeat_s = (heartbeat_s if heartbeat_s is not None
                             else _heartbeat_s())
        self._hb = threading.Thread(target=self._heartbeat_loop,
                                    daemon=True,
                                    name=f"fleet-hb-{self.rank}")
        self._hb.start()
        LOG("INFO", "fleet.replica rank %d: serving %s at %s",
            self.rank, name, self.frontend.url)

    @property
    def url(self) -> str:
        """Predict base URL of this replica's frontend."""
        return self.frontend.url

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._heartbeat_s):
            try:
                if self.tenants is not None:
                    self.session.request({"cmd": "serve_report",
                                          "rank": self.rank,
                                          "load": self.frontend.load_report(),
                                          "tenants": self.tenants.summary()})
                else:
                    self.session.request(
                        {"cmd": "serve_report", "rank": self.rank,
                         "load": self.frontend.load_report()})
            except Exception:  # noqa: BLE001 — tracker gone → stop beating
                return

    def run(self, timeout: Optional[float] = None) -> bool:
        """Block until shutdown is requested (admin RPC, :meth:`stop`,
        or SIGTERM in :func:`replica_main`).  True = stop was set."""
        return self._stop.wait(timeout)

    def stop(self) -> None:
        """Request shutdown (unblocks :meth:`run`)."""
        self._stop.set()

    def close(self, clean: bool = True) -> None:
        """Drain + retire: graceful frontend close, heartbeat stop, and
        a clean tracker goodbye (``clean=False`` just drops the socket,
        which the tracker records as a death — test hook)."""
        self._stop.set()
        self._hb.join(timeout=2.0)
        self.frontend.close(drain=clean)
        if clean:
            try:
                self.session.shutdown()
            except Exception:  # noqa: BLE001 — tracker may be gone already
                self.session.close()
        else:
            self.session.close()


def replica_env(tracker_uri: str, tracker_port: int,
                model_uri: Optional[str] = None, name: str = "fleet",
                max_batch: int = 64, max_queue: int = 256,
                tenancy: bool = False,
                extra_env: Optional[Dict[str, str]] = None
                ) -> Dict[str, str]:
    """The ``FLEET_*`` env overlay a replica subprocess is spawned with
    (pure — the golden env tests snapshot this)."""
    env = {"FLEET_TRACKER_URI": tracker_uri,
           "FLEET_TRACKER_PORT": str(tracker_port),
           "FLEET_NAME": name,
           "FLEET_MAX_BATCH": str(max_batch),
           "FLEET_MAX_QUEUE": str(max_queue)}
    if model_uri:
        env["FLEET_MODEL_URI"] = model_uri
    if tenancy:
        env["FLEET_TENANCY"] = "1"
    # `python -m dmlc_core_tpu_torch...` resolves against the child's
    # cwd, not the parent's sys.path — pin the package root so
    # supervised replicas import regardless of where the caller was
    # launched
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    prior = os.environ.get("PYTHONPATH", "")
    env["PYTHONPATH"] = (pkg_root + os.pathsep + prior) if prior \
        else pkg_root
    env.update(extra_env or {})
    return env


REPLICA_COMMAND = [sys.executable, "-m",
                   "dmlc_core_tpu_torch.serve.fleet.replica"]

_spawn_lock = threading.Lock()
_spawn_transport: Optional[Any] = None
_spawn_seq = 0


def spawn_replica(tracker_uri: str, tracker_port: int,
                  model_uri: Optional[str] = None, name: str = "fleet",
                  max_batch: int = 64, max_queue: int = 256,
                  tenancy: bool = False,
                  extra_env: Optional[Dict[str, str]] = None
                  ) -> "subprocess.Popen[bytes]":
    """Launch a replica as a child process (``python -m
    dmlc_core_tpu_torch.serve.fleet.replica``) wired to the tracker via the
    ``FLEET_*`` env ABI.  Used by the local autoscale backend, the
    fleet drill, and ``bench.py --fleet``.  The spawned replica is
    *ready* once its rank appears in ``tracker.serve_endpoints()``.

    Spawns through :class:`~dmlc_core_tpu_torch.launch.LocalTransport` (child
    carries ``PR_SET_PDEATHSIG``, output captured to a per-replica log
    file) but still returns the raw ``Popen`` for callers that wait/kill
    directly; supervised fleets use :class:`LauncherScaler` instead.
    """
    global _spawn_transport, _spawn_seq
    from dmlc_core_tpu_torch.launch import LocalTransport

    with _spawn_lock:
        if _spawn_transport is None:
            _spawn_transport = LocalTransport()
        _spawn_seq += 1
        seq = _spawn_seq
    handle = _spawn_transport.spawn(
        REPLICA_COMMAND,
        replica_env(tracker_uri, tracker_port, model_uri=model_uri,
                    name=name, max_batch=max_batch, max_queue=max_queue,
                    tenancy=tenancy, extra_env=extra_env),
        _spawn_transport.hosts()[0], label=f"{name}-replica-{seq}")
    return handle.proc


def replica_main(argv: Optional[List[str]] = None) -> int:
    """Subprocess entry: build a :class:`Replica` from the ``FLEET_*``
    env ABI and serve until ``/admin/shutdown`` or SIGTERM.  The device
    is ``FLEET_DEVICE`` (unset: ``cuda``); one that cannot be reached
    raises here, before the replica registers."""
    del argv
    tracker_uri = os.environ.get("FLEET_TRACKER_URI", "127.0.0.1")
    tracker_port = int(os.environ["FLEET_TRACKER_PORT"])
    device = resolve_device(os.environ.get("FLEET_DEVICE") or None)
    replica = Replica(
        tracker_uri, tracker_port,
        name=os.environ.get("FLEET_NAME", "fleet"),
        port=int(os.environ.get("FLEET_PORT", "0")),
        model_uri=os.environ.get("FLEET_MODEL_URI") or None,
        max_batch=int(os.environ.get("FLEET_MAX_BATCH", "64")),
        max_delay=float(os.environ.get("FLEET_MAX_DELAY", "0.002")),
        max_queue=int(os.environ.get("FLEET_MAX_QUEUE", "256")),
        tenancy=os.environ.get("FLEET_TENANCY", "") == "1",
        device=device)
    from dmlc_core_tpu_torch.base import metrics_agg as _agg
    _agg.install_spool("replica", replica.rank)
    signal.signal(signal.SIGTERM, lambda *_: replica.stop())
    replica.run()
    replica.close(clean=True)
    return 0


if __name__ == "__main__":
    sys.exit(replica_main(sys.argv[1:]))
