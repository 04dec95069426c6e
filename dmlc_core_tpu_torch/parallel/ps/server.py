"""Parameter-server processes: the scheduler and the key-range server.

Reference parity: ps-lite's ``Postoffice`` (scheduler: node discovery,
id assignment) and ``KVServer`` (range shard: server-side aggregation +
optimizer), bootstrapped off the same ``DMLC_PS_ROOT_URI/PORT`` +
``DMLC_ROLE`` env ABI dmlc-core's ``PSTracker`` exports (SURVEY.md
§2c).  The wire is the tracker's JSON-lines idiom with raw array frames
(``ps/wire.py``); the consistency model is bounded staleness (SSP, Ho
et al. NIPS'13): each server tracks a vector clock of worker progress
and a pull at worker clock ``c`` with window ``tau`` blocks until every
worker has reached ``c - tau``.

Durability: a server snapshots its shard (weights + meta + vector
clock, pickled into one leaf) through the atomic CRC'd checkpoint
substrate (``parallel/checkpoint.py``, ``local=True`` — no collective
in the commit path) every ``DMLC_PS_SNAPSHOT_STRIDE`` committed clock
ticks, and restores from the newest valid snapshot at startup — a
SIGKILLed server respawned with the same ``server_id`` rejoins at most
one stride behind (the ``scripts/check_ps.py`` drill).

Fault injection: the ``ps_push`` point fires in the push handler
(``DMLC_FAULT_INJECT="ps_push:kill:after=K"`` SIGKILLs the server on
its K+1-th push — the drill's trigger).
"""

from __future__ import annotations

import os
import pickle
import signal
import socket
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import faultinject as _fi
from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base import tracectx as _tracectx
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.parallel.ps import wire
from dmlc_core_tpu_torch.parallel.ps.partition import server_ranges
from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

__all__ = ["PSScheduler", "PSServer", "ps_metrics"]

_PM = None


def ps_metrics():
    """Lazy ``dmlc_ps_*`` instrument bundle (shared by server and
    client; declared once per process on the default registry)."""
    global _PM
    if _PM is None:
        r = _metrics.default_registry()
        _PM = {
            "push": r.histogram(
                "ps_push_seconds",
                "client-observed push RPC latency (send to ack)"),
            "pull": r.histogram(
                "ps_pull_seconds",
                "client-observed pull RPC latency, staleness wait "
                "included"),
            "keys": r.counter(
                "ps_keys_synced_total",
                "sparse keys moved through push/pull",
                labels=("op",)),
            "staleness": r.gauge(
                "ps_staleness_rounds",
                "clock lag behind the slowest worker observed at the "
                "last pull (bounded-staleness window occupancy)"),
            "requests": r.counter(
                "ps_server_requests_total",
                "requests handled by this PS server shard",
                labels=("cmd",)),
            "restores": r.counter(
                "ps_server_restores_total",
                "server startups that restored state from a "
                "snapshot"),
        }
    return _PM


class PSScheduler(RabitTracker):
    """The PS control plane: server-id assignment + endpoint discovery.

    A :class:`~dmlc_core_tpu_torch.tracker.tracker.RabitTracker` subclass —
    same TCP/JSON-lines service, same locking and liveness machinery —
    with the PS commands added through the ``_handle_ext`` hook:

    * ``ps_register`` ``{host, port, server_id}`` — a server announces
      its data-plane endpoint.  ``server_id`` -1 assigns the next free
      id; a respawned server passes its old id and just overwrites the
      endpoint (restore-in-place, the drill's recovery path).
    * ``ps_servers`` ``{}`` — the current endpoint map plus ``ready``
      (all ``nserver`` registered); clients poll until ready.

    Workers end the job with the base protocol's ``shutdown`` (counted
    to ``nworker``), so ``join()`` keeps its meaning.
    """

    def __init__(self, host_ip: str = "127.0.0.1", nworker: int = 1,
                 nserver: int = 1, port: int = 0,
                 grace_s: Optional[float] = None):
        super().__init__(host_ip=host_ip, nworker=nworker, port=port,
                         grace_s=grace_s)
        CHECK(nserver >= 1, "PSScheduler needs at least one server")
        self.nserver = nserver
        # guarded by the base tracker's self._lock, like all membership
        self._ps_endpoints: Dict[int, Tuple[str, int]] = {}
        self._ps_next_id = 0

    def _handle_ext(self, cmd: Any, msg: Dict[str, Any],
                    conn: Optional[socket.socket],
                    state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        if cmd == "ps_register":
            sid = int(msg.get("server_id", -1))
            with self._lock:
                if sid < 0:
                    sid = self._ps_next_id
                    self._ps_next_id += 1
                elif sid >= self._ps_next_id:
                    self._ps_next_id = sid + 1
                self._ps_endpoints[sid] = (str(msg["host"]),
                                           int(msg["port"]))
            if sid >= self.nserver:
                return {"error": f"too many servers (nserver="
                                 f"{self.nserver})"}
            LOG("INFO", "ps.scheduler: server %d registered at %s:%s",
                sid, msg["host"], msg["port"])
            return {"server_id": sid, "nserver": self.nserver,
                    "nworker": self.nworker}
        if cmd == "ps_servers":
            with self._lock:
                eps = {str(k): list(v)
                       for k, v in self._ps_endpoints.items()}
            return {"ready": len(eps) >= self.nserver, "servers": eps,
                    "nworker": self.nworker}
        return super()._handle_ext(cmd, msg, conn, state)


class PSServer:
    """One key-range shard: aggregation buffers + SGD + vector clock.

    Owns the contiguous slice ``server_ranges(n_keys, nserver)[sid]``
    of every named array (the cut is re-derived per array at ``init``
    from the array's own key cardinality).  Handles, per connection
    thread (the tracker's serve-loop idiom):

    * ``init``    — declare an array (idempotent; first writer wins)
    * ``push``    — ``ids, grads`` → ``w[ids] -= lr * grads`` under the
      shard lock (server-side aggregation: duplicate ids within a
      batch accumulate via ``np.add.at``), then advance the pusher's
      vector-clock entry
    * ``pull``    — block while ``min(vclock) < clock - staleness``
      (SSP), then return ``w[ids]``
    * ``clock``   — explicit clock advance (a worker whose minibatch
      touched no key in this shard must still make progress visible)
    * ``pull_range`` — the full owned slice (final weights / rebalance)
    * ``bye``     — worker disconnect; the server exits once every
      worker said bye

    Start with :meth:`start` (registers with the scheduler, spawns the
    accept loop); :meth:`serve_forever` blocks until shutdown.
    """

    def __init__(self, scheduler_uri: str, scheduler_port: int,
                 host_ip: str = "127.0.0.1", port: int = 0,
                 server_id: int = -1,
                 snapshot_dir: Optional[str] = None,
                 snapshot_stride: Optional[int] = None):
        from dmlc_core_tpu_torch.base import knobs as _knobs

        if snapshot_dir is None:
            snapshot_dir = str(_knobs.value("DMLC_PS_SNAPSHOT_DIR"))
        if snapshot_stride is None:
            snapshot_stride = int(_knobs.value("DMLC_PS_SNAPSHOT_STRIDE"))
        self._snap_dir = snapshot_dir
        self._snap_stride = snapshot_stride
        self._sched = (scheduler_uri, scheduler_port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host_ip, port))
        self._sock.listen(64)
        self.host_ip = host_ip
        self.port = self._sock.getsockname()[1]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._serve_threads: List[threading.Thread] = []
        # shard state, all guarded by self._lock
        self._meta: Dict[str, Dict[str, Any]] = {}
        self._arrays: Dict[str, np.ndarray] = {}
        self._vclock: Dict[int, int] = {}
        self._byes = 0
        self._last_snap = 0
        self.restored_version = 0       # drill-observable restore marker
        # registration: one-shot scheduler round trip (tracker JSON
        # framing; the header-only side of the ps wire)
        with socket.create_connection((scheduler_uri, scheduler_port),
                                      timeout=10) as s:
            f = s.makefile("rwb")
            wire.send_msg(f, {"cmd": "ps_register", "host": host_ip,
                              "port": self.port, "server_id": server_id})
            reply, _ = wire.recv_msg(f)
        CHECK("error" not in reply,
              f"ps.server: scheduler rejected registration: {reply}")
        self.server_id = int(reply["server_id"])
        self.nserver = int(reply["nserver"])
        self.nworker = int(reply["nworker"])
        with self._lock:
            for r in range(self.nworker):
                self._vclock[r] = 0
        if self._snap_dir:
            self._restore()
        # join the fleet metrics spool (no-op without DMLC_METRICS_SPOOL)
        from dmlc_core_tpu_torch.base import metrics_agg as _agg

        _agg.install_spool("ps_server", self.server_id)

    # -- snapshot / restore ----------------------------------------------
    def _snapshot_uri(self) -> str:
        return os.path.join(self._snap_dir,
                            f"ps-server-{self.server_id}.ckpt")

    def _maybe_snapshot_locked(self) -> None:
        """Snapshot when the committed clock advanced a full stride
        past the last snapshot (caller holds the lock)."""
        if not self._snap_dir or self._snap_stride <= 0:
            return
        floor = min(self._vclock.values()) if self._vclock else 0
        if floor < self._last_snap + self._snap_stride:
            return
        from dmlc_core_tpu_torch.parallel.checkpoint import checkpoint

        blob = pickle.dumps({"meta": self._meta,
                             "arrays": self._arrays,
                             "vclock": self._vclock})
        checkpoint(self._snapshot_uri(),
                   {"blob": np.frombuffer(blob, np.uint8)},
                   version=floor, local=True)
        self._last_snap = floor

    def _restore(self) -> None:
        from dmlc_core_tpu_torch.parallel.checkpoint import load_checkpoint

        like = {"blob": np.zeros(0, np.uint8)}
        version, state = load_checkpoint(self._snapshot_uri(), like)
        if not version:
            return
        payload = pickle.loads(state["blob"].tobytes())
        with self._lock:
            self._meta = payload["meta"]
            self._arrays = payload["arrays"]
            self._vclock = {int(k): int(v)
                            for k, v in payload["vclock"].items()}
            self._last_snap = int(version)
        self.restored_version = int(version)
        if _metrics.enabled():
            ps_metrics()["restores"].inc(1)
        LOG("INFO", "ps.server %d: restored snapshot v%d (%d arrays)",
            self.server_id, version, len(payload["arrays"]))

    # -- service loop ----------------------------------------------------
    def start(self) -> None:
        """Spawn the accept loop (daemon thread)."""
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every worker said ``bye`` (or ``timeout_s``).
        Returns True on clean shutdown."""
        done = self._done.wait(timeout_s)
        self.stop()
        return done

    def stop(self) -> None:
        """Close the listening socket and wake the accept loop."""
        self._done.set()
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        # reap connection threads (daemon threads that own self._lock
        # must not outlive stop()) and the accept loop, bounded
        with self._lock:
            serve_threads = list(self._serve_threads)
            self._serve_threads.clear()
        me = threading.current_thread()
        for t in serve_threads:
            if t is not me:
                t.join(timeout=2.0)
        if self._thread is not None and self._thread is not me:
            self._thread.join(timeout=2.0)

    def _accept_loop(self) -> None:
        while not self._done.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            with self._lock:
                self._serve_threads = [x for x in self._serve_threads
                                       if x.is_alive()]
                self._serve_threads.append(t)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        """One worker connection: framed request/reply until EOF."""
        try:
            with conn:
                f = conn.makefile("rwb")
                while not self._done.is_set():
                    msg, arrays = wire.recv_msg(f)
                    # join the sender's distributed trace for this
                    # request so the server-side span lands in the same
                    # timeline (no-op when DMLC_TRACE is off)
                    with _tracectx.attach(msg.get(_tracectx.WIRE_KEY)):
                        with _tracectx.span(
                                f"ps.server.{msg.get('cmd')}"):
                            reply, out = self._handle(msg, arrays)
                        wire.send_msg(f, reply, out)
        except (ConnectionError, OSError):
            pass

    # -- request dispatch ------------------------------------------------
    def _handle(self, msg: Dict[str, Any], arrays: List[np.ndarray]
                ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        cmd = msg.get("cmd")
        if _metrics.enabled():
            ps_metrics()["requests"].inc(1, cmd=str(cmd))
        if cmd == "init":
            return self._handle_init(msg, arrays)
        if cmd == "push":
            return self._handle_push(msg, arrays)
        if cmd == "pull":
            return self._handle_pull(msg, arrays)
        if cmd == "clock":
            return self._handle_clock(msg)
        if cmd == "pull_range":
            return self._handle_pull_range(msg)
        if cmd == "bye":
            with self._cond:
                self._byes += 1
                byes = self._byes
                # a departed worker must not hold the SSP floor: its
                # clock is frozen forever, so leaving it in the vector
                # clock deadlocks every surviving reader that is more
                # than tau ahead of it
                self._vclock.pop(int(msg.get("rank", -1)), None)
                self._cond.notify_all()
            if byes >= self.nworker:
                self._done.set()
            return {"ok": 1}, []
        if cmd == "ping":
            return {"ok": 1, "server_id": self.server_id}, []
        return {"error": f"unknown cmd {cmd!r}"}, []

    def _range_of(self, n_keys: int) -> Tuple[int, int]:
        return server_ranges(n_keys, self.nserver)[self.server_id]

    def _handle_init(self, msg: Dict[str, Any],
                     arrays: List[np.ndarray]
                     ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        name = str(msg["name"])
        n_keys = int(msg["n_keys"])
        width = tuple(int(w) for w in msg.get("width", []))
        lo, hi = self._range_of(n_keys)
        with self._cond:
            if name not in self._meta:     # first init wins (idempotent)
                if arrays:
                    a = np.array(arrays[0], np.dtype(str(msg["dtype"])))
                    CHECK(a.shape == (hi - lo,) + width,
                          f"ps init {name!r}: slice shape {a.shape} != "
                          f"{(hi - lo,) + width}")
                elif float(msg.get("init_scale", 0.0)) > 0.0:
                    # server-local random init: seeded by (seed, lo) so
                    # the draw is a pure function of the key range —
                    # identical across respawns and re-ranges, and no
                    # host ever holds the whole array
                    rng = np.random.default_rng(
                        (int(msg.get("seed", 0)), lo))
                    a = (rng.standard_normal((hi - lo,) + width)
                         * float(msg["init_scale"])
                         ).astype(np.dtype(str(msg["dtype"])))
                else:
                    a = np.zeros((hi - lo,) + width,
                                 np.dtype(str(msg["dtype"])))
                self._meta[name] = {"n_keys": n_keys, "width": width,
                                    "dtype": str(msg["dtype"]),
                                    "lr": float(msg.get("lr", 0.1)),
                                    "lo": lo, "hi": hi}
                self._arrays[name] = a
        return {"ok": 1, "lo": lo, "hi": hi}, []

    def _handle_push(self, msg: Dict[str, Any],
                     arrays: List[np.ndarray]
                     ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        fault = _fi.check("ps_push")
        if fault is not None and fault.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        name = str(msg["name"])
        rank, clock = int(msg["rank"]), int(msg["clock"])
        ids, grads = arrays[0], arrays[1]
        with self._cond:
            meta = self._meta.get(name)
            if meta is None:
                return {"error": f"ps push: unknown array {name!r}"}, []
            a = self._arrays[name]
            idx = np.asarray(ids, np.int64) - meta["lo"]
            # server-side aggregation + SGD in one pass: duplicate ids
            # within the batch accumulate exactly (np.add.at)
            np.add.at(a, idx, (-meta["lr"] * grads).astype(a.dtype,
                                                           copy=False))
            if rank in self._vclock and clock > self._vclock[rank]:
                self._vclock[rank] = clock
            self._maybe_snapshot_locked()
            floor = min(self._vclock.values()) if self._vclock else 0
            self._cond.notify_all()
        if _metrics.enabled():
            ps_metrics()["keys"].inc(len(ids), op="push")
        return {"ok": 1, "min_clock": floor}, []

    def _handle_pull(self, msg: Dict[str, Any],
                     arrays: List[np.ndarray]
                     ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        from dmlc_core_tpu_torch.base.timer import get_time

        name = str(msg["name"])
        clock = int(msg.get("clock", 0))
        tau = int(msg.get("staleness", -1))
        timeout_s = float(msg.get("timeout_s", 60.0))
        ids = arrays[0]
        deadline = get_time() + timeout_s
        with self._cond:
            meta = self._meta.get(name)
            if meta is None:
                return {"error": f"ps pull: unknown array {name!r}"}, []
            # SSP gate: a reader at clock c may proceed only once every
            # worker's committed clock reached c - tau
            while tau >= 0 and self._vclock and (
                    min(self._vclock.values()) < clock - tau):
                left = deadline - get_time()
                if left <= 0 or self._done.is_set():
                    return {"error": "ps pull: staleness wait timed "
                                     f"out (clock={clock} tau={tau} "
                                     f"vclock={self._vclock})"}, []
                self._cond.wait(min(left, 0.5))
            a = self._arrays[name]
            idx = np.asarray(ids, np.int64) - meta["lo"]
            vals = np.ascontiguousarray(a[idx])
            floor = min(self._vclock.values()) if self._vclock else 0
        if _metrics.enabled():
            ps_metrics()["keys"].inc(len(ids), op="pull")
        return {"ok": 1, "min_clock": floor}, [vals]

    def _handle_clock(self, msg: Dict[str, Any]
                      ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        rank, clock = int(msg["rank"]), int(msg["clock"])
        with self._cond:
            if rank in self._vclock and clock > self._vclock[rank]:
                self._vclock[rank] = clock
            self._maybe_snapshot_locked()
            floor = min(self._vclock.values()) if self._vclock else 0
            self._cond.notify_all()
        return {"ok": 1, "min_clock": floor}, []

    def _handle_pull_range(self, msg: Dict[str, Any]
                           ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        name = str(msg["name"])
        with self._cond:
            meta = self._meta.get(name)
            if meta is None:
                return {"error": f"ps pull_range: unknown array "
                                 f"{name!r}"}, []
            vals = np.ascontiguousarray(self._arrays[name])
            lo, hi = meta["lo"], meta["hi"]
        return {"ok": 1, "lo": lo, "hi": hi}, [vals]
