"""Coordination services: RabitTracker (rank + topology) and PSTracker.

Reference parity: ``tracker/dmlc_tracker/tracker.py :: RabitTracker``
(bind TCP port; accept worker cmds start/recover/shutdown/print; assign
ranks host-aware; send each worker num_worker, tree parent/children and
ring prev/next, computed by get_tree/find_share_ring), ``PSTracker``
(ps-lite role bootstrap), and ``submit()`` glue (SURVEY.md §2c).

Wire protocol: newline-delimited JSON (this framework's own framing — the
reference's binary ``ExSocket`` framing belonged to rabit's C++ client,
which doesn't exist here).  This service exists for legacy/external
workers, for launch-time rank bookkeeping on ssh clusters and for the
serving fleet's control plane.

The PyTorch port's counterpart of ``dmlc_core_tpu/tracker/tracker.py``:
the same wire protocol, commands, env ABI and metric names, so a worker
or replica of either package talks to a tracker of the other.  Torch
workers do not connect either: ``parallel.collectives.init`` hands
``DMLC_TRACKER_URI:PORT`` to ``torch.distributed``'s TCP store.  The
topology comes from the port's ``parallel.collectives.get_link_map``.
:class:`PSTracker.start` hosts the port's ``parallel/ps`` scheduler, as
the JAX package's does.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Any, Callable, Dict, List, Optional

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.racecheck import instrument_class
from dmlc_core_tpu_torch.base import tracectx as _tracectx
from dmlc_core_tpu_torch.base.logging import CHECK, LOG, log_fatal
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.utils.profiler import global_tracer, tracing_enabled

__all__ = ["RabitTracker", "WorkerSession", "PSTracker", "submit"]

_TM = None


def _tracker_metrics():
    global _TM
    if _TM is None:
        r = _metrics.default_registry()
        _TM = {
            "connections": r.gauge("tracker_connections",
                                   "worker connections currently served"),
            "alive": r.gauge("tracker_workers_alive",
                             "ranks with a live persistent connection"),
            "events": r.counter("tracker_worker_events_total",
                                "worker lifecycle events",
                                labels=("event",)),
            "deaths": r.counter("worker_deaths_total",
                                "persistent workers lost past recovery "
                                "decisions: reconnected inside the grace "
                                "window (rejoined) or declared dead "
                                "(evicted)",
                                labels=("outcome",)),
            "floor": r.gauge("recovery_floor_round",
                             "last globally-committed boosting round (the "
                             "elastic-recovery resume floor)"),
        }
    return _TM


def _worker_event(event: str, rank: int = -1) -> None:
    """One lifecycle event → counter + (when tracing) a trace instant —
    the worker-churn timeline the reference's tracker only logged."""
    if _metrics.enabled():
        _tracker_metrics()["events"].inc(1, event=event)
    if tracing_enabled():
        global_tracer().instant(f"tracker.{event}", rank=rank)


@instrument_class
class RabitTracker:
    """Rank-assignment + topology service over TCP/JSON lines."""

    def __init__(self, host_ip: str = "127.0.0.1", nworker: int = 1, port: int = 0,
                 grace_s: Optional[float] = None):
        self.nworker = nworker
        #: reconnect grace window (seconds).  A persistent worker whose
        #: socket closes uncleanly is NOT declared dead immediately when
        #: the window is > 0: its rank is reserved for ``grace_s`` so a
        #: restarting worker can ``recover`` it (a pod reschedule, an ssh
        #: blip).  Only when the window expires does the rank join the
        #: free list and the death history.  Default 0 (immediate death,
        #: the historical behavior); env ``DMLC_TRACKER_GRACE_S`` sets
        #: the process-wide default.
        if grace_s is None:
            try:
                grace_s = float(os.environ.get("DMLC_TRACKER_GRACE_S", "0"))
            except ValueError:
                grace_s = 0.0
        self.grace_s = grace_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host_ip, port))
        self._sock.listen(max(16, nworker))
        self.host_ip = host_ip
        self.port = self._sock.getsockname()[1]
        # deferred import, where the JAX module has it (there it breaks
        # an import cycle through parallel/recovery; the port has no such
        # cycle and keeps the import here only to mirror that module)
        from dmlc_core_tpu_torch.parallel.collectives import get_link_map

        self._links = get_link_map(nworker)
        self._next_rank = 0
        self._host_rank: Dict[str, int] = {}  # host-aware rank reuse
        self._shutdown_count = 0
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._serve_threads: List[threading.Thread] = []
        # Liveness bookkeeping (reference holds worker connections open for
        # the whole job, so a dying worker is observable; same here for
        # workers that handshake with persistent=True via WorkerSession).
        self._alive: Dict[int, socket.socket] = {}   # rank -> live conn
        self._free_ranks: List[int] = []             # ranks freed by death
        self.dead_workers: List[int] = []            # death history (ranks)
        self._pending_death: Dict[int, float] = {}   # rank -> grace deadline
        #: deadline-driven grace expiry: lazy expiry (on message arrival)
        #: left a silent cluster blind to lapsed deadlines — this timer
        #: fires at the earliest pending deadline so ``lost_ranks()`` /
        #: ``dead_workers`` stay accurate through quiet training rounds
        self._grace_timer: Optional[threading.Timer] = None
        # recovery-floor bookkeeping (rabit's CheckPoint version_number
        # consensus): per-rank last durably-committed boosting round, and
        # the floor = the highest round committed by EVERY expected rank
        self._commits: Dict[int, int] = {}
        self._floor = 0

    # -- env ABI ---------------------------------------------------------
    def slave_envs(self) -> Dict[str, str]:
        """Env vars every worker must see.  Reference: ``slave_envs()``."""
        return {
            "DMLC_TRACKER_URI": self.host_ip,
            "DMLC_TRACKER_PORT": str(self.port),
            "DMLC_NUM_WORKER": str(self.nworker),
        }

    # -- service loop ----------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

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
        """Serve one worker connection until it closes.

        The connection is held open (the reference's tracker keeps one
        socket per worker for the job's lifetime): a worker may send any
        number of commands as JSON lines.  If the worker handshook with
        ``persistent: true`` and the socket closes before it sent
        ``shutdown``, the tracker records the death, logs it, and frees the
        rank for a replacement worker (``start`` reuses freed ranks).
        """
        state: Dict[str, Any] = {"rank": -1, "persistent": False, "clean": False}
        if _metrics.enabled():
            _tracker_metrics()["connections"].inc(1)
        try:
            with conn:
                buf = b""
                while not self._done.is_set():
                    while b"\n" not in buf:
                        data = conn.recv(4096)
                        if not data:
                            raise ConnectionResetError  # EOF → liveness check below
                        buf += data
                    line, buf = buf.split(b"\n", 1)
                    try:
                        msg = json.loads(line)
                    except json.JSONDecodeError as e:
                        # a garbled line is not a death certificate: skip it
                        LOG("WARNING", "tracker: bad worker message: %s", e)
                        continue
                    # adopt the worker's trace context (the optional
                    # "trace" framing field) so tracker-side handling
                    # lands in the same distributed trace
                    with _tracectx.attach(msg.get(_tracectx.WIRE_KEY)), \
                            _tracectx.span(
                                f"tracker.{msg.get('cmd')}"):
                        reply = self._handle(msg, conn, state)
                    if reply is not None:
                        conn.sendall(json.dumps(reply).encode() + b"\n")
                    if state["clean"]:
                        return
        except (ConnectionResetError, OSError):
            pass
        finally:
            self._on_disconnect(state)
            if _metrics.enabled():
                _tracker_metrics()["connections"].dec(1)

    def _on_disconnect(self, state: Dict[str, Any]) -> None:
        rank = state["rank"]
        if rank < 0 or not state["persistent"]:
            return  # one-shot legacy connection: close is not a death signal
        with self._lock:
            # only the CURRENT owner's close is a death: a worker that
            # reconnected ('recover') replaced _alive[rank] with its new
            # socket, and the stale connection's eventual close must not
            # evict the live worker or hand its rank to a replacement
            if self._alive.get(rank) is not state.get("conn"):
                return
            del self._alive[rank]
            if _metrics.enabled():
                _tracker_metrics()["alive"].set(len(self._alive))
            if not state["clean"]:
                if self.grace_s > 0:
                    # reserve the rank: a reconnect inside the window is a
                    # blip, not a death — the rank is handed out again only
                    # after the grace deadline lapses (checked lazily on
                    # message arrival AND by the armed deadline timer)
                    self._pending_death[rank] = get_time() + self.grace_s
                    self._arm_grace_timer_locked()
                    _worker_event("lost", rank)
                    LOG("WARNING", "tracker: worker rank %d lost (socket "
                        "closed without shutdown); holding rank for %.1fs "
                        "grace", rank, self.grace_s)
                else:
                    self.dead_workers.append(rank)
                    self._free_ranks.append(rank)
                    _worker_event("death", rank)
                    if _metrics.enabled():
                        _tracker_metrics()["deaths"].inc(1, outcome="evicted")
                    LOG("WARNING", "tracker: worker rank %d died (socket closed "
                        "without shutdown); rank freed for recovery", rank)
            self._membership_event_locked(
                "death" if not state["clean"] and self.grace_s <= 0
                else ("lost" if not state["clean"] else "shutdown"), rank)

    def _expire_graces_locked(self) -> None:
        """Flush lapsed grace reservations into the death history + free
        list.  Caller holds ``_lock``."""
        if not self._pending_death:
            return
        now = get_time()
        for rank in [r for r, t in self._pending_death.items() if t <= now]:
            del self._pending_death[rank]
            self.dead_workers.append(rank)
            self._free_ranks.append(rank)
            _worker_event("death", rank)
            if _metrics.enabled():
                _tracker_metrics()["deaths"].inc(1, outcome="evicted")
            LOG("WARNING", "tracker: worker rank %d grace expired; rank "
                "freed for recovery", rank)
            self._membership_event_locked("death", rank)

    def _arm_grace_timer_locked(self) -> None:
        """(Re)schedule the deadline-driven expiry sweep at the earliest
        pending grace deadline.  Without it a cluster that goes silent
        (no tracker traffic during long training rounds) never notices a
        lapsed deadline until the next message arrives — the lazy-expiry
        bug: ``lost_ranks()``/``dead_workers`` were stale exactly when a
        recovery decision needed them.  Caller holds ``_lock``."""
        if self._grace_timer is not None:
            self._grace_timer.cancel()
            self._grace_timer = None
        if not self._pending_death or self._done.is_set():
            return
        delay = max(0.0, min(self._pending_death.values()) - get_time())
        t = threading.Timer(delay + 0.005, self._on_grace_deadline)
        t.daemon = True
        self._grace_timer = t
        t.start()

    def _on_grace_deadline(self) -> None:
        with self._lock:
            self._expire_graces_locked()
            self._arm_grace_timer_locked()

    def _membership_event_locked(self, kind: str, rank: int) -> None:
        """Hook: liveness changed (``lost``/``death``/``reconnect``/
        ``shutdown``).  Called with ``_lock`` held from the disconnect
        handler, the grace-expiry sweep, and the recover path; the base
        tracker does nothing — the elastic recovery layer
        (``parallel.recovery.ElasticTracker``) overrides it to abort
        in-flight collectives and re-form the worker group."""

    # -- recovery floor (rabit CheckPoint version consensus) -------------
    def _expected_ranks_locked(self) -> List[int]:
        """Ranks whose commits gate the recovery floor — the full
        configured world by default (an elastic subclass narrows this to
        the current epoch's members)."""
        return list(range(self.nworker))

    def _record_commit_locked(self, rank: int, round_no: int) -> int:
        self._commits[rank] = max(self._commits.get(rank, 0), int(round_no))
        expected = self._expected_ranks_locked()
        floor = min((self._commits.get(r, 0) for r in expected), default=0)
        if floor > self._floor:
            self._floor = floor
            if _metrics.enabled():
                _tracker_metrics()["floor"].set(floor)
        return self._floor

    def record_commit(self, rank: int, round_no: int) -> int:
        """Record that ``rank`` durably committed ``round_no`` (its
        round-versioned checkpoint hit disk) and return the new recovery
        floor: the highest round committed by EVERY expected rank — the
        round a dead worker can rejoin from with nothing lost."""
        with self._lock:
            return self._record_commit_locked(rank, round_no)

    def recovery_floor(self) -> int:
        """Last globally-committed round (0 before the first full commit
        wave) — rabit's "last agreed-upon version"."""
        with self._lock:
            return self._floor

    def alive_ranks(self) -> List[int]:
        """Ranks with a live persistent connection right now."""
        with self._lock:
            return sorted(self._alive)

    def lost_ranks(self) -> List[int]:
        """Ranks inside their reconnect grace window (reserved, not yet
        declared dead)."""
        with self._lock:
            self._expire_graces_locked()
            return sorted(self._pending_death)

    def _handle(self, msg: Dict[str, Any], conn: Optional[socket.socket] = None,
                state: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        state = state if state is not None else {"rank": -1, "persistent": False,
                                                 "clean": False}
        cmd = msg.get("cmd")
        if cmd == "print":
            LOG("INFO", "worker: %s", msg.get("msg", ""))
            return None
        if cmd == "shutdown":
            state["clean"] = True
            _worker_event("shutdown", state["rank"])
            with self._lock:
                self._shutdown_count += 1
                if self._shutdown_count >= self.nworker:
                    self._done.set()
            return {"ok": True}
        if cmd == "commit":
            # rabit CheckPoint bookkeeping: a worker durably committed a
            # round-versioned checkpoint; reply with the global floor
            floor = self.record_commit(int(msg.get("rank", -1)),
                                       int(msg.get("round", 0)))
            return {"floor": floor}
        if cmd in ("start", "recover"):
            with self._lock:
                self._expire_graces_locked()
                if cmd == "recover" and "rank" in msg and msg["rank"] >= 0:
                    rank = int(msg["rank"])  # rejoining worker keeps its rank
                elif msg.get("host") and msg["host"] in self._host_rank and cmd == "recover":
                    rank = self._host_rank[msg["host"]]
                elif self._free_ranks:
                    rank = self._free_ranks.pop(0)  # replace a dead worker
                else:
                    rank = self._next_rank
                    self._next_rank += 1
                # the rank is now owned by this worker alone: it must not be
                # handed out again via the free list, a stale host mapping,
                # or a still-ticking grace reservation
                if rank in self._free_ranks:
                    self._free_ranks.remove(rank)
                if self._pending_death.pop(rank, None) is not None:
                    self._arm_grace_timer_locked()
                    _worker_event("reconnect", rank)
                    if _metrics.enabled():
                        _tracker_metrics()["deaths"].inc(1,
                                                         outcome="rejoined")
                    LOG("INFO", "tracker: worker rank %d reconnected within "
                        "the grace window", rank)
                    self._membership_event_locked("reconnect", rank)
                for h in [h for h, r in self._host_rank.items() if r == rank]:
                    del self._host_rank[h]
                if msg.get("host"):
                    self._host_rank[msg["host"]] = rank
                if rank < self.nworker and msg.get("persistent") and conn is not None:
                    state["rank"], state["persistent"] = rank, True
                    state["conn"] = conn
                    self._alive[rank] = conn
                    if _metrics.enabled():
                        _tracker_metrics()["alive"].set(len(self._alive))
            if rank >= self.nworker:
                return {"error": f"too many workers (nworker={self.nworker})"}
            _worker_event(cmd, rank)
            link = self._links[rank]
            return {
                "rank": rank,
                "num_worker": self.nworker,
                "parent": link["parent"],
                "children": link["children"],
                "ring_prev": link["ring_prev"],
                "ring_next": link["ring_next"],
            }
        ext = self._handle_ext(cmd, msg, conn, state)
        if ext is not None:
            return ext
        return {"error": f"unknown cmd {cmd!r}"}

    def _handle_ext(self, cmd: Any, msg: Dict[str, Any],
                    conn: Optional[socket.socket],
                    state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Hook: handle a subclass-specific command.  Called for any cmd
        the base protocol does not know; return a reply dict to claim
        it, or None to let the base answer ``unknown cmd`` — how the
        fleet tracker (``serve.fleet.replica.FleetTracker``) adds
        ``serve_register``/``serve_report`` without forking the
        dispatch."""
        return None

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until all workers sent 'shutdown'.

        Returns ``True`` if the job completed (all shutdowns received)
        within ``timeout``, ``False`` on timeout — so a partial shutdown
        (hung or dead worker) is observable instead of hanging forever.
        """
        return self._done.wait(timeout)

    def stop(self) -> None:
        self._done.set()
        with self._lock:
            if self._grace_timer is not None:
                self._grace_timer.cancel()
                self._grace_timer = None
            conns = list(self._alive.values())
            self._alive.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        # reap the connection-serving threads (their sockets just
        # closed, so each exits promptly) and the accept loop itself —
        # a daemon thread that owns self._lock must not outlive stop()
        with self._lock:
            serve_threads = list(self._serve_threads)
            self._serve_threads.clear()
        me = threading.current_thread()
        for t in serve_threads:
            if t is not me:
                t.join(timeout=2.0)
        if self._thread is not None and self._thread is not me:
            self._thread.join(timeout=2.0)

    # -- client side (worker) -------------------------------------------
    @staticmethod
    def worker_connect(uri: str, port: int, cmd: str = "start",
                       host: str = "", rank: int = -1) -> Dict[str, Any]:
        """Worker-side handshake (what rabit's C++ client did at Init)."""
        with socket.create_connection((uri, port), timeout=10) as s:
            s.sendall(json.dumps({"cmd": cmd, "host": host, "rank": rank}).encode() + b"\n")
            buf = b""
            while b"\n" not in buf:
                data = s.recv(4096)
                if not data:
                    log_fatal("tracker connection closed mid-handshake")
                buf += data
        return json.loads(buf.split(b"\n", 1)[0])


class WorkerSession:
    """Persistent worker-side connection to a :class:`RabitTracker`.

    Unlike :meth:`RabitTracker.worker_connect` (one-shot, legacy), a
    WorkerSession keeps its socket open for the whole job — mirroring how
    the reference's workers held their tracker socket — which is what makes
    dead-worker detection possible: if this process dies, the tracker sees
    the socket close without a ``shutdown`` and frees the rank.

    Usage::

        with WorkerSession(uri, port, host="node1") as ws:
            rank = ws.info["rank"]
            ...
            ws.shutdown()   # clean exit; omitting it == abnormal death
    """

    def __init__(self, uri: str, port: int, cmd: str = "start",
                 host: str = "", rank: int = -1):
        self._sock = socket.create_connection((uri, port), timeout=30)
        self.info = self._request({"cmd": cmd, "host": host, "rank": rank,
                                   "persistent": True})
        if "error" in self.info:
            self._sock.close()
            log_fatal("tracker rejected worker: %s" % self.info["error"])

    def _request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        trace = _tracectx.current_header()
        if trace is not None:
            msg = dict(msg)
            msg.setdefault(_tracectx.WIRE_KEY, trace)
        self._sock.sendall(json.dumps(msg).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            data = self._sock.recv(4096)
            if not data:
                log_fatal("tracker connection closed mid-request")
            buf += data
        return json.loads(buf.split(b"\n", 1)[0])

    def request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """One JSON request/reply round trip on the persistent socket —
        the worker half of any subclass command a tracker's
        ``_handle_ext`` hook serves (e.g. the fleet's
        ``serve_register``/``serve_report``)."""
        return self._request(msg)

    def print_msg(self, text: str) -> None:
        self._sock.sendall(json.dumps({"cmd": "print", "msg": text}).encode() + b"\n")

    def shutdown(self) -> None:
        self._request({"cmd": "shutdown"})
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "WorkerSession":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class PSTracker:
    """Parameter-server role bootstrap.

    Reference parity: ``tracker.py :: PSTracker`` — exports
    ``DMLC_PS_ROOT_URI/PORT`` and role env vars.  :meth:`start` hosts a
    :class:`~dmlc_core_tpu_torch.parallel.ps.PSScheduler` on this
    tracker's host/port, so processes launched with these envs and
    ``KVStore.create("dist_async")`` form a working
    scheduler/server/worker triad.
    """

    def __init__(self, host_ip: str = "127.0.0.1", port: int = 9092,
                 nworker: int = 1, nserver: int = 0):
        self.host_ip, self.port = host_ip, port
        self.nworker, self.nserver = nworker, nserver
        self._scheduler: Optional[Any] = None

    def start(self) -> None:
        """Host the PS scheduler in-process (port 0 binds a free port
        and updates ``self.port`` so the env ABI advertises it)."""
        from dmlc_core_tpu_torch.parallel.ps import PSScheduler

        self._scheduler = PSScheduler(
            host_ip=self.host_ip, port=self.port,
            nworker=self.nworker, nserver=max(1, self.nserver))
        self._scheduler.start()
        self.port = self._scheduler.port

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for every worker's shutdown (True when all arrived)."""
        CHECK(self._scheduler is not None, "PSTracker.join before start")
        return self._scheduler.join(timeout)

    def stop(self) -> None:
        if self._scheduler is not None:
            self._scheduler.stop()
            self._scheduler = None

    def slave_envs(self) -> Dict[str, str]:
        return {
            "DMLC_PS_ROOT_URI": self.host_ip,
            "DMLC_PS_ROOT_PORT": str(self.port),
            "DMLC_NUM_WORKER": str(self.nworker),
            "DMLC_NUM_SERVER": str(self.nserver),
        }

    def worker_envs(self) -> Dict[str, str]:
        return {**self.slave_envs(), "DMLC_ROLE": "worker"}

    def server_envs(self) -> Dict[str, str]:
        return {**self.slave_envs(), "DMLC_ROLE": "server"}

    def scheduler_envs(self) -> Dict[str, str]:
        return {**self.slave_envs(), "DMLC_ROLE": "scheduler"}


def submit(
    nworker: int,
    nserver: int,
    fun_submit: Callable[[int, Dict[str, str]], Any],
    host_ip: str = "127.0.0.1",
    start_tracker: bool = False,
) -> Optional[Any]:
    """Launch-glue.  Reference parity: ``tracker.py :: submit``.

    Picks rabit vs PS mode (``nserver == 0`` → rabit, like the reference),
    builds the env ABI, and calls ``fun_submit(nworker_total, envs)`` which
    performs the actual process launch (local/ssh backend).

    Torch workers coordinate through ``torch.distributed`` on
    ``DMLC_TRACKER_URI:PORT`` (rank 0 hosts the store), so the
    RabitTracker TCP service is only started when ``start_tracker=True``
    (legacy workers); it then runs on its *own* port, exported as
    ``DMLC_LEGACY_TRACKER_PORT``.  In PS mode ``start_tracker=True``
    hosts the PS scheduler in-process (``parallel/ps``) on a free port
    and returns the :class:`PSTracker` — launched processes bind their
    roles through ``KVStore.create("dist_async")``.
    """
    CHECK(nworker >= 1, "need at least one worker")
    envs: Dict[str, str] = {
        "DMLC_NUM_WORKER": str(nworker),
        "DMLC_NUM_SERVER": str(nserver),
    }
    tracker: Optional[Any] = None
    if nserver == 0:
        envs["DMLC_TRACKER_URI"] = host_ip
        envs["DMLC_TRACKER_PORT"] = str(_free_port(host_ip))
        if start_tracker:
            tracker = RabitTracker(host_ip=host_ip, nworker=nworker)
            tracker.start()
            envs["DMLC_LEGACY_TRACKER_PORT"] = str(tracker.port)
    else:
        ps = PSTracker(host_ip=host_ip, nworker=nworker, nserver=nserver)
        if start_tracker:
            ps.port = 0                  # bind a free port, not the ABI
            ps.start()                   # default; start() updates .port
            tracker = ps
        envs.update(ps.slave_envs())
        envs["DMLC_TRACKER_URI"] = host_ip
        envs["DMLC_TRACKER_PORT"] = str(_free_port(host_ip))
    fun_submit(nworker + nserver, envs)
    return tracker


def _free_port(host_ip: str) -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host_ip, 0))
        return s.getsockname()[1]
