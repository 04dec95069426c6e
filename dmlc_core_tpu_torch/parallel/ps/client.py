"""PS worker side: pipelined async push/pull under bounded staleness.

The client half of ps-lite's ``KVWorker``: resolve the server fleet
through the scheduler (``DMLC_PS_ROOT_URI/PORT``), route sparse id
batches to their range owners (``partition.py``), and keep every server
connection *pipelined* — pushes are fired without waiting for acks (a
reader thread drains them, a semaphore bounds the in-flight window to
``DMLC_PS_PIPELINE``), so a minibatch's push cost is one socket write,
not one round trip per server.

Consistency: bounded staleness (SSP).  The client stamps every push
with its logical clock and advances the clock with :meth:`PSClient.
tick` once per minibatch; a pull carries ``DMLC_PS_STALENESS`` and the
SERVER blocks it only when the slowest worker's committed clock lags
more than that window — ``tau = 0`` degenerates to BSP, ``tau < 0`` to
totally-async.  Observed lag lands on the ``dmlc_ps_staleness_rounds``
gauge and in :attr:`PSClient.staleness_samples` (the bench's p95).

Failover: a dead server connection (respawned server, new port) is
re-resolved through the scheduler and re-dialed inside a deadline
(``DMLC_PS_RECONNECT_S``); in-flight *async* pushes on the dead socket
are lost — bounded by the pipeline depth, which is exactly the
gradient-loss window the snapshot/restore drill budgets for.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base import tracectx as _tracectx
from dmlc_core_tpu_torch.base.logging import CHECK, LOG, Error
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.parallel.ps import wire
from dmlc_core_tpu_torch.parallel.ps.partition import (server_ranges,
                                                 split_by_server)
from dmlc_core_tpu_torch.parallel.ps.server import ps_metrics

__all__ = ["PSClient"]


class _ServerConn:
    """One pipelined connection to a PS server.

    Replies arrive strictly in request order, so matching is a FIFO of
    slots: the sender enqueues a slot per request, a reader thread
    fills the oldest on each reply.  ``wait=False`` requests (async
    push / clock) only hold a semaphore permit until their ack drains —
    the bounded in-flight window."""

    def __init__(self, host: str, port: int, pipeline: int):
        self._sock = socket.create_connection((host, port), timeout=30)
        self._f = self._sock.makefile("rwb")
        self._lock = threading.Lock()
        self._slots: deque = deque()          # FIFO of pending slots
        self._window = threading.Semaphore(max(1, pipeline))
        self._dead: Optional[BaseException] = None
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        while True:
            try:
                reply, arrays = wire.recv_msg(self._f)
            except (ConnectionError, OSError) as e:
                with self._lock:
                    self._dead = e
                    slots = list(self._slots)
                    self._slots.clear()
                for s in slots:
                    s["error"] = e
                    self._window.release()
                    s["event"].set()
                return
            with self._lock:
                slot = self._slots.popleft() if self._slots else None
            if slot is None:
                continue
            slot["reply"], slot["out"] = reply, arrays
            if _metrics.enabled() and slot.get("hist") is not None:
                slot["hist"].observe(get_time() - slot["t0"])
            self._window.release()
            slot["event"].set()

    def request(self, header: Dict[str, Any],
                arrays: Sequence[np.ndarray] = (),
                wait: bool = True,
                hist: Optional[Any] = None) -> Optional[Dict[str, Any]]:
        """Send one framed request.  ``wait=True`` blocks for the reply
        and returns ``(reply, arrays)``; ``wait=False`` returns None
        immediately once the request is on the wire (the pipeline
        window may block first)."""
        # Once the slot is in the deque the reader thread owns the
        # window permit (it releases on reply AND on connection death),
        # so the finally below releases only when we bail out first.
        committed = False
        self._window.acquire()
        try:
            slot = {"event": threading.Event(), "reply": None, "out": None,
                    "error": None, "t0": get_time(), "hist": hist}
            with self._lock:
                if self._dead is not None:
                    raise ConnectionError(f"ps conn dead: {self._dead}")
                self._slots.append(slot)
            committed = True
        finally:
            if not committed:
                self._window.release()
        try:
            wire.send_msg(self._f, header, arrays)
        except (ConnectionError, OSError):
            self.close()
            raise
        if not wait:
            return None
        slot["event"].wait()
        if slot["error"] is not None:
            raise ConnectionError(f"ps conn dead: {slot['error']}")
        reply = slot["reply"]
        if "error" in reply:
            raise Error(f"ps server error: {reply['error']}")
        return {"reply": reply, "out": slot["out"]}

    def flush(self) -> None:
        """Block until every in-flight request has been acked."""
        while True:
            with self._lock:
                if self._dead is not None:
                    raise ConnectionError(f"ps conn dead: {self._dead}")
                if not self._slots:
                    return
            time.sleep(0.001)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        # the reader wakes on the closed socket; reap it bounded so
        # failover churn does not accumulate dead reader threads that
        # still own self._lock
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=2.0)


class PSClient:
    """Worker-side handle on the sharded parameter server.

    ``init`` declares arrays, ``push``/``pull`` move sparse id batches
    (contiguous range routing — each touched shard sees one request
    per call), ``tick`` advances this worker's SSP clock,
    ``pull_dense`` reassembles a full array from every shard.  All
    knobs default from the ``DMLC_PS_*`` env group."""

    def __init__(self, root_uri: Optional[str] = None,
                 root_port: Optional[int] = None,
                 rank: Optional[int] = None,
                 staleness: Optional[int] = None,
                 pipeline: Optional[int] = None,
                 resolve_timeout_s: float = 60.0):
        from dmlc_core_tpu_torch.base import knobs as _knobs

        if root_uri is None:
            root_uri = str(_knobs.value("DMLC_PS_ROOT_URI")) or "127.0.0.1"
        if root_port is None:
            root_port = int(_knobs.value("DMLC_PS_ROOT_PORT") or 0)
        if rank is None:
            rank = int(_knobs.value("DMLC_TASK_ID"))
        if staleness is None:
            staleness = int(_knobs.value("DMLC_PS_STALENESS"))
        if pipeline is None:
            pipeline = int(_knobs.value("DMLC_PS_PIPELINE"))
        self._sched = (root_uri, int(root_port))
        self.rank = int(rank)
        self.staleness = int(staleness)
        self._pipeline = int(pipeline)
        self._pull_timeout_s = float(_knobs.value("DMLC_PS_PULL_TIMEOUT_S"))
        self._reconnect_s = float(_knobs.value("DMLC_PS_RECONNECT_S"))
        self.clock = 0
        self._specs: Dict[str, Dict[str, Any]] = {}
        self._conns: Dict[int, _ServerConn] = {}
        #: observed (clock - min_clock) per pull — the bench's
        #: staleness_p95 source; bounded, newest kept
        self.staleness_samples: List[int] = []
        self._endpoints: Dict[int, Tuple[str, int]] = {}
        self.nserver = 0
        self.nworker = 0
        # join the fleet metrics spool (no-op without DMLC_METRICS_SPOOL)
        from dmlc_core_tpu_torch.base import metrics_agg as _agg

        _agg.install_spool("ps_worker", self.rank)
        self._resolve(resolve_timeout_s)

    # -- membership ------------------------------------------------------
    def _sched_request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with socket.create_connection(self._sched, timeout=10) as s:
            f = s.makefile("rwb")
            wire.send_msg(f, msg)
            reply, _ = wire.recv_msg(f)
        return reply

    def _resolve(self, timeout_s: float) -> None:
        """Poll the scheduler until every server registered."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                reply = self._sched_request({"cmd": "ps_servers"})
            except (ConnectionError, OSError) as e:
                reply = {"ready": False, "_err": str(e)}
            if reply.get("ready"):
                self._endpoints = {int(k): (v[0], int(v[1]))
                                   for k, v in reply["servers"].items()}
                self.nserver = len(self._endpoints)
                self.nworker = int(reply.get("nworker", 1))
                return
            if time.monotonic() > deadline:
                raise Error(f"ps client: servers never became ready "
                            f"({reply})")
            time.sleep(0.05)

    def _conn(self, sid: int) -> _ServerConn:
        c = self._conns.get(sid)
        if c is None:
            host, port = self._endpoints[sid]
            c = _ServerConn(host, port, self._pipeline)
            self._conns[sid] = c
        return c

    def _with_failover(self, sid: int, fn):
        """Run ``fn(conn)`` against server ``sid``; on a dead
        connection, re-resolve endpoints through the scheduler (a
        respawned server re-registers under the same id with a new
        port) and retry until ``DMLC_PS_RECONNECT_S`` lapses."""
        deadline = time.monotonic() + self._reconnect_s
        while True:
            try:
                return fn(self._conn(sid))
            except (ConnectionError, OSError) as e:
                old = self._conns.pop(sid, None)
                if old is not None:
                    old.close()
                if time.monotonic() > deadline:
                    raise Error(f"ps client: server {sid} unreachable "
                                f"past {self._reconnect_s}s: {e}")
                LOG("WARNING", "ps.client rank %d: server %d connection "
                    "lost (%s); re-resolving", self.rank, sid, e)
                time.sleep(0.2)
                try:
                    self._resolve(max(1.0,
                                      deadline - time.monotonic()))
                except Error:
                    pass

    # -- data plane ------------------------------------------------------
    def init(self, name: str, n_keys: int, width: Sequence[int] = (),
             dtype: Any = np.float32, lr: float = 0.1,
             value: Optional[np.ndarray] = None,
             init_scale: float = 0.0, seed: int = 0) -> None:
        """Declare a sharded array on every server (idempotent across
        workers: the first init wins).  ``value`` ships initial
        contents (split by range); None initializes zeros — unless
        ``init_scale`` > 0, in which case each server draws its own
        slice ~ Normal(0, init_scale) seeded by ``(seed, lo)`` so no
        host ever materializes the full array (FM factor matrices at
        10M+ rows need a nonzero start: the v-gradient vanishes at
        v = 0)."""
        dtype = np.dtype(dtype)
        width = tuple(int(w) for w in width)
        if value is not None:
            value = np.asarray(value, dtype)
            CHECK(value.shape == (n_keys,) + width,
                  f"ps init {name!r}: value shape {value.shape} != "
                  f"{(n_keys,) + width}")
        ranges = server_ranges(n_keys, self.nserver)
        for sid, (lo, hi) in enumerate(ranges):
            header = {"cmd": "init", "name": name, "n_keys": n_keys,
                      "width": list(width), "dtype": str(dtype),
                      "lr": lr}
            if value is None and init_scale > 0.0:
                header["init_scale"] = float(init_scale)
                header["seed"] = int(seed)
            arrays = [value[lo:hi]] if value is not None else []
            self._with_failover(
                sid, lambda c: c.request(header, arrays))
        self._specs[name] = {"n_keys": n_keys, "width": width,
                             "dtype": str(dtype), "lr": lr}

    def _route(self, name: str,
               ids: np.ndarray) -> Dict[int, np.ndarray]:
        spec = self._specs[name]
        ids = np.asarray(ids, np.int64)
        return split_by_server(ids, spec["n_keys"], self.nserver)

    def push(self, name: str, ids: np.ndarray, grads: np.ndarray,
             wait: bool = False) -> None:
        """Push sparse gradients for the touched ids (async by default:
        the call returns once the frames are written; acks drain on the
        reader threads inside the pipeline window)."""
        parts = self._route(name, np.asarray(ids, np.int64))
        ids = np.asarray(ids, np.int64)
        grads = np.asarray(grads)
        hist = ps_metrics()["push"] if _metrics.enabled() else None
        # the span's context rides the wire framing (ps/wire.send_msg)
        # to the touched servers — the worker->server trace edge
        with _tracectx.span("ps.push", array=name):
            for sid, pos in parts.items():
                header = {"cmd": "push", "name": name, "rank": self.rank,
                          "clock": self.clock}
                payload = [np.ascontiguousarray(ids[pos]),
                           np.ascontiguousarray(grads[pos])]
                self._with_failover(
                    sid, lambda c: c.request(header, payload, wait=wait,
                                             hist=hist))

    def pull(self, name: str, ids: np.ndarray) -> np.ndarray:
        """Pull current values for a sparse id batch.  Requests to all
        touched shards go out concurrently, then the replies are
        gathered — so a pull costs one round trip, not one per server.
        Blocks server-side per the staleness window."""
        spec = self._specs[name]
        ids = np.asarray(ids, np.int64)
        parts = self._route(name, ids)
        hist = ps_metrics()["pull"] if _metrics.enabled() else None
        t0 = get_time()
        results: Dict[int, Any] = {}
        errors: Dict[int, BaseException] = {}
        trace_hdr: List[Optional[str]] = [None]

        def _one(sid: int, pos: np.ndarray) -> None:
            header = {"cmd": "pull", "name": name, "rank": self.rank,
                      "clock": self.clock, "staleness": self.staleness,
                      "timeout_s": self._pull_timeout_s}
            try:
                # re-attach the pull span's context: trace state is
                # thread-local and these are fresh threads
                with _tracectx.attach(trace_hdr[0]):
                    results[sid] = self._with_failover(
                        sid, lambda c: c.request(
                            header, [np.ascontiguousarray(ids[pos])]))
            except BaseException as e:  # noqa: BLE001 — joined below
                errors[sid] = e

        with _tracectx.span("ps.pull", array=name) as _span:
            trace_hdr[0] = _span.encode() if _span is not None else None
            threads = [threading.Thread(target=_one, args=(sid, pos))
                       for sid, pos in parts.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise Error(f"ps pull failed: {errors}")
        out = np.empty((len(ids),) + spec["width"],
                       np.dtype(spec["dtype"]))
        min_clock = self.clock
        for sid, pos in parts.items():
            r = results[sid]
            out[pos] = r["out"][0]
            min_clock = min(min_clock, int(r["reply"]["min_clock"]))
        lag = max(0, self.clock - min_clock)
        if _metrics.enabled():
            ps_metrics()["staleness"].set(lag)
        if hist is not None:
            hist.observe(get_time() - t0)
        if len(self.staleness_samples) >= 65536:
            del self.staleness_samples[:32768]
        self.staleness_samples.append(lag)
        return out

    def tick(self) -> None:
        """Advance this worker's SSP clock and announce it to every
        shard (async): a shard no push touched this round must still
        see the worker's progress, or its staleness gate would starve
        other workers' pulls."""
        self.clock += 1
        for sid in self._endpoints:
            self._with_failover(
                sid, lambda c: c.request(
                    {"cmd": "clock", "rank": self.rank,
                     "clock": self.clock}, wait=False))

    def pull_dense(self, name: str) -> np.ndarray:
        """Reassemble the full array from every shard's owned range."""
        spec = self._specs[name]
        out = np.zeros((spec["n_keys"],) + spec["width"],
                       np.dtype(spec["dtype"]))
        for sid in sorted(self._endpoints):
            r = self._with_failover(
                sid, lambda c: c.request({"cmd": "pull_range",
                                          "name": name}))
            lo, hi = int(r["reply"]["lo"]), int(r["reply"]["hi"])
            if hi > lo:
                out[lo:hi] = r["out"][0]
        return out

    def flush(self) -> None:
        """Drain every pipelined connection (all pushes acked)."""
        for c in list(self._conns.values()):
            c.flush()

    def close(self, shutdown_job: bool = True) -> None:
        """Say bye to every server (a server exits once all workers
        did) and count this worker's shutdown at the scheduler."""
        for sid in list(self._conns):
            try:
                self._conn(sid).request({"cmd": "bye",
                                         "rank": self.rank})
            except (ConnectionError, OSError, Error):
                pass
        for c in self._conns.values():
            c.close()
        self._conns.clear()
        if shutdown_job:
            try:
                self._sched_request({"cmd": "shutdown"})
            except (ConnectionError, OSError):
                pass
