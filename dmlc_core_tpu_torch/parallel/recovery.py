"""Elastic fault-tolerant distributed training — rabit's recovery story.

Reference parity: the coordination promise at the center of dmlc-core
(PAPER.md §1): a worker that dies mid-allreduce can rejoin and recover
from the last agreed-upon state with bounded loss.  Rabit implements it
with version-numbered ``CheckPoint()/LoadCheckPoint()`` plus a tracker
that re-admits reborn workers; this module composes the substrate this
repo already has — the tracker's reconnect grace + liveness
(``tracker.tracker``), atomic CRC'd versioned checkpoints
(``parallel.checkpoint``), deterministic fault injection
(``base.faultinject``) and the deterministic histogram fold
(``DMLC_HIST_BLOCKS``) — into that loop:

* **Round-versioned collective commits.**  Every ``DMLC_RECOVERY_STRIDE``
  boosting rounds each worker atomically commits ``(round, ensemble,
  cursor)`` through :class:`RoundCheckpointer` and then passes a commit
  barrier at the tracker; the tracker tracks the **recovery floor** —
  the last round committed by every member — behind
  ``dmlc_recovery_floor_round``.  A round either commits on all workers
  or on none.
* **Abort on membership change.**  Cross-worker collectives run through
  the tracker hub (:class:`ElasticTracker` server side,
  :class:`ElasticSession` client side — rabit's actual wire role, used
  where no process group joins the workers).
  A worker death — detected instantly via the socket close, or by the
  deadline-driven grace sweep during silent stretches — breaks the
  current *epoch*: every in-flight collective returns ``abort``,
  surviving workers raise :class:`CollectiveAborted`, roll their
  ensembles back to the floor, and re-``join``.
* **Rejoin or elastically re-shard.**  A worker that restarts inside the
  grace window ``recover``s its rank, loads the floor checkpoint and
  replays forward — byte-stable, since the deterministic fold makes
  replayed rounds bit-identical.  With ``DMLC_ELASTIC=1``, once every
  lost rank's grace lapses the tracker re-forms the epoch over the
  survivors instead: ranks compact, ``shard_row_ranges`` re-cuts the
  rows over the smaller world at the round boundary, and training
  continues with N−k workers (``dmlc_elastic_reshards_total``).

The PyTorch port's counterpart of ``dmlc_core_tpu/parallel/recovery.py``,
ported in full.  :meth:`ElasticTrainer.run` installs the worker's
:class:`ElasticSession` as its thread's host transport
(``collectives.set_host_transport``): the port's ``Mesh`` then takes its
size and rank from the session, and every histogram sync of
``fit_external`` (int64 fixed-point sums, exact in any order) and every
host collective of its sketch runs through the tracker hub — so worker
threads of one process, each with its own session, are one job, as in
the JAX package's protocol tests.  The models stay on their device
(``device=`` of the ``HistGBT``): on a card the boosting rounds run the
histogram kernels and only the per-level sums cross the host.  The
round commits and the replay are the JAX package's; a worker killed at
round r resumes from the floor and writes the uninterrupted run's bytes.
"""

from __future__ import annotations

import base64
import json
import os
import signal
import socket
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base import faultinject as _fi
from dmlc_core_tpu_torch.base import knobs as _knobs
from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG, log_fatal
from dmlc_core_tpu_torch.io.stream import Stream
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.checkpoint import checkpoint, load_checkpoint
from dmlc_core_tpu_torch.parallel.mesh import shard_row_ranges
from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

__all__ = [
    "CollectiveAborted", "WorkerAborted", "EvictedError",
    "RecoveryConfig", "RoundCheckpointer", "ElasticTracker",
    "ElasticSession", "ElasticTrainer", "ElasticLauncher", "fold_parts",
    "truncate_to_round",
]


class CollectiveAborted(RuntimeError):
    """An in-flight collective was aborted (membership changed or a peer
    requested an abort): the current round is void on every worker —
    roll back to the recovery floor and re-join."""


class WorkerAborted(RuntimeError):
    """The ``worker`` fault-injection point fired with a non-kill kind —
    this worker abandons training (the in-process stand-in for SIGKILL
    in tests)."""


class EvictedError(RuntimeError):
    """The tracker re-formed the epoch without this rank (elastic shrink
    won the race); this worker has no seat in the surviving world."""


_RM = None


def _recovery_metrics():
    global _RM
    if _RM is None:
        r = _metrics.default_registry()
        _RM = {
            "replayed": r.counter(
                "recovery_rounds_replayed_total",
                "boosting rounds re-run after a rollback to the "
                "recovery floor"),
            "reshards": r.counter(
                "elastic_reshards_total",
                "elastic re-formations of the worker group onto a "
                "smaller survivor set"),
        }
    return _RM


class RecoveryConfig:
    """Resolved recovery knobs (each overridable per instance):

    * ``stride`` — rounds between collective commits
      (``DMLC_RECOVERY_STRIDE``); smaller = tighter recovery floor,
      more commit barriers.
    * ``elastic`` — after a lost worker's grace lapses, re-shard over
      the survivors instead of waiting for a replacement
      (``DMLC_ELASTIC``).
    * ``directory`` — where round-versioned commit files live
      (``DMLC_RECOVERY_DIR``).
    """

    def __init__(self, stride: Optional[int] = None,
                 elastic: Optional[bool] = None,
                 directory: Optional[str] = None):
        if stride is None:
            stride = int(_knobs.value("DMLC_RECOVERY_STRIDE"))
        CHECK(stride >= 1, f"recovery stride must be >= 1, got {stride}")
        self.stride = stride
        if elastic is None:
            elastic = str(_knobs.value("DMLC_ELASTIC")).lower() in (
                "1", "true", "on", "yes")
        self.elastic = bool(elastic)
        if directory is None:
            directory = str(_knobs.value("DMLC_RECOVERY_DIR"))
        self.directory = directory


def fold_parts(parts: List[np.ndarray]) -> np.ndarray:
    """Deterministic pairwise tree fold of per-worker partials, in rank
    order — the same fixed reduction tree ``DMLC_HIST_BLOCKS`` uses
    inside the round program (``histgbt._tree_fold``), so a worker
    group's sum is reproducible run after run regardless of message
    arrival order, and a shard's blocks stay an aligned subtree of the
    global fold.  Odd counts carry the unpaired tail up a level."""
    parts = [np.asarray(p) for p in parts]
    CHECK(len(parts) >= 1, "fold_parts: empty")
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def truncate_to_round(model: Any, round_no: int) -> Any:
    """Roll an ensemble back to ``round_no`` boosting rounds (every
    engine keeps one ``trees`` entry per round, multiclass included).
    Clears the carried training margins — they describe the discarded
    tail — so the next fit replays margins from the surviving trees."""
    if len(model.trees) > round_no:
        model.trees = model.trees[:round_no]
    model._train_preds = None
    model.best_iteration = None
    model.best_score = None
    return model


# ---------------------------------------------------------------------------
# round-versioned commits (rabit CheckPoint / LoadCheckPoint)
# ---------------------------------------------------------------------------

class RoundCheckpointer:
    """Atomic, CRC-checked, round-versioned commits of a GBT ensemble.

    Layers on :func:`parallel.checkpoint.checkpoint` (temp-file +
    ``os.replace`` commit, per-leaf CRC sidecar, previous-version
    fallback) with the model's ``save_model`` bytes as the one state
    leaf — the same magic-sniffed contract the serve ModelRegistry uses,
    so any engine with save/load round-trips works.  ``version`` is the
    boosting round: rabit's ``version_number``.

    Each worker writes its own ``gbt-rank<k>.ckpt`` (``local=True``
    commits: no collective in the commit path — a dying peer must not
    wedge it).  Because the floor only advances when EVERY member
    committed, a restore may find its own file *ahead* of the floor
    (died between local write and the barrier) — the caller truncates —
    and a diskless replacement worker finds no file at all, so
    :meth:`restore` falls back to scanning sibling rank files for one at
    or past the floor (ensembles are bit-identical across workers under
    the deterministic fold, so any member's file serves).
    """

    def __init__(self, directory: str, rank: int = 0):
        CHECK(bool(directory), "RoundCheckpointer needs a directory "
              "(DMLC_RECOVERY_DIR or explicit)")
        self.directory = directory
        self.rank = rank
        os.makedirs(directory, exist_ok=True)

    def uri(self, rank: Optional[int] = None) -> str:
        r = self.rank if rank is None else rank
        return os.path.join(self.directory, f"gbt-rank{r}.ckpt")

    @staticmethod
    def _like() -> Dict[str, Any]:
        return {"cursor": "", "model": np.zeros(0, np.uint8)}

    def commit(self, model: Any, round_no: int,
               cursor: Optional[Dict[str, Any]] = None) -> None:
        """Durably commit ``model`` as the state of ``round_no``."""
        stage = f"mem://recovery/{os.getpid()}/{self.rank}/stage"
        model.save_model(stage)
        with Stream.create(stage, "r") as s:
            blob = s.read_all()
        state = {"cursor": json.dumps(cursor or {}),
                 "model": np.frombuffer(blob, np.uint8)}
        checkpoint(self.uri(), state, version=round_no, local=True)

    def _load(self, uri: str) -> Tuple[int, Optional[bytes], Dict[str, Any]]:
        version, state = load_checkpoint(uri, self._like())
        if version == 0 and state["model"].size == 0:
            return 0, None, {}
        cursor = json.loads(state["cursor"]) if state["cursor"] else {}
        return version, state["model"].tobytes(), cursor

    def restore(self, floor: Optional[int] = None
                ) -> Tuple[int, Optional[bytes], Dict[str, Any]]:
        """Newest committed ``(round, save_model bytes, cursor)`` —
        ``(0, None, {})`` for a cold start.  When ``floor`` is given and
        this rank's own file is behind it (fresh replacement worker),
        sibling rank files are scanned for one at or past the floor."""
        version, blob, cursor = self._load(self.uri())
        if floor is None or version >= floor or floor <= 0:
            return version, blob, cursor
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            names = []
        for name in names:
            if not (name.startswith("gbt-rank") and name.endswith(".ckpt")):
                continue
            cand = os.path.join(self.directory, name)
            if cand == self.uri():
                continue
            v, b, c = self._load(cand)
            if v >= floor and b is not None:
                LOG("WARNING", "recovery: rank %d file is at v%d < floor "
                    "%d; adopting sibling %s (v%d)", self.rank, version,
                    floor, name, v)
                return v, b, c
        return version, blob, cursor

    def restore_model(self, model_cls: Any, mesh: Any = None,
                      floor: Optional[int] = None, device: Any = None
                      ) -> Tuple[int, Optional[Any], Dict[str, Any]]:
        """:meth:`restore`, deserialized through ``model_cls.load_model``
        onto ``device`` (``None``: the class's default), on ``mesh``
        when given."""
        version, blob, cursor = self.restore(floor)
        if blob is None:
            return 0, None, cursor
        stage = f"mem://recovery/{os.getpid()}/{self.rank}/restore"
        with Stream.create(stage, "w") as s:
            s.write(blob)
        model = model_cls.load_model(stage, device=device)
        if mesh is not None:
            model.mesh = mesh
        return version, model, cursor


# ---------------------------------------------------------------------------
# tracker-side consensus: epochs, commit barrier, collective hub
# ---------------------------------------------------------------------------

def _enc_payload(value: Any) -> Dict[str, Any]:
    if isinstance(value, np.ndarray) or isinstance(value, (np.generic,)):
        a = np.ascontiguousarray(value)
        return {"kind": "nd", "dtype": str(a.dtype),
                "shape": list(a.shape),
                "data": base64.b64encode(a.tobytes()).decode("ascii")}
    return {"kind": "py", "value": value}


def _dec_payload(d: Optional[Dict[str, Any]]) -> Any:
    if d is None:
        return None
    if d.get("kind") == "py":
        return d.get("value")
    a = np.frombuffer(base64.b64decode(d["data"]),
                      dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).copy()


class ElasticTracker(RabitTracker):
    """RabitTracker + the elastic recovery consensus.

    Adds three commands on the persistent worker protocol:

    * ``join`` — blocks until an *epoch* (a stable worker group) forms:
      all ``nworker`` ranks alive and joined, or — ``elastic`` mode,
      once every lost rank's grace has lapsed — the survivors alone.
      Replies with the epoch id, the member list, this rank's position
      (``wrank``) and the recovery floor.
    * ``coll`` — the collective hub: contributions for ``(epoch, seq)``
      from every member are reduced (deterministic pairwise fold for
      sums) and the one result fanned back.  Any membership change
      breaks the epoch first, so every waiter — and every straggler
      arriving with the stale epoch id — gets ``abort`` instead of a
      half-reduced value.  ``op="commit"`` doubles as the commit
      barrier and advances the recovery floor.
    * ``abort`` — a worker voluntarily voids the epoch (the
      ``allreduce:abort`` fault-injection kind rides this), exercising
      the all-or-nothing round without a death.
    """

    _WAIT_S = 60.0

    def __init__(self, host_ip: str = "127.0.0.1", nworker: int = 1,
                 port: int = 0, grace_s: Optional[float] = None,
                 elastic: Optional[bool] = None):
        super().__init__(host_ip=host_ip, nworker=nworker, port=port,
                         grace_s=grace_s)
        if elastic is None:
            elastic = RecoveryConfig().elastic
        self.elastic = bool(elastic)
        self._cv = threading.Condition(self._lock)
        self._epoch = 0
        self._epoch_ready = False
        self._members: List[int] = []
        self._joined: set = set()
        self._colls: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._prev_world = nworker
        self._broken_reason = ""

    # -- membership → epoch lifecycle -----------------------------------
    def _membership_event_locked(self, kind: str, rank: int) -> None:
        if kind in ("lost", "death", "shutdown"):
            self._joined.discard(rank)
        if kind in ("lost", "death"):
            self._break_epoch_locked(f"rank {rank} {kind}")
        # reconnect/death may complete a pending formation (rejoin or
        # survivor-only world); join waiters re-evaluate either way
        self._try_form_locked()
        self._cv.notify_all()

    def _break_epoch_locked(self, reason: str) -> None:
        if not self._epoch_ready:
            return
        self._epoch_ready = False
        self._members = []
        self._joined.clear()
        self._colls.clear()
        self._epoch += 1
        self._broken_reason = reason
        LOG("WARNING", "elastic: epoch %d broken (%s); in-flight round "
            "aborts on every worker", self._epoch - 1, reason)

    def _try_form_locked(self) -> None:
        if self._epoch_ready or self._done.is_set():
            return
        alive = set(self._alive)
        joined = self._joined & alive
        full = set(range(self.nworker))
        members: Optional[List[int]] = None
        if full <= joined:
            members = sorted(full)
        elif (self.elastic and joined and not self._pending_death
              and joined == alive
              and (full - joined) <= set(self.dead_workers)):
            # every missing rank is past its grace (the deadline sweep
            # declared it dead) and every survivor has re-joined:
            # re-form the world over the survivors at the round boundary
            members = sorted(joined)
        if members is None:
            return
        self._members = members
        self._epoch_ready = True
        self._broken_reason = ""
        if len(members) < self._prev_world:
            self._prev_world = len(members)
            if _metrics.enabled():
                _recovery_metrics()["reshards"].inc(1)
            LOG("WARNING", "elastic: epoch %d re-formed with %d survivors "
                "%s (was %d)", self._epoch, len(members), members,
                self.nworker)
        else:
            LOG("INFO", "elastic: epoch %d formed with %d members",
                self._epoch, len(members))
        self._cv.notify_all()

    def _expected_ranks_locked(self) -> List[int]:
        # the recovery floor is gated on the CURRENT epoch's members (an
        # evicted rank's stale commit must not hold the floor back)
        return list(self._members) if self._members else list(
            range(self.nworker))

    # -- protocol --------------------------------------------------------
    def _handle(self, msg: Dict[str, Any],
                conn: Optional[socket.socket] = None,
                state: Optional[Dict[str, Any]] = None
                ) -> Optional[Dict[str, Any]]:
        cmd = msg.get("cmd")
        if cmd == "join":
            return self._handle_join(msg)
        if cmd == "coll":
            return self._handle_coll(msg)
        if cmd == "abort":
            return self._handle_abort(msg)
        return super()._handle(msg, conn, state)

    def _handle_join(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        rank = int(msg.get("rank", -1))
        timeout_s = float(msg.get("timeout_s", self._WAIT_S))
        with self._cv:
            self._joined.add(rank)
            self._try_form_locked()
            waited = 0.0
            while True:
                if self._done.is_set():
                    return {"error": "tracker stopped"}
                if self._epoch_ready:
                    if rank in self._members:
                        break
                    self._joined.discard(rank)
                    return {"error": "evicted: epoch formed without "
                            f"rank {rank}"}
                if timeout_s > 0 and waited >= timeout_s:
                    self._joined.discard(rank)
                    return {"error": "join timeout"}
                self._cv.wait(timeout=1.0)
                waited += 1.0
            return {"epoch": self._epoch, "world": len(self._members),
                    "wrank": self._members.index(rank),
                    "members": list(self._members), "floor": self._floor}

    def _handle_abort(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        with self._cv:
            if (int(msg.get("epoch", -1)) == self._epoch
                    and self._epoch_ready):
                self._break_epoch_locked(
                    f"rank {msg.get('rank')} abort: "
                    f"{msg.get('reason', 'unspecified')}")
            self._cv.notify_all()
            return {"ok": True}

    def _handle_coll(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        rank = int(msg.get("rank", -1))
        epoch = int(msg.get("epoch", -1))
        seq = int(msg.get("seq", -1))
        op = str(msg.get("op", ""))
        with self._cv:
            if (not self._epoch_ready or epoch != self._epoch
                    or rank not in self._members):
                return {"abort": self._broken_reason or "epoch changed",
                        "epoch": self._epoch}
            key = (epoch, seq)
            ent = self._colls.get(key)
            if ent is None:
                ent = self._colls[key] = {
                    "op": op, "root": int(msg.get("root", 0)),
                    "parts": {}, "done": False, "result": None,
                    "served": set(),
                }
            if ent["op"] != op:
                # the workers disagree on the collective sequence —
                # divergence must abort the round, never mix payloads
                self._break_epoch_locked(
                    f"collective {seq} op mismatch: {ent['op']!r} vs "
                    f"{op!r} from rank {rank}")
                return {"abort": "collective op mismatch",
                        "epoch": self._epoch}
            ent["parts"][rank] = _dec_payload(msg.get("payload"))
            if set(ent["parts"]) == set(self._members):
                ent["result"] = self._reduce_locked(ent)
                ent["done"] = True
                self._cv.notify_all()
            while not ent["done"]:
                if (not self._epoch_ready or epoch != self._epoch
                        or self._done.is_set()):
                    return {"abort": self._broken_reason or "epoch changed",
                            "epoch": self._epoch}
                if not self._cv.wait(timeout=self._WAIT_S):
                    self._break_epoch_locked(
                        f"collective {seq} timed out waiting for "
                        f"{sorted(set(self._members) - set(ent['parts']))}")
                    return {"abort": "collective timeout",
                            "epoch": self._epoch}
            ent["served"].add(rank)
            if ent["served"] == set(self._members):
                self._colls.pop(key, None)
            return {"payload": _enc_payload(ent["result"])}

    def _reduce_locked(self, ent: Dict[str, Any]) -> Any:
        op = ent["op"]
        order = [ent["parts"][r] for r in self._members]
        if op == "barrier":
            return None
        if op == "commit":
            rounds = [int(v) for v in order]
            if len(set(rounds)) != 1:
                self._break_epoch_locked(
                    f"commit barrier round mismatch: {rounds}")
                return None
            for r in self._members:
                self._record_commit_locked(r, rounds[0])
            return self._floor
        if op == "bcast":
            return ent["parts"][self._members[ent["root"]]]
        if op == "allgather":
            return np.stack([np.asarray(p) for p in order], axis=0)
        if op in ("sum", "prod"):
            if op == "prod":
                parts = [np.asarray(p) for p in order]
                out = parts[0]
                for p in parts[1:]:
                    out = out * p
                return out
            return fold_parts(order)
        if op == "max":
            return np.maximum.reduce([np.asarray(p) for p in order])
        if op == "min":
            return np.minimum.reduce([np.asarray(p) for p in order])
        if op == "bitor":
            return np.bitwise_or.reduce([np.asarray(p) for p in order])
        self._break_epoch_locked(f"unknown collective op {op!r}")
        return None


# ---------------------------------------------------------------------------
# multi-host elastic launch: tracker + supervised JobSet
# ---------------------------------------------------------------------------

class ElasticLauncher:
    """An :class:`ElasticTracker` plus the supervised
    :class:`~dmlc_core_tpu_torch.launch.JobSet` that keeps its worker set full.

    Before the launch subsystem, elastic recovery could only *tolerate*
    a dead rank (grace-window rejoin, or elastic shrink once grace
    lapsed) — nothing relaunched it.  This closes the loop: the JobSet
    respawns a dead rank (with backoff, under the restart budget) on a
    surviving host, the replacement reclaims its rank via the tracker's
    ``recover`` path inside the grace window, rolls to the recovery
    floor and replays — so a host failure costs replayed rounds, not a
    shrunken world.  The JobSet's ``tracker=`` cross-check also reaps
    wedged workers (process alive, heartbeat lost).

    Workers must pin their tracker rank to ``DMLC_TASK_ID`` (i.e.
    ``ElasticSession(uri, port, rank=int(env["DMLC_TASK_ID"]))``) so a
    respawned attempt reclaims the rank it replaces.
    """

    def __init__(self, command: List[str], nworker: int,
                 transport: Any = None, host_ip: str = "127.0.0.1",
                 grace_s: Optional[float] = None,
                 elastic: Optional[bool] = None,
                 envs: Optional[Dict[str, str]] = None,
                 restart_limit: Optional[int] = None,
                 monitor_s: Optional[float] = None,
                 name: str = "elastic",
                 env_for: Optional[Callable[[int, int],
                                            Dict[str, str]]] = None):
        self.tracker = ElasticTracker(host_ip=host_ip, nworker=nworker,
                                      grace_s=grace_s, elastic=elastic)
        self._command = list(command)
        self._nworker = nworker
        self._transport = transport
        self._envs = dict(envs or {})
        self._restart_limit = restart_limit
        self._monitor_s = monitor_s
        self._name = name
        self._env_for = env_for
        self.jobset: Any = None

    def launch(self) -> "ElasticLauncher":
        """Start the tracker, then the supervised worker set wired to it
        (env ABI = ``slave_envs()``, liveness cross-check = tracker)."""
        from dmlc_core_tpu_torch.launch import JobSet

        self.tracker.start()
        envs = dict(self.tracker.slave_envs())
        envs.update(self._envs)
        self.jobset = JobSet(
            self._command, self._nworker, transport=self._transport,
            envs=envs, name=self._name,
            restart_limit=self._restart_limit, monitor_s=self._monitor_s,
            tracker=self.tracker, env_for=self._env_for)
        self.jobset.launch()
        return self

    def wait(self, timeout: Optional[float] = None) -> Dict[int, int]:
        CHECK(self.jobset is not None, "ElasticLauncher: launch() first")
        return self.jobset.wait(timeout=timeout)

    def run(self, timeout: Optional[float] = None) -> List[int]:
        """launch + wait + teardown; exit codes in rank order."""
        self.launch()
        try:
            codes = self.wait(timeout=timeout)
        finally:
            self.shutdown()
        return [codes[r] for r in sorted(codes)]

    def shutdown(self) -> None:
        if self.jobset is not None:
            self.jobset.shutdown()
        self.tracker.stop()


# ---------------------------------------------------------------------------
# worker-side session: protocol client + host-collective transport
# ---------------------------------------------------------------------------

class ElasticSession:
    """Persistent worker session speaking the elastic protocol.

    Doubles as the host-collective transport
    (:func:`parallel.collectives.set_host_transport`): ``rank`` /
    ``world`` are epoch-relative, and ``allreduce`` / ``allgather`` /
    ``broadcast`` / ``barrier`` run through the tracker hub.  The
    ``allreduce`` fault-injection point sits on every collective
    (``allreduce:abort`` voids the epoch on ALL workers — the
    all-or-nothing round drill; ``allreduce:kill`` SIGKILLs mid-round).
    """

    def __init__(self, uri: str, port: int, rank: int = -1, host: str = "",
                 connect_timeout_s: float = 30.0):
        from dmlc_core_tpu_torch.base.resilience import RetryPolicy

        # a rejoining worker races the tracker noticing the old socket's
        # death: retry the TCP connect with backoff instead of failing
        # the whole recovery on one ECONNREFUSED
        self._sock = RetryPolicy.from_env().run(
            lambda: socket.create_connection((uri, port),
                                             timeout=connect_timeout_s),
            op="tracker_connect",
            retryable=lambda e: isinstance(e, OSError))
        self._sock.settimeout(None)
        cmd = "recover" if rank >= 0 else "start"
        self.info = self._request({"cmd": cmd, "rank": rank, "host": host,
                                   "persistent": True})
        if "error" in self.info:
            self._sock.close()
            log_fatal("tracker rejected worker: %s" % self.info["error"])
        #: tracker-global rank (stable across epochs for a rejoiner)
        self.grank = int(self.info["rank"])
        self.nworker = int(self.info["num_worker"])
        self.epoch = -1
        self.world = 0
        self.wrank = -1
        self.members: List[int] = []
        self.floor = 0
        self._seq = 0

    # transport duck-type: epoch-relative identity
    @property
    def rank(self) -> int:
        return self.wrank if self.wrank >= 0 else self.grank

    def _request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        self._sock.sendall(json.dumps(msg).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            data = self._sock.recv(1 << 20)
            if not data:
                raise CollectiveAborted("tracker connection closed")
            buf += data
        return json.loads(buf.split(b"\n", 1)[0])

    def join(self, timeout_s: float = 120.0) -> Dict[str, Any]:
        """Block until a stable epoch admits this worker; resets the
        collective sequence.  Raises :class:`EvictedError` when the
        world re-formed without this rank."""
        reply = self._request({"cmd": "join", "rank": self.grank,
                               "timeout_s": timeout_s})
        if "error" in reply:
            if reply["error"].startswith("evicted"):
                raise EvictedError(reply["error"])
            raise CollectiveAborted(f"join failed: {reply['error']}")
        self.epoch = int(reply["epoch"])
        self.world = int(reply["world"])
        self.wrank = int(reply["wrank"])
        self.members = list(reply["members"])
        self.floor = int(reply["floor"])
        self._seq = 0
        return reply

    def _coll(self, op: str, payload: Any = None, root: int = 0) -> Any:
        fault = _fi.check("allreduce", ctx=op)
        if fault is not None:
            if fault.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            if fault.kind in ("abort", "error"):
                # void the round on EVERY worker (all-or-nothing), then
                # surface the abort locally
                try:
                    self._request({"cmd": "abort", "epoch": self.epoch,
                                   "rank": self.grank,
                                   "reason": "fault injected"})
                except CollectiveAborted:
                    pass
                raise CollectiveAborted("fault injected: allreduce abort")
        self._seq += 1
        msg: Dict[str, Any] = {"cmd": "coll", "op": op, "rank": self.grank,
                               "epoch": self.epoch, "seq": self._seq,
                               "root": int(root)}
        if payload is not None or op in ("bcast",):
            msg["payload"] = _enc_payload(payload)
        reply = self._request(msg)
        if "abort" in reply:
            raise CollectiveAborted(str(reply["abort"]))
        return _dec_payload(reply.get("payload"))

    # -- transport surface ----------------------------------------------
    def allreduce(self, x: np.ndarray, op: str = "sum") -> np.ndarray:
        x = np.asarray(x)
        out = self._coll(op, x)
        return np.asarray(out, dtype=x.dtype).reshape(x.shape)

    def allgather(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(self._coll("allgather", np.asarray(x)))

    def broadcast(self, value: Any, root: int = 0) -> Any:
        return self._coll("bcast", value if self.wrank == root else None,
                          root=root)

    def barrier(self, name: str = "dmlc") -> None:
        del name
        self._coll("barrier")

    def commit(self, round_no: int) -> int:
        """Commit barrier: blocks until every member committed
        ``round_no``; returns the advanced recovery floor."""
        floor = self._coll("commit", int(round_no))
        self.floor = int(floor)
        return self.floor

    def shutdown(self) -> None:
        try:
            self._request({"cmd": "shutdown"})
        except (CollectiveAborted, OSError):
            pass
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ElasticSession":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the recovery loop
# ---------------------------------------------------------------------------

class ElasticTrainer:
    """Round-versioned recovery loop around HistGBT boosting.

    Single-worker (:meth:`run_device`) it is crash-safe training: boost
    in ``stride``-round legs over a ``make_device_data`` handle,
    committing after each leg; a process that dies at any round ``r``
    restarts from ``floor(r/stride)*stride`` and — under the
    deterministic fold — reproduces the uninterrupted run's bytes.

    Distributed (:meth:`run`) it adds the tracker consensus: commit
    barriers advance the global floor, any membership change aborts the
    in-flight leg on every worker (:class:`CollectiveAborted`), the
    group rolls back to the floor, re-forms (rejoin or elastic
    re-shard) and replays forward.  The ``worker`` fault-injection
    point fires once per boosting round and at every commit
    (``worker:kill:after=N`` SIGKILLs deterministically mid-boost —
    the chaos drill's trigger).
    """

    def __init__(self, model: Any, total_rounds: int,
                 recovery_dir: Optional[str] = None,
                 stride: Optional[int] = None,
                 elastic: Optional[bool] = None):
        cfg = RecoveryConfig(stride=stride, elastic=elastic,
                             directory=recovery_dir)
        CHECK(bool(cfg.directory),
              "ElasticTrainer needs a recovery dir (DMLC_RECOVERY_DIR "
              "or recovery_dir=)")
        self.model = model
        self.total = int(total_rounds)
        self.stride = cfg.stride
        self.elastic = cfg.elastic
        self.directory = cfg.directory
        #: rounds re-run after rollbacks (evidence for tests/drills)
        self.rounds_replayed = 0
        #: the committed round training resumed from (None = cold start)
        self.resumed_from: Optional[int] = None
        #: rounds completed by this process (committed + current leg)
        self.rounds_trained = 0
        self._committed = 0

    # -- shared plumbing -------------------------------------------------
    def _worker_fault(self) -> None:
        fault = _fi.check("worker")
        if fault is None:
            return
        if fault.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise WorkerAborted(f"fault injected: worker {fault.kind}")

    def _chunk_cb(self, rounds_fetched: int, _elapsed: float) -> None:
        # per-dispatch-chunk hook from the boost loop: with
        # DMLC_TPU_ROUNDS_PER_DISPATCH=1 this is a per-round heartbeat —
        # the site where worker:kill lands "mid-round"
        self.rounds_trained = self._committed + int(rounds_fetched)
        self._worker_fault()

    def _adopt(self, loaded: Any) -> None:
        m = self.model
        if m.cuts is not None and loaded.cuts is not None:
            CHECK(torch.equal(torch.as_tensor(m.cuts).cpu(),
                              torch.as_tensor(loaded.cuts).cpu()),
                  "recovery: restored cuts differ from the model's — "
                  "same data/config required for replay")
        m.cuts = loaded.cuts
        m.trees = loaded.trees
        m._missing = loaded._missing
        m._obj = loaded._obj
        m._train_preds = None
        m.best_iteration = None
        m.best_score = None

    def _restore_local(self, ck: RoundCheckpointer,
                       floor: Optional[int] = None) -> int:
        version, loaded, _cursor = ck.restore_model(
            type(self.model), mesh=self.model.mesh, floor=floor,
            device=self.model.device)
        if loaded is None:
            return 0
        self._adopt(loaded)
        target = version if floor is None else min(version, max(floor, 0))
        truncate_to_round(self.model, target)
        return target

    # -- single-worker crash-safe loop -----------------------------------
    def run_device(self, device_data: Dict[str, Any],
                   warmup_rounds: int = 0) -> Any:
        """Crash-safe boosting over a ``make_device_data`` handle."""
        model = self.model
        ck = RoundCheckpointer(self.directory)
        committed = self._restore_local(ck)
        if committed:
            self.resumed_from = committed
            LOG("INFO", "recovery: resuming from committed round %d",
                committed)
        self._committed = self.rounds_trained = committed
        while committed < self.total:
            k = min(self.stride, self.total - committed)
            model.param.n_trees = k
            try:
                model.fit_device(device_data, warmup_rounds=warmup_rounds,
                                 chunk_callback=self._chunk_cb,
                                 resume=committed > 0)
            finally:
                # committed state (and save_model bytes) must describe
                # the JOB's config, not the last leg's stride
                model.param.n_trees = self.total
            warmup_rounds = 0
            committed += k
            self._committed = self.rounds_trained = committed
            ck.commit(model, committed, cursor={"rounds": committed})
            self._worker_fault()
        return model

    # -- distributed loop -------------------------------------------------
    def run(self, session: ElasticSession,
            data_factory: Callable[[int, int], Any], n_rows: int,
            cuts: Any = None, eval_every: int = 0,
            join_timeout_s: float = 120.0) -> Any:
        """Elastic data-parallel boosting.

        ``data_factory(lo, hi)`` must return a rewindable
        ``RowBlockIter``-shaped source over global rows ``[lo, hi)`` —
        re-invoked whenever the world re-forms, because an elastic
        re-shard re-cuts ``shard_row_ranges`` over the survivors.
        """
        model = self.model
        ck = RoundCheckpointer(self.directory, rank=session.grank)
        while True:
            session.join(timeout_s=join_timeout_s)
            committed = self._sync_to_floor(ck, session.floor)
            self._committed = self.rounds_trained = committed
            if committed >= self.total:
                break
            lo, hi = shard_row_ranges(n_rows, session.world)[session.wrank]
            row_iter = data_factory(lo, hi)
            coll.set_host_transport(session)
            try:
                while committed < self.total:
                    k = min(self.stride, self.total - committed)
                    model.param.n_trees = k
                    stride_cuts = cuts if cuts is not None else model.cuts
                    try:
                        model.fit_external(row_iter, cuts=stride_cuts,
                                           eval_every=eval_every)
                    finally:
                        model.param.n_trees = self.total
                    committed += k
                    self.rounds_trained = committed
                    ck.commit(model, committed,
                              cursor={"rounds": committed,
                                      "world": session.world,
                                      "wrank": session.wrank,
                                      "rows": [lo, hi]})
                    self._worker_fault()
                    session.commit(committed)
                    self._committed = committed
                break
            except CollectiveAborted as e:
                LOG("WARNING", "recovery: round aborted (%s); rolling "
                    "back to floor and re-joining", e)
                continue
            finally:
                coll.set_host_transport(None)
        return model

    def _sync_to_floor(self, ck: RoundCheckpointer, floor: int) -> int:
        model = self.model
        have = len(model.trees)
        if have > floor:
            # the uncommitted tail never passed the commit barrier: a
            # round commits on all workers or on none
            self.rounds_replayed += have - floor
            if _metrics.enabled():
                _recovery_metrics()["replayed"].inc(have - floor)
            truncate_to_round(model, floor)
        elif have < floor:
            restored = self._restore_local(ck, floor=floor)
            CHECK(restored >= floor,
                  f"recovery: no checkpoint at or past floor {floor} "
                  f"(best {restored}); cannot catch up")
            self.resumed_from = floor
            LOG("INFO", "recovery: rank %d caught up to floor %d from "
                "checkpoint", ck.rank, floor)
        if floor == 0 and not model.trees:
            # virgin state: quantile cuts must be re-derived by the NEW
            # group collectively (a survivor keeping stale cuts would
            # diverge from a diskless rejoiner's sketch sequence)
            model.cuts = None
            model._train_preds = None
        return floor
