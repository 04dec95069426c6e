"""JobSet: a supervised ranked worker set over any Transport.

This is the launcher role PAPER.md §1 assigns ``dmlc_tracker`` — not
just *starting* N ranked workers but owning their lifecycle:

* **launch** — spawn ranks 0..n-1 round-robin over the transport's live
  host slots, each with the DMLC env ABI injected (``DMLC_TASK_ID`` =
  rank, ``DMLC_ROLE``, ``DMLC_NUM_ATTEMPT``) plus a per-rank overlay
  hook (``env_for``) for FLEET_*-style ABIs.
* **monitor** — a supervisor thread polls every handle each
  ``DMLC_LAUNCH_MONITOR_S`` and, when a tracker is attached,
  cross-checks process liveness against the tracker's heartbeat view:
  a rank whose process is alive but which the tracker has carried as
  lost for ``DMLC_LAUNCH_WEDGE_CYCLES`` cycles is *wedged* — killed so
  the ordinary respawn path replaces it.
* **restart-with-backoff** — an unexpected exit (nonzero / signaled,
  not an intentional stop) schedules a respawn after
  :meth:`~dmlc_core_tpu_torch.base.resilience.RetryPolicy.backoff_for`, under
  a per-rank ``DMLC_LAUNCH_RESTART_LIMIT`` budget; placement re-runs
  against the *currently live* hosts, so a dead host's ranks land on
  survivors.  ``DMLC_NUM_ATTEMPT`` counts up so the worker (and the
  tracker's ``recover`` path) knows it is a replacement.  The budget is
  **cause-fair**: the transport's ``classify_exit`` attributes each
  exit, and only a ``crash`` (the rank's own fault) spends the rank's
  budget — a ``host_death`` (spot preemption, SSH connect failure)
  charges the host's fault map instead, so a rank preempted twice by a
  spot wave keeps its full restart budget for a genuine crash.
  ``events()`` carries the cause per exit; ``stats()`` breaks respawns
  down by cause.
* **targeted kill / graceful teardown** — ``kill(rank)`` stops one rank
  (optionally letting it respawn); ``shutdown()`` SIGTERMs everything,
  waits ``DMLC_LAUNCH_GRACEFUL_S``, SIGKILLs stragglers.

Evidence: lifecycle events (``events()``), spawn-latency samples and
respawn counts (``stats()``), and the ``dmlc_launch_*`` metrics rows
documented in ``doc/observability.md``.

The PyTorch port's counterpart of ``dmlc_core_tpu/launch/jobset.py``:
the same supervision, env ABI and metric names.  The ``DMLC_LAUNCH_*``
settings are read from the environment directly, with the JAX package's
defaults (restart limit 2, monitor 0.2 s, grace 5 s, wedge 25 cycles).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.racecheck import instrument_class
from dmlc_core_tpu_torch.base import tracectx as _tracectx
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.resilience import RetryPolicy
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.launch.instruments import launch_metrics
from dmlc_core_tpu_torch.launch.transport import (LocalTransport, Transport,
                                            TransportError, WorkerHandle)

__all__ = ["JobSet", "LaunchTimeout"]


def _env(name: str, default: Any, cast: Callable[[str], Any]) -> Any:
    """``name`` from the environment, ``default`` when unset or empty."""
    raw = os.environ.get(name, "")
    return cast(raw) if raw else default


class LaunchTimeout(RuntimeError):
    """`JobSet.wait` ran past its deadline with ranks still running."""


class _Rank:
    """Supervision state for one rank (all mutation under the JobSet
    lock; ``spawning`` guards the out-of-lock spawn window).

    ``attempt`` counts every respawn (it drives ``DMLC_NUM_ATTEMPT`` and
    backoff); ``crashes`` counts only the rank's OWN faults — the subset
    that consumes ``DMLC_LAUNCH_RESTART_LIMIT``.  A host death (spot
    preemption, node failure) respawns the rank without charging it:
    the fault is the host's, tracked in the JobSet's per-host map."""

    __slots__ = ("rank", "handle", "last_handle", "attempt", "crashes",
                 "spawn_errors", "code", "done", "stopping", "retry_at",
                 "spawning", "lost_cycles", "seen_live")

    def __init__(self, rank: int):
        self.rank = rank
        self.handle: Optional[WorkerHandle] = None
        self.last_handle: Optional[WorkerHandle] = None
        self.attempt = 0
        self.crashes = 0
        self.spawn_errors = 0
        self.code: Optional[int] = None
        self.done = False
        self.stopping = False
        self.retry_at: Optional[float] = None
        self.spawning = False
        self.lost_cycles = 0
        #: the tracker has held this attempt's rank as live at least once
        self.seen_live = False


#: how long :meth:`JobSet.shutdown` waits for the supervisor's last step
_SUPERVISOR_JOIN_S = 60.0


@instrument_class
class JobSet:
    """Launch + supervise ``nworker`` ranked processes over a transport.

    ``envs`` is the shared env ABI (typically ``tracker.slave_envs()``);
    ``env_for(rank, attempt)`` adds per-rank overlay vars.  ``tracker``
    is any object with ``lost_ranks() -> List[int]`` (RabitTracker and
    subclasses) keyed by the same rank space as ``DMLC_TASK_ID`` — the
    heartbeat half of the liveness cross-check.
    """

    def __init__(self, command: List[str], nworker: int,
                 transport: Optional[Transport] = None,
                 envs: Optional[Dict[str, str]] = None,
                 name: str = "jobset", role: str = "worker",
                 restart_limit: Optional[int] = None,
                 monitor_s: Optional[float] = None,
                 graceful_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 tracker: Optional[Any] = None,
                 env_for: Optional[
                     Callable[[int, int], Dict[str, str]]] = None):
        CHECK(len(command) > 0, "JobSet: empty worker command")
        CHECK(nworker >= 0, f"JobSet: bad nworker {nworker}")
        self._command = list(command)
        self._nworker = nworker
        self._transport = transport if transport is not None else LocalTransport()
        self._envs = dict(envs or {})
        self.name = name
        self._role = role
        self._restart_limit = (restart_limit if restart_limit is not None
                               else _env("DMLC_LAUNCH_RESTART_LIMIT", 2, int))
        self._monitor_s = (monitor_s if monitor_s is not None
                           else _env("DMLC_LAUNCH_MONITOR_S", 0.2, float))
        self._graceful_s = (graceful_s if graceful_s is not None
                            else _env("DMLC_LAUNCH_GRACEFUL_S", 5.0, float))
        self._wedge_cycles = _env("DMLC_LAUNCH_WEDGE_CYCLES", 25, int)
        self._retry = retry if retry is not None else RetryPolicy.from_env()
        self._tracker = tracker
        self._env_for = env_for
        self._lock = threading.Lock()
        self._ranks: Dict[int, _Rank] = {}
        self._next_rank = nworker
        self._events: List[Dict[str, Any]] = []
        self._spawn_ms: List[float] = []
        self._respawns = 0
        #: respawns scheduled, broken down by exit cause
        #: ("crash" | "host_death" | "spawn_error")
        self._respawns_by_cause: Dict[str, int] = {}
        #: host-death charges per host — the budget a preemption burns
        self._host_faults: Dict[str, int] = {}
        self._launched = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def transport(self) -> Transport:
        return self._transport

    # -- env ABI ---------------------------------------------------------
    def worker_env(self, rank: int, attempt: int = 0) -> Dict[str, str]:
        """The env OVERLAY rank ``rank`` is spawned with (pure given a
        fixed observability env — this is what the golden per-backend
        env tests snapshot; with no spool/trace configured nothing
        extra is injected, so the snapshots are exact)."""
        env = dict(self._envs)
        env["DMLC_TASK_ID"] = str(rank)
        env["DMLC_ROLE"] = self._role
        env["DMLC_NUM_ATTEMPT"] = str(attempt)
        env.setdefault("DMLC_NUM_WORKER", str(self._nworker))
        # observability overlay: children join the launcher's metrics
        # spool and trace so the whole job aggregates into one artifact
        spool = os.environ.get("DMLC_METRICS_SPOOL", "")
        if spool:
            env.setdefault("DMLC_METRICS_SPOOL", spool)
        trace = _tracectx.current_header()
        if trace is not None:
            env.setdefault(_tracectx.ENV_KEY, trace)
        if self._env_for is not None:
            env.update(self._env_for(rank, attempt) or {})
        return env

    # -- evidence --------------------------------------------------------
    def _event_locked(self, kind: str, rank: int, host: str = "",
                      detail: str = "", cause: str = "") -> None:
        ev = {"ts": get_time(), "event": kind, "rank": rank,
              "host": host, "detail": detail}
        if cause:
            ev["cause"] = cause
        self._events.append(ev)
        if _metrics.enabled():
            launch_metrics()["events"].inc(1, event=kind)

    def events(self) -> List[Dict[str, Any]]:
        """Lifecycle event log (copies; spawn/exit/respawn/giveup/...)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def stats(self) -> Dict[str, Any]:
        """Supervision evidence: backend, respawns (total AND per exit
        cause — crash vs host_death vs spawn_error), per-host fault
        charges, spawn-latency p95, and per-rank state — the ``bench.py
        --fleet`` launch record."""
        with self._lock:
            ms = sorted(self._spawn_ms)
            p95 = ms[min(len(ms) - 1, int(round(0.95 * (len(ms) - 1))))] if ms else 0.0
            return {
                "backend": self._transport.name,
                "respawns": self._respawns,
                "respawns_by_cause": dict(self._respawns_by_cause),
                "host_faults": dict(self._host_faults),
                "spawn_ms_p95": p95,
                "spawns": len(ms),
                "ranks": {
                    st.rank: {"attempt": st.attempt,
                              "crashes": st.crashes, "code": st.code,
                              "done": st.done,
                              "host": st.handle.host if st.handle else None}
                    for st in self._ranks.values()},
            }

    def respawns(self) -> int:
        with self._lock:
            return self._respawns

    def alive_count(self) -> int:
        with self._lock:
            handles = [st.handle for st in self._ranks.values()
                       if not st.done and st.handle is not None
                       and not st.spawning]
        return sum(1 for h in handles if self._transport.poll(h) is None)

    def rank_host(self, rank: int) -> Optional[str]:
        with self._lock:
            st = self._ranks.get(rank)
            return st.handle.host if st is not None and st.handle else None

    def log_tail(self, rank: int, max_bytes: int = 4096) -> str:
        with self._lock:
            st = self._ranks.get(rank)
            handle = (st.handle or st.last_handle) if st is not None else None
        return self._transport.log_tail(handle, max_bytes) if handle else ""

    # -- spawning --------------------------------------------------------
    def _place(self, rank: int) -> str:
        """Slot-aware bin-packing over live hosts.  ``hosts()`` is the
        slot-expanded host file (a host contributing k slots appears k
        times); the winner is the live host with the most FREE slots —
        declared slots minus the ranks currently placed on it — so a
        4-slot host absorbs four ranks before a 1-slot host sees a
        second, and a respawn after a host death lands on the survivor
        with capacity instead of at ``rank % len(hosts)`` (which is
        blind to both slot counts and occupancy)."""
        slots: Dict[str, int] = {}
        for h in self._transport.hosts():
            if self._transport.host_alive(h):
                slots[h] = slots.get(h, 0) + 1
        if not slots:
            raise TransportError(
                f"jobset {self.name}: no live hosts to place rank {rank}")
        with self._lock:
            for st in self._ranks.values():
                if st.rank == rank or st.done or st.handle is None:
                    continue
                if st.handle.host in slots:
                    slots[st.handle.host] -= 1
        # most free slots wins; host-file order breaks ties
        return max(slots, key=lambda h: slots[h])

    def _do_spawn(self, rank: int) -> bool:
        """Spawn one rank whose state is marked ``spawning`` (transport
        work happens OUTSIDE the lock; state commits back under it)."""
        with self._lock:
            st = self._ranks[rank]
            attempt = st.attempt
        label = f"{self.name}-r{rank}-a{attempt}"
        try:
            t0 = get_time()
            host = self._place(rank)
            handle = self._transport.spawn(
                self._command, self.worker_env(rank, attempt), host,
                label=label)
            dt = get_time() - t0
        except TransportError as e:
            with self._lock:
                st.spawning = False
                # spawn failures have their own budget counter: with
                # host deaths no longer charging the rank, ``attempt``
                # may legitimately exceed the restart limit
                st.spawn_errors += 1
                if st.stopping or st.spawn_errors > self._restart_limit:
                    st.done = True
                    if st.code is None:
                        st.code = 1
                    self._event_locked("giveup", rank, "", str(e),
                                       cause="spawn_error")
                else:
                    st.attempt = attempt + 1
                    st.retry_at = (get_time()
                                   + self._retry.backoff_for(st.attempt))
                    self._respawns_by_cause["spawn_error"] = \
                        self._respawns_by_cause.get("spawn_error", 0) + 1
                    self._event_locked("spawn_error", rank, "", str(e))
            LOG("WARNING", "jobset %s: spawn of rank %d failed: %s",
                self.name, rank, e)
            return False
        with self._lock:
            st.handle = handle
            st.last_handle = handle
            st.spawning = False
            st.code = None
            st.retry_at = None
            st.lost_cycles = 0
            st.seen_live = False
            self._spawn_ms.append(dt * 1e3)
            if attempt > 0:
                self._respawns += 1
            self._event_locked("spawn" if attempt == 0 else "respawn",
                               rank, handle.host, f"attempt={attempt}")
        if _metrics.enabled():
            launch_metrics()["spawn"].observe(dt,
                                              transport=self._transport.name)
            if attempt > 0:
                launch_metrics()["respawns"].inc(1, jobset=self.name)
        LOG("INFO", "jobset %s: rank %d attempt %d → %s (%s)",
            self.name, rank, attempt, handle.host, label)
        return True

    def launch(self) -> "JobSet":
        """Spawn every rank and start the supervisor thread."""
        with self._lock:
            CHECK(not self._launched, f"jobset {self.name} already launched")
            self._launched = True
            for rank in range(self._nworker):
                st = _Rank(rank)
                st.spawning = True
                self._ranks[rank] = st
        for rank in range(self._nworker):
            self._do_spawn(rank)
        self._publish_workers()
        if self._monitor_s > 0:
            self._thread = threading.Thread(
                target=self._monitor, daemon=True,
                name=f"jobset-{self.name}")
            self._thread.start()
        return self

    def add_rank(self) -> int:
        """Grow the set by one rank (launcher-backed scale-out);
        returns the new rank index."""
        with self._lock:
            CHECK(self._launched, "add_rank before launch()")
            rank = self._next_rank
            self._next_rank += 1
            st = _Rank(rank)
            st.spawning = True
            self._ranks[rank] = st
        self._do_spawn(rank)
        self._publish_workers()
        return rank

    # -- supervision -----------------------------------------------------
    def _monitor(self) -> None:
        while not self._stop.wait(self._monitor_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — supervisor must not die
                LOG("WARNING", "jobset %s: monitor step failed: %s",
                    self.name, e)

    def step(self) -> None:
        """One supervision cycle (public so tests/drills can drive the
        JobSet without the thread): poll, reap, respawn-due, cross-check."""
        self._transport.tick()
        with self._lock:
            live = [(st.rank, st.handle) for st in self._ranks.values()
                    if not st.done and st.handle is not None
                    and not st.spawning]
        for rank, handle in live:
            code = self._transport.poll(handle)
            if code is not None:
                self._on_exit(rank, handle, code)
        self._respawn_due()
        self._cross_check()
        self._publish_workers()

    def _on_exit(self, rank: int, handle: WorkerHandle, code: int) -> None:
        tail = ""
        # attribute the exit BEFORE taking the lock: SSH classification
        # may read the worker's log tail (file I/O)
        cause = "crash"
        if code != 0:
            try:
                cause = self._transport.classify_exit(handle, code)
            except Exception:  # noqa: BLE001 — classification is advisory
                cause = "crash"
        with self._lock:
            st = self._ranks.get(rank)
            if st is None or st.done or st.handle is not handle:
                return
            st.code = code
            if code == 0 or st.stopping:
                st.done = True
                self._event_locked("stop" if st.stopping else "exit",
                                   rank, handle.host, f"code={code}")
            elif cause == "crash" and st.crashes + 1 > self._restart_limit:
                # only the rank's OWN faults spend its restart budget —
                # a rank preempted N times by host deaths keeps the full
                # budget for a genuine crash
                st.done = True
                self._event_locked("giveup", rank, handle.host,
                                   f"code={code} after "
                                   f"{st.crashes + 1} crashes "
                                   f"({st.attempt + 1} attempts)",
                                   cause=cause)
            else:
                # detach the dead handle: a handle left in place would be
                # re-polled (and re-counted against the budget) every
                # cycle until the backoff lapsed
                st.handle = None
                st.last_handle = handle
                st.attempt += 1
                if cause == "crash":
                    st.crashes += 1
                else:
                    # the host ate the fault, not the rank
                    self._host_faults[handle.host] = \
                        self._host_faults.get(handle.host, 0) + 1
                self._respawns_by_cause[cause] = \
                    self._respawns_by_cause.get(cause, 0) + 1
                st.retry_at = get_time() + self._retry.backoff_for(st.attempt)
                self._event_locked("exit", rank, handle.host,
                                   f"code={code} respawn={st.attempt}",
                                   cause=cause)
            gave_up = st.done and code != 0 and not st.stopping
        if gave_up:
            tail = self._transport.log_tail(handle, 2048)
            LOG("ERROR", "jobset %s: rank %d exited %d, restart budget "
                "spent; log tail:\n%s", self.name, rank, code, tail)
        elif code != 0:
            LOG("WARNING", "jobset %s: rank %d on %s exited %d",
                self.name, rank, handle.host, code)

    def _respawn_due(self) -> None:
        now = get_time()
        with self._lock:
            due = []
            for st in self._ranks.values():
                if (not st.done and not st.spawning
                        and st.retry_at is not None and st.retry_at <= now):
                    st.retry_at = None
                    st.spawning = True
                    due.append(st.rank)
        for rank in due:
            self._do_spawn(rank)

    def _cross_check(self) -> None:
        """Heartbeat cross-check: a rank the tracker holds as LOST whose
        process still polls alive is wedged — kill it so the normal
        respawn path replaces it.  Only an attempt the tracker has held
        as live counts (ROADMAP C21): a respawn starts while the tracker
        still holds its predecessor as lost, and must not be killed for
        taking longer than the wedge window to reconnect."""
        if self._tracker is None:
            return
        try:
            lost = set(self._tracker.lost_ranks())
        except Exception:  # noqa: BLE001 — tracker may be stopping
            return
        wedged: List[WorkerHandle] = []
        with self._lock:
            for st in self._ranks.values():
                if st.done or st.spawning or st.handle is None:
                    continue
                if st.rank not in lost:
                    st.seen_live = True
                    st.lost_cycles = 0
                elif st.seen_live:
                    st.lost_cycles += 1
                    if st.lost_cycles >= self._wedge_cycles:
                        st.lost_cycles = 0
                        self._event_locked("wedged", st.rank,
                                           st.handle.host)
                        wedged.append(st.handle)
        for handle in wedged:
            LOG("WARNING", "jobset %s: killing wedged worker %r "
                "(process alive, tracker lost it)", self.name, handle)
            self._transport.kill(handle)

    def _publish_workers(self) -> None:
        if not _metrics.enabled():
            return
        with self._lock:
            n = sum(1 for st in self._ranks.values()
                    if not st.done and st.handle is not None)
        launch_metrics()["workers"].set(n, jobset=self.name)

    # -- control plane ---------------------------------------------------
    def kill(self, rank: int, sig: int = signal.SIGTERM,
             respawn: bool = False) -> None:
        """Targeted kill of one rank.  With ``respawn=True`` the exit is
        treated as a fault and the restart budget brings it back."""
        with self._lock:
            st = self._ranks.get(rank)
            CHECK(st is not None, f"jobset {self.name}: unknown rank {rank}")
            handle = st.handle
            if not respawn:
                st.stopping = True
            self._event_locked("stop" if not respawn else "restart",
                               rank, handle.host if handle else "",
                               f"sig={sig}")
        if handle is not None:
            self._transport.signal(handle, sig)

    def wait(self, timeout: Optional[float] = None) -> Dict[int, int]:
        """Block until every rank is done (clean exit, intentional stop
        or spent budget); returns {rank: last exit code}.  Raises
        :class:`LaunchTimeout` past ``timeout`` seconds."""
        deadline = None if timeout is None else get_time() + timeout
        while True:
            if self._thread is None:
                self.step()
            with self._lock:
                if all(st.done for st in self._ranks.values()):
                    return {st.rank: (st.code if st.code is not None else 1)
                            for st in self._ranks.values()}
            if deadline is not None and get_time() > deadline:
                raise LaunchTimeout(
                    f"jobset {self.name}: workers still running after "
                    f"{timeout}s")
            time.sleep(max(0.01, min(self._monitor_s, 0.1)))

    def run(self, timeout: Optional[float] = None) -> List[int]:
        """launch + wait + teardown in one call (the dmlc-submit path);
        returns exit codes in rank order."""
        self.launch()
        try:
            codes = self.wait(timeout=timeout)
        finally:
            self.shutdown()
        return [codes[r] for r in sorted(codes)]

    def shutdown(self, graceful_s: Optional[float] = None) -> None:
        """Graceful teardown: stop supervising, SIGTERM everything, wait
        the grace window, SIGKILL stragglers, close the transport."""
        grace = self._graceful_s if graceful_s is None else graceful_s
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            # the supervisor ends with its current step, which may be a
            # respawn's fork of a large parent (seconds on a loaded host):
            # wait for it (ROADMAP C23), or its worker outlives teardown
            thread.join(timeout=max(_SUPERVISOR_JOIN_S, 5 * self._monitor_s))
            if thread.is_alive():
                LOG("WARNING", "jobset %s: supervisor still in a step "
                    "after %.0f s", self.name, _SUPERVISOR_JOIN_S)
        with self._lock:
            pending = []
            for st in self._ranks.values():
                st.stopping = True
                st.retry_at = None
                if not st.done and st.handle is not None:
                    pending.append((st.rank, st.handle))
        for _, handle in pending:
            self._transport.signal(handle, signal.SIGTERM)
        deadline = get_time() + grace
        while pending and get_time() < deadline:
            pending = [(r, h) for r, h in pending
                       if self._transport.poll(h) is None]
            if pending:
                time.sleep(0.05)
        for _, handle in pending:
            self._transport.kill(handle)
        kill_deadline = get_time() + 5.0
        while pending and get_time() < kill_deadline:
            pending = [(r, h) for r, h in pending
                       if self._transport.poll(h) is None]
            if pending:
                time.sleep(0.02)
        with self._lock:
            for st in self._ranks.values():
                if not st.done:
                    st.done = True
                    if st.handle is not None and st.code is None:
                        st.code = self._transport_code(st.handle)
            self._event_locked("teardown", -1)
        self._transport.close()
        if _metrics.enabled():
            launch_metrics()["workers"].set(0, jobset=self.name)

    def _transport_code(self, handle: WorkerHandle) -> int:
        code = self._transport.poll(handle)
        return code if code is not None else -9
