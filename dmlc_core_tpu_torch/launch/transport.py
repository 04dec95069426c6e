"""Transports: spawn/poll/signal/kill ONE worker process on a host.

A :class:`Transport` is the narrow waist between the :class:`~dmlc_core_tpu_torch.
launch.jobset.JobSet` supervisor and a cluster substrate: it can spawn a
command on a named host with an env overlay, poll the resulting
:class:`WorkerHandle` for an exit code, deliver signals, and stream the
worker's env + log tail back for diagnosis.  Everything rank-shaped
(DMLC_TASK_ID injection, restart budgets, tracker cross-checks) lives in
the JobSet — a transport knows processes and hosts, nothing else.

* :class:`LocalTransport` — subprocess.Popen with per-worker log files
  and ``PR_SET_PDEATHSIG`` on Linux, so workers die with the launcher
  instead of leaking (the historical ``tracker/local.py`` bug: its
  fire-and-forget children survived a dead parent).
* :class:`SSHTransport` — the ``tracker/ssh.py`` launch idiom behind the
  Transport interface: ``ssh -tt host 'cd dir && env K=V cmd'`` per
  worker, host-file slots for placement, and the forced tty means the
  remote command dies when the local ssh process is killed.
* :class:`FakeTransport` — a deterministic in-process "cluster": local
  subprocesses labeled with virtual host names, with host failures and
  spawn latency scriptable through the ``base/faultinject`` grammar
  (``launch_host:kill=h1:after=20`` downs fake host ``h1`` on the 20th
  supervisor tick).  This is how CI proves multi-host supervision
  without any real SSH/k8s cluster.

The PyTorch port's counterpart of ``dmlc_core_tpu/launch/transport.py``:
the same transports, fault-injection points (the port's
``base/faultinject.py``) and ``DMLC_LAUNCH_LOG_DIR``, read from the
environment directly.  The Kubernetes transport lives in
:mod:`dmlc_core_tpu_torch.launch.k8s` (it renders indexed-Job manifests
rather than holding a process handle).
"""

from __future__ import annotations

import math
import os
import shlex
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base import faultinject
from dmlc_core_tpu_torch.base.logging import CHECK, LOG

__all__ = ["TransportError", "WorkerHandle", "Transport",
           "LocalTransport", "SSHTransport", "FakeTransport"]


class TransportError(RuntimeError):
    """A transport could not spawn or reach a worker (dead host, spawn
    failure) — the JobSet treats it as a restartable worker fault."""


class WorkerHandle:
    """One spawned worker process: where it runs, how it was started,
    and the live process/remote reference the owning transport polls."""

    __slots__ = ("host", "label", "env", "log_path", "proc", "extra")

    def __init__(self, host: str, label: str, env: Dict[str, str],
                 log_path: str = "", proc: Optional[subprocess.Popen] = None,
                 extra: Optional[Dict[str, object]] = None):
        self.host = host
        self.label = label
        #: env OVERLAY the worker was spawned with (the DMLC_*/FLEET_*
        #: ABI) — not the full inherited environment
        self.env = dict(env)
        self.log_path = log_path
        self.proc = proc
        self.extra = extra or {}

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def __repr__(self) -> str:
        return (f"WorkerHandle({self.label!r} on {self.host!r}, "
                f"pid={self.pid})")


def _pdeathsig_preexec() -> None:
    """Child-side: die with the parent (Linux ``PR_SET_PDEATHSIG``).

    This is the fix for the fire-and-forget leak: a launcher killed with
    SIGKILL used to orphan every worker it had spawned."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG = 1
    except Exception:  # noqa: BLE001 — best effort, non-Linux is a no-op
        pass


def _read_tail(path: str, max_bytes: int) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


class Transport:
    """Abstract substrate: one method per thing a supervisor needs.

    ``spawn(command, env, host, label)`` starts ONE process; ``env`` is
    an overlay (the DMLC ABI), not a full environment — local transports
    merge it over ``os.environ``, remote ones export exactly it.
    """

    name = "abstract"

    def hosts(self) -> List[str]:
        """Placement slots, one entry per schedulable worker slot (a
        host with k slots appears k times)."""
        raise NotImplementedError

    def host_alive(self, host: str) -> bool:
        """Is ``host`` currently accepting spawns?  (FakeTransport downs
        hosts; real transports default to optimistic True.)"""
        del host
        return True

    def classify_exit(self, handle: WorkerHandle, code: int) -> str:
        """Attribute a worker's unexpected exit: ``"host_death"`` when
        the host itself is gone (spot preemption, node failure — the
        JobSet charges the HOST's fault budget, not the rank's restart
        budget), else ``"crash"`` (the worker's own fault).  The base
        rule is simply the host-liveness view; transports with richer
        evidence (SSH connect errors) refine it."""
        del code
        return "host_death" if not self.host_alive(handle.host) else "crash"

    def spawn(self, command: List[str], env: Dict[str, str],
              host: str, label: str = "worker") -> WorkerHandle:
        raise NotImplementedError

    def poll(self, handle: WorkerHandle) -> Optional[int]:
        """Exit code, or None while the worker is still running."""
        raise NotImplementedError

    def signal(self, handle: WorkerHandle, sig: int) -> None:
        raise NotImplementedError

    def kill(self, handle: WorkerHandle) -> None:
        self.signal(handle, signal.SIGKILL)

    def env_of(self, handle: WorkerHandle) -> Dict[str, str]:
        """The env overlay the worker was spawned with (diagnosis)."""
        return dict(handle.env)

    def log_tail(self, handle: WorkerHandle, max_bytes: int = 4096) -> str:
        """Last ``max_bytes`` of the worker's captured output."""
        return _read_tail(handle.log_path, max_bytes) if handle.log_path else ""

    def tick(self) -> None:
        """Called once per supervisor monitor cycle — fault-injection
        hook point for scriptable transports; default no-op."""

    def close(self) -> None:
        """Release transport resources (log dirs stay for post-mortem)."""


class LocalTransport(Transport):
    """Workers as local subprocesses with captured logs + pdeathsig.

    ``hosts`` may name virtual slots (every slot is this machine); the
    default is one ``localhost`` slot reused round-robin.
    """

    name = "local"

    def __init__(self, hosts: Optional[List[str]] = None,
                 log_dir: Optional[str] = None,
                 capture_logs: bool = True):
        self._hosts = list(hosts) if hosts else ["localhost"]
        CHECK(len(self._hosts) > 0, "LocalTransport: empty host list")
        if log_dir is None:
            log_dir = os.environ.get("DMLC_LAUNCH_LOG_DIR", "")
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="dmlc-launch-")
        self._capture = capture_logs
        os.makedirs(self.log_dir, exist_ok=True)

    def hosts(self) -> List[str]:
        return list(self._hosts)

    def _popen_kwargs(self) -> Dict[str, object]:
        kw: Dict[str, object] = {}
        if sys.platform.startswith("linux"):
            kw["preexec_fn"] = _pdeathsig_preexec
        return kw

    def spawn(self, command: List[str], env: Dict[str, str],
              host: str, label: str = "worker") -> WorkerHandle:
        CHECK(len(command) > 0, f"{self.name} transport: empty command")
        full_env = dict(os.environ)
        full_env.update(env)
        log_path = ""
        stdout = stderr = subprocess.DEVNULL
        if self._capture:
            log_path = os.path.join(self.log_dir, f"{label}.log")
            log_f = open(log_path, "ab")
            stdout, stderr = log_f, subprocess.STDOUT
        try:
            proc = subprocess.Popen(command, env=full_env, stdout=stdout,
                                    stderr=stderr, **self._popen_kwargs())
        finally:
            if self._capture:
                log_f.close()   # child holds its own descriptor
        return WorkerHandle(host, label, env, log_path=log_path, proc=proc)

    def poll(self, handle: WorkerHandle) -> Optional[int]:
        return handle.proc.poll()

    def signal(self, handle: WorkerHandle, sig: int) -> None:
        if handle.proc.poll() is None:
            try:
                handle.proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass            # lost the race with the exit


#: stderr signatures of an ssh CONNECT failure (vs the remote command
#: failing): the host itself is unreachable, so the exit is a host
#: death, not a worker crash
_SSH_CONNECT_ERRORS = (
    "connection refused",
    "connection timed out",
    "no route to host",
    "could not resolve hostname",
    "ssh: connect to host",
    "connection reset by peer",
    "network is unreachable",
)


class SSHTransport(LocalTransport):
    """One worker per ``ssh`` child; the remote command carries the env.

    ``hosts`` is the slot-expanded list from
    :func:`~dmlc_core_tpu_torch.tracker.ssh.read_host_file`.  ``-tt``
    forces a remote tty so killing the local ssh process (targeted kill,
    teardown, pdeathsig) hangs up the remote side too instead of
    orphaning it — the supervised replacement for the fire-and-forget
    ``tracker/ssh.py`` launch.

    **Dead-host detection**: ssh exits 255 for its OWN failures.  A 255
    whose log tail carries a connect-error signature (connection
    refused/timed out, no route, unresolvable name) — or no output at
    all, the connect died before the remote shell spoke — is classified
    as a *host death*: the host is marked down (``host_alive`` False,
    excluded from placement) until :meth:`restore_host`, and the JobSet
    respawns the rank on a survivor without charging its restart
    budget.  A 255 with remote output is the remote command's own exit
    status — a crash like any other.
    """

    name = "ssh"

    def __init__(self, hosts: List[str], cwd: Optional[str] = None,
                 ssh_binary: str = "ssh",
                 log_dir: Optional[str] = None):
        super().__init__(hosts=hosts, log_dir=log_dir)
        CHECK(len(hosts) > 0, "SSHTransport: empty host list")
        self.cwd = cwd or os.getcwd()
        self.ssh_binary = ssh_binary
        self._dead_lock = threading.Lock()
        self._dead: set = set()

    def host_alive(self, host: str) -> bool:
        with self._dead_lock:
            return host not in self._dead

    def restore_host(self, host: str) -> None:
        """Forget a host death (capacity came back / ops fixed it) so
        placement may use the host again."""
        with self._dead_lock:
            self._dead.discard(host)

    def down_hosts(self) -> List[str]:
        with self._dead_lock:
            return sorted(self._dead)

    def classify_exit(self, handle: WorkerHandle, code: int) -> str:
        if not self.host_alive(handle.host):
            return "host_death"
        if code != 255:
            return "crash"
        tail = self.log_tail(handle, 4096).lower()
        if tail.strip() and not any(sig in tail
                                    for sig in _SSH_CONNECT_ERRORS):
            return "crash"      # remote command's own exit 255
        with self._dead_lock:
            self._dead.add(handle.host)
        LOG("WARNING", "ssh transport: host %s classified dead "
            "(exit 255, connect error) — excluded from placement",
            handle.host)
        return "host_death"

    def build_argv(self, host: str, command: List[str],
                   env: Dict[str, str]) -> List[str]:
        """The exact local argv for one remote worker (pure; tested)."""
        env_part = " ".join(f"{k}={shlex.quote(str(v))}"
                            for k, v in env.items())
        cmd_part = " ".join(shlex.quote(c) for c in command)
        remote = f"cd {shlex.quote(self.cwd)} && env {env_part} {cmd_part}"
        return [self.ssh_binary, "-tt",
                "-o", "StrictHostKeyChecking=no",
                "-o", "BatchMode=yes", host, remote]

    def spawn(self, command: List[str], env: Dict[str, str],
              host: str, label: str = "worker") -> WorkerHandle:
        CHECK(len(command) > 0, "ssh transport: empty command")
        argv = self.build_argv(host, command, env)
        handle = super().spawn(argv, {}, host, label=label)
        handle.env.update(env)  # overlay travels inside argv, not Popen env
        return handle


class FakeTransport(LocalTransport):
    """Deterministic in-process "cluster" for CI drills and tests.

    Real local subprocesses, virtual host placement, and two
    fault-injection points wired into the ``base/faultinject`` grammar:

    * ``launch_spawn`` — checked at every spawn.  ``error`` makes the
      spawn raise :class:`TransportError` (the JobSet retries on another
      host); ``latency=<seconds>`` delays the spawn.
    * ``launch_host`` — checked once per supervisor tick *while the fake
      cluster has live workers*.  ``kill=<host>`` SIGKILLs every worker
      on that host and marks it down (``host_alive`` False, spawns on it
      raise) — the scripted mid-round host death of
      ``scripts/check_launch.py``.  ``wave=<fraction>`` is the scripted
      **spot-preemption wave**: downs ``ceil(fraction * hosts)`` of the
      currently-alive hosts AT ONCE, in host-list order (default 0.3 —
      a 30% capacity loss in one tick, the prodsim drill's scenario);
      ``restore`` brings every downed host back (spot capacity
      returning).

    ``fail_host`` / ``restore_host`` give tests direct control without
    the grammar.
    """

    name = "fake"

    def __init__(self, hosts: Optional[List[str]] = None,
                 log_dir: Optional[str] = None):
        super().__init__(hosts=list(hosts) if hosts else ["h0", "h1", "h2"],
                         log_dir=log_dir)
        self._lock = threading.Lock()
        self._down: set = set()
        self._live: List[WorkerHandle] = []

    def host_alive(self, host: str) -> bool:
        with self._lock:
            return host not in self._down

    def spawn(self, command: List[str], env: Dict[str, str],
              host: str, label: str = "worker") -> WorkerHandle:
        fault = faultinject.check("launch_spawn", host)
        if fault is not None:
            if fault.kind == "latency":
                time.sleep(float(fault.value or "0.05"))
            else:
                raise TransportError(
                    f"fake transport: injected spawn {fault.kind} "
                    f"on {host}")
        with self._lock:
            down = host in self._down
        if down:
            raise TransportError(f"fake transport: host {host} is down")
        handle = super().spawn(command, env, host, label=label)
        with self._lock:
            self._live.append(handle)
        return handle

    def tick(self) -> None:
        with self._lock:
            self._live = [h for h in self._live if h.proc.poll() is None]
            busy = bool(self._live)
        if not busy:
            return
        fault = faultinject.check("launch_host")
        if fault is None:
            return
        if fault.kind in ("kill", "down"):
            host = fault.value or self._hosts[0]
            LOG("WARNING", "fake transport: injected %s of host %s",
                fault.kind, host)
            self.fail_host(host)
        elif fault.kind == "wave":
            self.preempt_wave(float(fault.value or "0.3"))
        elif fault.kind == "restore":
            for host in self.down_hosts():
                LOG("INFO", "fake transport: injected restore of host %s",
                    host)
                self.restore_host(host)

    def preempt_wave(self, fraction: float = 0.3) -> List[str]:
        """Spot-preemption wave: down ``ceil(fraction * hosts)`` of the
        currently-alive hosts at once (host-list order, so the victim
        set is deterministic); returns the victims."""
        uniq = list(dict.fromkeys(self._hosts))    # dedupe, keep order
        alive = [h for h in uniq if self.host_alive(h)]
        n = min(len(alive), max(1, math.ceil(fraction * len(alive))))
        victims = alive[:n]
        LOG("WARNING", "fake transport: spot-preemption wave downs "
            "%d/%d hosts at once: %s", n, len(alive), victims)
        for host in victims:
            self.fail_host(host)
        return victims

    def fail_host(self, host: str) -> None:
        """Down a fake host: SIGKILL its live workers, refuse spawns."""
        with self._lock:
            self._down.add(host)
            victims = [h for h in self._live if h.host == host]
        for h in victims:
            self.signal(h, signal.SIGKILL)

    def restore_host(self, host: str) -> None:
        with self._lock:
            self._down.discard(host)

    def down_hosts(self) -> List[str]:
        with self._lock:
            return sorted(self._down)
