"""Autoscale hooks: queue-wait-driven scale recommendations, and a
local-process backend that acts on them.

The signal is the one ``doc/serving.md`` already teaches operators to
read: ``serve_queue_wait_seconds`` p99 — time requests sit WAITING for
a batch slot.  Execute time scales with the model, queue wait scales
with load; when the worst replica's queue-wait p99 crosses
``DMLC_FLEET_SCALE_OUT_S`` for ``DMLC_FLEET_PATIENCE`` consecutive
observations the policy recommends +1 replica, and when every replica
sits below ``DMLC_FLEET_SCALE_IN_S`` it recommends −1, within
[``DMLC_FLEET_MIN_REPLICAS``, ``DMLC_FLEET_MAX_REPLICAS``].

The decision (:class:`AutoscalePolicy`) is a pure hysteresis machine —
no clocks, no I/O — surfaced two ways: the
``fleet_autoscale_recommendation`` gauge (+ events counter) for
external orchestrators (a k8s HPA adapter watches the gauge), and a
callback/backend hook for in-process action.
:class:`LocalProcessScaler` is the proof-of-loop backend: it actually
``spawn_replica``'s a new process on scale-out and drains + shuts down
the youngest replica on scale-in — the local-multiprocess analogue of
the paper's ``dmlc_tracker/local.py`` launcher, closed into a loop.
:class:`LauncherScaler` is the same loop over the launch subsystem: the
fleet is a supervised JobSet on any Transport (fake hosts in CI, SSH or
k8s in production), so crashed replicas respawn and retired ones stay
retired.

The PyTorch port's counterpart of
``dmlc_core_tpu/serve/fleet/autoscale.py``: the same policy, knobs and
metric names.  Both backends spawn the port's replica
(``python -m dmlc_core_tpu_torch.serve.fleet.replica``); its device comes
from ``FLEET_DEVICE`` in ``spawn_env`` (unset: ``cuda``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.racecheck import instrument_class
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.resilience import RetryPolicy
from dmlc_core_tpu_torch.io.http_util import http_request
from dmlc_core_tpu_torch.serve.fleet.instruments import fleet_metrics
from dmlc_core_tpu_torch.serve.fleet.replica import (REPLICA_COMMAND, FleetTracker,
                                               replica_env, spawn_replica)

__all__ = ["AutoscalePolicy", "LocalProcessScaler", "LauncherScaler",
           "AutoscaleLoop"]

_ONE_ATTEMPT = RetryPolicy(max_attempts=1)


def _env_f(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


class AutoscalePolicy:
    """Pure hysteresis over the fleet's worst queue-wait p99.

    :meth:`observe` returns −1 / 0 / +1.  A raw threshold crossing is
    not enough: it must persist for ``patience`` consecutive
    observations (opposite-direction or in-band samples reset the
    streak), so a single slow batch cannot trigger churn.  Bounds win
    over signal: at ``max_replicas`` the policy never says +1, at
    ``min_replicas`` never −1.
    """

    def __init__(self, high_s: Optional[float] = None,
                 low_s: Optional[float] = None,
                 patience: Optional[int] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None):
        self.high_s = (high_s if high_s is not None
                       else _env_f("DMLC_FLEET_SCALE_OUT_S", 0.05))
        self.low_s = (low_s if low_s is not None
                      else _env_f("DMLC_FLEET_SCALE_IN_S", 0.005))
        self.patience = (patience if patience is not None
                         else int(_env_f("DMLC_FLEET_PATIENCE", 3)))
        self.min_replicas = (min_replicas if min_replicas is not None
                             else int(_env_f("DMLC_FLEET_MIN_REPLICAS", 1)))
        self.max_replicas = (max_replicas if max_replicas is not None
                             else int(_env_f("DMLC_FLEET_MAX_REPLICAS", 8)))
        CHECK(self.low_s <= self.high_s,
              f"scale-in bound {self.low_s} above scale-out "
              f"bound {self.high_s}")
        CHECK(1 <= self.min_replicas <= self.max_replicas,
              f"bad replica bounds [{self.min_replicas}, "
              f"{self.max_replicas}]")
        self._streak = 0          # signed: +k high streak, -k low streak

    def observe(self, queue_wait_p99_s: Optional[float],
                n_replicas: int) -> int:
        """Feed one observation; returns the recommendation now
        (−1 scale-in, 0 hold, +1 scale-out)."""
        if queue_wait_p99_s is None:          # no traffic yet: hold
            self._streak = 0
            return 0
        if queue_wait_p99_s >= self.high_s:
            self._streak = max(1, self._streak + 1)
        elif queue_wait_p99_s <= self.low_s:
            self._streak = min(-1, self._streak - 1)
        else:
            self._streak = 0
        if self._streak >= self.patience and n_replicas < self.max_replicas:
            self._streak = 0                  # recommendation consumed
            return 1
        if -self._streak >= self.patience and n_replicas > self.min_replicas:
            self._streak = 0
            return -1
        return 0


class LocalProcessScaler:
    """Backend that executes recommendations with real local processes.

    Scale-out spawns ``python -m dmlc_core_tpu_torch.serve.fleet.replica``
    against the tracker (``spawn_replica``); scale-in drains the
    highest-rank registered replica (``POST /admin/shutdown`` — drain
    first, in-flight work finishes, clean tracker goodbye).  The k8s/
    SSH analogue would talk to its launcher instead; this backend is
    what lets the drill and bench prove the loop end to end.
    """

    def __init__(self, tracker: FleetTracker, model_uri: Optional[str],
                 name: str = "fleet",
                 spawn_env: Optional[Dict[str, str]] = None):
        self._tracker = tracker
        self._model_uri = model_uri
        self._name = name
        self._spawn_env = dict(spawn_env or {})
        self._procs: List[Any] = []

    def scale(self, direction: int) -> bool:
        """Execute one recommendation; True when an action was taken."""
        if direction > 0:
            return self.scale_out()
        if direction < 0:
            return self.scale_in()
        return False

    def scale_out(self) -> bool:
        proc = spawn_replica(self._tracker.host_ip, self._tracker.port,
                             model_uri=self._model_uri, name=self._name,
                             extra_env=self._spawn_env)
        self._procs.append(proc)
        LOG("INFO", "fleet.autoscale: spawned replica pid %d", proc.pid)
        if _metrics.enabled():
            fleet_metrics()["autoscale_events"].inc(1, direction="out")
        return True

    def scale_in(self) -> bool:
        endpoints = self._tracker.serve_endpoints()
        if not endpoints:
            return False
        rank = max(endpoints)       # youngest rank retires first
        try:
            http_request("POST", endpoints[rank] + "/admin/shutdown",
                         None, b"{}", ok=(200,), retry=_ONE_ATTEMPT,
                         op="fleet_autoscale")
        except Exception as e:  # noqa: BLE001 — already gone is fine
            LOG("WARNING", "fleet.autoscale: retire of rank %d failed: "
                "%s", rank, e)
            return False
        LOG("INFO", "fleet.autoscale: retired replica rank %d", rank)
        if _metrics.enabled():
            fleet_metrics()["autoscale_events"].inc(1, direction="in")
        return True

    def reap(self, timeout: float = 10.0) -> None:
        """Wait for spawned replica processes that have exited (call at
        teardown so the drill leaves no zombies)."""
        for proc in self._procs:
            try:
                proc.wait(timeout=timeout)
            except Exception:  # noqa: BLE001 — still running: kill it
                proc.kill()
                proc.wait(timeout=5.0)


class LauncherScaler:
    """Launcher-backed autoscale backend: replicas are ranks of a
    supervised :class:`~dmlc_core_tpu_torch.launch.JobSet`.

    Where :class:`LocalProcessScaler` forks bare local processes, this
    backend scales over any launch Transport — FakeTransport hosts in
    the CI drill, SSH slots or a k8s namespace in production — and gets
    the JobSet's supervision for free: a replica that *crashes* is
    respawned with backoff on a live host, while a replica retired by
    scale-in exits cleanly (drain → ``/admin/shutdown`` → code 0) and
    is NOT brought back.  Scale-out is :meth:`JobSet.add_rank`.
    """

    def __init__(self, tracker: FleetTracker, model_uri: Optional[str],
                 name: str = "fleet", transport: Optional[Any] = None,
                 initial: int = 0,
                 spawn_env: Optional[Dict[str, str]] = None,
                 restart_limit: Optional[int] = None):
        from dmlc_core_tpu_torch.launch import JobSet

        self._tracker = tracker
        self.jobset = JobSet(
            REPLICA_COMMAND, initial, transport=transport,
            envs=replica_env(tracker.host_ip, tracker.port,
                             model_uri=model_uri, name=name,
                             extra_env=spawn_env),
            name=f"{name}-scaler", role="replica",
            restart_limit=restart_limit)
        self.jobset.launch()

    def scale(self, direction: int) -> bool:
        """Execute one recommendation; True when an action was taken."""
        if direction > 0:
            return self.scale_out()
        if direction < 0:
            return self.scale_in()
        return False

    def scale_out(self) -> bool:
        rank = self.jobset.add_rank()
        LOG("INFO", "fleet.autoscale: launched replica as jobset rank %d "
            "on %s", rank, self.jobset.rank_host(rank))
        if _metrics.enabled():
            fleet_metrics()["autoscale_events"].inc(1, direction="out")
        return True

    def scale_in(self) -> bool:
        endpoints = self._tracker.serve_endpoints()
        if not endpoints:
            return False
        rank = max(endpoints)       # youngest rank retires first
        try:
            http_request("POST", endpoints[rank] + "/admin/shutdown",
                         None, b"{}", ok=(200,), retry=_ONE_ATTEMPT,
                         op="fleet_autoscale")
        except Exception as e:  # noqa: BLE001 — already gone is fine
            LOG("WARNING", "fleet.autoscale: retire of rank %d failed: "
                "%s", rank, e)
            return False
        LOG("INFO", "fleet.autoscale: retired replica rank %d", rank)
        if _metrics.enabled():
            fleet_metrics()["autoscale_events"].inc(1, direction="in")
        return True

    def reap(self, timeout: float = 10.0) -> None:
        """Graceful teardown of every launcher-owned replica."""
        self.jobset.shutdown(graceful_s=timeout)


def fleet_queue_wait_p99(tracker: FleetTracker) -> Optional[float]:
    """The policy's default signal: the WORST replica's heartbeat-borne
    queue-wait p99 (None while no replica has served traffic)."""
    values = [load.get("queue_wait_p99_s")
              for load in tracker.serve_loads().values()]
    values = [v for v in values if v is not None]
    return max(values) if values else None


@instrument_class
class AutoscaleLoop:
    """Wire signal → policy → metrics/callback/backend on a timer.

    ``on_decision(direction, signal_s, n_replicas)`` fires for every
    nonzero recommendation BEFORE the backend acts — the hook an
    external orchestrator registers instead of (or in addition to) a
    backend.  With no backend the loop is recommendation-only.
    """

    def __init__(self, tracker: FleetTracker,
                 policy: Optional[AutoscalePolicy] = None,
                 backend: Optional[Any] = None,
                 on_decision: Optional[
                     Callable[[int, Optional[float], int], None]] = None,
                 interval_s: float = 0.5):
        self._tracker = tracker
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.backend = backend
        self.on_decision = on_decision
        self.interval_s = interval_s
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fleet-autoscale")

    def start(self) -> "AutoscaleLoop":
        self._thread.start()
        return self

    def close(self) -> None:
        self._done.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def step(self) -> int:
        """One observe/decide/act cycle (public for tests/drills)."""
        signal_s = fleet_queue_wait_p99(self._tracker)
        n = len(self._tracker.serve_endpoints())
        decision = self.policy.observe(signal_s, n)
        if _metrics.enabled():
            fleet_metrics()["autoscale_rec"].set(decision)
        if decision != 0:
            LOG("INFO", "fleet.autoscale: recommendation %+d "
                "(queue-wait p99 %s, %d replicas)", decision,
                f"{signal_s:.4f}s" if signal_s is not None else "n/a", n)
            if self.on_decision is not None:
                self.on_decision(decision, signal_s, n)
            if self.backend is not None:
                self.backend.scale(decision)
        return decision

    def _loop(self) -> None:
        while not self._done.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — loop must not die
                LOG("WARNING", "fleet.autoscale: step failed: %s", e)

