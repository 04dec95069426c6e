"""Fleet serving: tracker-supervised replica fleets with routing,
staged rollouts, and autoscale hooks.

The single-process serve stack (``dmlc_core_tpu_torch.serve``) scaled one
batcher; this package scales *replicas*, reusing the repo's existing
control plane the way the paper's layering implies — ``dmlc_tracker``
launched and supervised N training workers, here the same machinery
supervises N inference replicas:

* :mod:`replica` — :class:`FleetTracker` (RabitTracker + endpoint/load
  registry over ``serve_register``/``serve_report`` cmds),
  :class:`Replica` (frontend + batcher + runner + heartbeat + admin
  RPCs), and the ``FLEET_*`` env subprocess entry.
* :mod:`router` — :class:`HashRing` (pure consistent hashing) and
  :class:`FleetRouter`: health-probed membership, per-replica circuit
  breakers, retry-on-another-replica failover, fleet-wide admission
  control (503 + Retry-After).
* :mod:`rollout` — staged zero-downtime deploys: stage everywhere,
  activate in waves, auto-rollback on health/eval-gate regression.
* :mod:`autoscale` — queue-wait-p99-driven scale recommendations
  (pure :class:`AutoscalePolicy`) plus a local-process backend that
  actually spawns/retires replicas.
* :mod:`loadgen` — closed-loop multi-process load generator
  (heavy-tail sizes, diurnal ramp) behind ``bench.py --fleet``.

Topology, failure model and knobs: ``doc/serving.md`` (Fleet section).

The PyTorch port's copy of ``dmlc_core_tpu/serve/fleet``: the same
names, commands, routes, env ABI and metric names.  A replica's models
live on its ``device`` (``Replica(device=)``; a subprocess replica's
``FLEET_DEVICE``; ``cuda`` unless asked for the CPU).
"""

from dmlc_core_tpu_torch.serve.fleet.autoscale import (AutoscaleLoop,  # noqa: F401
                                                 AutoscalePolicy,
                                                 LauncherScaler,
                                                 LocalProcessScaler)
from dmlc_core_tpu_torch.serve.fleet.instruments import fleet_metrics  # noqa: F401
from dmlc_core_tpu_torch.serve.fleet.loadgen import (diurnal_qps,  # noqa: F401
                                               run_loadgen, sample_size)
from dmlc_core_tpu_torch.serve.fleet.replica import (FleetTracker,  # noqa: F401
                                               Replica, ReplicaFrontend,
                                               spawn_replica)
from dmlc_core_tpu_torch.serve.fleet.rollout import (FleetAdmin,  # noqa: F401
                                               HttpFleetAdmin, Rollout,
                                               RolloutController, plan_waves)
from dmlc_core_tpu_torch.serve.fleet.router import FleetRouter, HashRing  # noqa: F401

__all__ = [
    "FleetTracker", "Replica", "ReplicaFrontend", "spawn_replica",
    "FleetRouter", "HashRing",
    "Rollout", "RolloutController", "FleetAdmin", "HttpFleetAdmin",
    "plan_waves",
    "AutoscalePolicy", "AutoscaleLoop", "LocalProcessScaler",
    "LauncherScaler",
    "run_loadgen", "sample_size", "diurnal_qps", "fleet_metrics",
]
