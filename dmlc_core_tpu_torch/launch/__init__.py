"""Multi-host launch: supervised ranked worker sets over pluggable
transports.

The paper's ``dmlc_tracker`` is not just a rank-assignment socket — it
is the layer that *launches and supervises* a ranked job set on
whatever substrate the operator has (a dev box, an SSH host file, a
Kubernetes cluster).  This package is that layer:

* :mod:`transport` — :class:`Transport` (spawn/poll/signal/kill one
  process on a host, stream its env + log tail) with
  :class:`LocalTransport` (pdeathsig'd subprocesses),
  :class:`SSHTransport` (host-file slots, ``ssh -tt``) and
  :class:`FakeTransport` (a deterministic in-process cluster whose host
  failures are scripted through the ``base/faultinject`` grammar — the
  CI story).
* :mod:`k8s` — :class:`K8sTransport`: one indexed-Job manifest per
  worker, dry-run by default, ``kubectl`` exec optional.
* :mod:`jobset` — :class:`JobSet`: the supervisor.  DMLC env ABI
  injection, liveness poll + tracker-heartbeat cross-check,
  restart-with-backoff under ``DMLC_LAUNCH_RESTART_LIMIT``, targeted
  kill, graceful teardown, ``dmlc_launch_*`` metrics + lifecycle
  events.
* :mod:`config` — dmlc-submit options → JobSet configurations (the
  ``tracker/submit.py`` local/ssh/kubernetes backends).

The PyTorch port's copy of the JAX package's ``launch``.  Spawn sites
routed through here: ``tracker/local.py`` + ``tracker/ssh.py`` (thin
shims), ``serve/fleet`` replica spawning and the ``LauncherScaler``
autoscale backend.
"""

from dmlc_core_tpu_torch.launch.config import (jobset_from_opts,  # noqa: F401
                                               transport_from_opts)
from dmlc_core_tpu_torch.launch.instruments import launch_metrics  # noqa: F401
from dmlc_core_tpu_torch.launch.jobset import JobSet, LaunchTimeout  # noqa: F401
from dmlc_core_tpu_torch.launch.k8s import K8sTransport  # noqa: F401
from dmlc_core_tpu_torch.launch.transport import (FakeTransport,  # noqa: F401
                                                  LocalTransport,
                                                  SSHTransport, Transport,
                                                  TransportError,
                                                  WorkerHandle)

__all__ = [
    "Transport", "TransportError", "WorkerHandle",
    "LocalTransport", "SSHTransport", "FakeTransport", "K8sTransport",
    "JobSet", "LaunchTimeout",
    "jobset_from_opts", "transport_from_opts", "launch_metrics",
]
