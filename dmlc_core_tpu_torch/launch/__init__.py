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
* :mod:`jobset` — :class:`JobSet`: the supervisor.  DMLC env ABI
  injection, liveness poll + tracker-heartbeat cross-check,
  restart-with-backoff under ``DMLC_LAUNCH_RESTART_LIMIT``, targeted
  kill, graceful teardown, ``dmlc_launch_*`` metrics + lifecycle
  events.

The PyTorch port's copy: ``transport``, ``jobset`` and ``instruments``.
The JAX package's ``k8s`` (:class:`K8sTransport`) and ``config``
(dmlc-submit options → JobSet) import its launcher backends
(``tracker/kubernetes.py``, ``tracker/ssh.py``), which are not ported
yet: both wait for ROADMAP item 18, so this package exports only
what exists.  Spawn sites routed through here: ``serve/fleet`` replica
spawning and the ``LauncherScaler`` autoscale backend.
"""

from dmlc_core_tpu_torch.launch.instruments import launch_metrics  # noqa: F401
from dmlc_core_tpu_torch.launch.jobset import JobSet, LaunchTimeout  # noqa: F401
from dmlc_core_tpu_torch.launch.transport import (FakeTransport,  # noqa: F401
                                                  LocalTransport,
                                                  SSHTransport, Transport,
                                                  TransportError,
                                                  WorkerHandle)

__all__ = [
    "Transport", "TransportError", "WorkerHandle",
    "LocalTransport", "SSHTransport", "FakeTransport",
    "JobSet", "LaunchTimeout", "launch_metrics",
]
