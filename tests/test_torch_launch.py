"""The launch tier of the port (``launch/*``: transports and the JobSet
supervisor) on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_launch.py``'s ``TestLocalTransport``, ``TestSSHTransport``,
``TestFakeTransport``, ``TestJobSet`` and ``TestSlotAwarePlacement``.
Left out, for what the port does not have yet (ROADMAP item 18):

* ``TestK8sTransport``: the Kubernetes transport (``launch/k8s.py``)
  imports the launcher backend ``tracker/kubernetes.py``;
* ``TestSubmitConfigs``: dmlc-submit options → JobSet
  (``launch/config.py``, ``tracker/opts.py``) import the launcher
  backends ``tracker/ssh.py`` and ``tracker/kubernetes.py``.

The loaded file's imports of those modules are dropped; no assertion
changes.  The port's own check: its ``launch`` package exports the JAX
package's names less those two modules', and a JobSet's worker env is
the JAX package's for the same arguments.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dmlc_core_tpu.launch as jax_launch  # noqa: E402
import dmlc_core_tpu_torch.launch as port_launch  # noqa: E402
from _torch_suites import export, load_port  # noqa: E402

_LAUNCH = load_port("test_launch.py", [
    ("from dmlc_core_tpu.launch import (FakeTransport, JobSet, K8sTransport,\n"
     "                                  LaunchTimeout, LocalTransport,\n"
     "                                  SSHTransport, TransportError,\n"
     "                                  jobset_from_opts, transport_from_opts)\n",
     "from dmlc_core_tpu.launch import (FakeTransport, JobSet,\n"
     "                                  LaunchTimeout, LocalTransport,\n"
     "                                  SSHTransport, TransportError)\n"),
    ("from dmlc_core_tpu.tracker.opts import get_opts\n", "")])
export(globals(), _LAUNCH, ["TestLocalTransport", "TestSSHTransport",
                            "TestFakeTransport", "TestJobSet",
                            "TestSlotAwarePlacement"])

#: the JAX package's launch names that wait for ROADMAP item 18
_ITEM_18 = {"K8sTransport", "jobset_from_opts", "transport_from_opts"}


def test_exports_are_jax_less_item_18():
    assert set(port_launch.__all__) == set(jax_launch.__all__) - _ITEM_18
    for name in port_launch.__all__:
        assert getattr(port_launch, name).__module__.startswith(
            "dmlc_core_tpu_torch.launch")


def test_worker_env_is_jax_env(monkeypatch):
    monkeypatch.delenv("DMLC_METRICS_SPOOL", raising=False)
    kw = dict(envs={"DMLC_TRACKER_URI": "10.0.0.1", "DMLC_NUM_WORKER": "3"},
              name="js", role="replica", monitor_s=0,
              env_for=lambda r, a: {"FLEET_RANK": str(r)})
    jj = jax_launch.JobSet(["x"], 3, **kw)
    pj = port_launch.JobSet(["x"], 3, **kw)
    for rank, attempt in ((0, 0), (2, 1)):
        assert pj.worker_env(rank, attempt) == jj.worker_env(rank, attempt)
    assert (pj._restart_limit, pj._graceful_s, pj._wedge_cycles) == \
        (jj._restart_limit, jj._graceful_s, jj._wedge_cycles)
