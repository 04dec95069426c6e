"""The launch tier of the port (``launch/*``: transports, the JobSet
supervisor, the Kubernetes transport and dmlc-submit options → JobSet)
on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_launch.py``'s ``TestLocalTransport``, ``TestSSHTransport``,
``TestFakeTransport``, ``TestK8sTransport``, ``TestJobSet``,
``TestSubmitConfigs`` and ``TestSlotAwarePlacement`` — the whole file.

The port's own check: its ``launch`` package exports the JAX package's
names, and a JobSet's worker env is the JAX package's for the same
arguments.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dmlc_core_tpu.launch as jax_launch  # noqa: E402
import dmlc_core_tpu_torch.launch as port_launch  # noqa: E402
from _torch_suites import export, load_port  # noqa: E402

_LAUNCH = load_port("test_launch.py")
export(globals(), _LAUNCH, ["TestLocalTransport", "TestSSHTransport",
                            "TestFakeTransport", "TestK8sTransport",
                            "TestJobSet", "TestSubmitConfigs",
                            "TestSlotAwarePlacement"])


def test_exports_are_jax_less_item_18():
    # item 18's launch names (K8sTransport, jobset_from_opts,
    # transport_from_opts) are ported: nothing is left out any more
    assert set(port_launch.__all__) == set(jax_launch.__all__)
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
