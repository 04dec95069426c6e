"""The port's coordination service (``tracker/tracker.py``:
``RabitTracker``, ``WorkerSession``, ``PSTracker``, ``submit``) on the
CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_parallel.py``'s ``TestRabitTracker`` and
``TestTopologyOracle`` (the port's ``parallel.collectives`` topology,
which the tracker hands its workers).  The rest of that file is the JAX
package's mesh, device collectives, KVStore and multi-process launch,
whose port counterparts have their own files; its imports of them are
dropped (no assertion changes).  ``tests/test_resilience.py``'s
``TestTrackerGrace`` is loaded by ``test_torch_serve.py`` with the rest
of that file.

The port's own checks: a JAX ``WorkerSession`` handshakes with a port
tracker and the reverse (one wire protocol); ``PSTracker`` serves the
JAX package's env ABI and its ``start`` hosts the port's PS scheduler;
``submit`` exports the JAX package's env.
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.tracker import tracker as jax_tracker  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.tracker import tracker as port_tracker  # noqa: E402
from _torch_suites import export, load_port  # noqa: E402

_START = "from dmlc_core_tpu.io import TemporaryDirectory\n"
_END = "from jax.sharding import NamedSharding, PartitionSpec as P\n"
_src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_parallel.py")).read()
_PAR = load_port("test_parallel.py", [
    (_src[_src.index(_START):_src.index(_END) + len(_END)],
     "from dmlc_core_tpu.parallel.collectives import (\n"
     "    find_share_ring, get_link_map, get_tree)\n")])
export(globals(), _PAR, ["TestRabitTracker", "TestTopologyOracle"])


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("server,client", [
    (port_tracker, jax_tracker), (jax_tracker, port_tracker)])
def test_one_wire_protocol(server, client):
    """Workers of one package against the other's tracker: ranks,
    topology, liveness, the death of an unclean session, a clean
    shutdown."""
    tr = server.RabitTracker(nworker=3)
    tr.start()
    try:
        sessions = [client.WorkerSession("127.0.0.1", tr.port, host=f"h{i}")
                    for i in range(3)]
        infos = sorted((s.info for s in sessions), key=lambda i: i["rank"])
        assert [i["rank"] for i in infos] == [0, 1, 2]
        links = port_tracker.RabitTracker(nworker=3)._links
        for info in infos:
            link = links[info["rank"]]
            assert (info["parent"], info["children"], info["ring_prev"],
                    info["ring_next"]) == (link["parent"], link["children"],
                                           link["ring_prev"],
                                           link["ring_next"])
        assert _wait(lambda: tr.alive_ranks() == [0, 1, 2])
        dead = sessions[1].info["rank"]
        sessions[1].close()
        assert _wait(lambda: tr.dead_workers == [dead])
        assert client.RabitTracker.worker_connect(
            "127.0.0.1", tr.port, cmd="recover", rank=dead)["rank"] == dead
        for s in (sessions[0], sessions[2]):
            s.shutdown()
        assert _wait(lambda: tr.alive_ranks() == [])
    finally:
        tr.stop()


def test_ps_tracker_env_and_refusal():
    """``PSTracker`` serves the JAX package's env ABI; ``start`` and
    ``submit(nserver>0, start_tracker=True)`` host the port's PS
    scheduler on a free port, which a JAX server registers with."""
    kw = dict(host_ip="10.0.0.2", port=9092, nworker=3, nserver=2)
    port, jax = port_tracker.PSTracker(**kw), jax_tracker.PSTracker(**kw)
    for env in ("slave_envs", "worker_envs", "server_envs",
                "scheduler_envs"):
        assert getattr(port, env)() == getattr(jax, env)()
    from dmlc_core_tpu.parallel.ps import PSServer as JaxPSServer
    from dmlc_core_tpu_torch.parallel.ps import PSScheduler

    tr = port_tracker.PSTracker(host_ip="127.0.0.1", port=0, nworker=1,
                                nserver=1)
    tr.start()
    try:
        assert isinstance(tr._scheduler, PSScheduler) and tr.port > 0
        srv = JaxPSServer("127.0.0.1", tr.port)
        assert srv.server_id == 0 and srv.nserver == 1
        srv.stop()
    finally:
        tr.stop()
    env = {}
    tr = port_tracker.submit(2, 1, lambda n, e: env.update(e, n=n),
                             start_tracker=True)
    try:
        assert isinstance(tr, port_tracker.PSTracker)
        assert env["DMLC_PS_ROOT_PORT"] == str(tr.port) and env["n"] == 3
    finally:
        tr.stop()


def test_submit_exports_jax_env():
    got = {}
    tr = port_tracker.submit(3, 0, lambda n, e: got.update(n=n, env=e))
    assert tr is None and got["n"] == 3
    env = got["env"]
    assert set(env) == {"DMLC_NUM_WORKER", "DMLC_NUM_SERVER",
                        "DMLC_TRACKER_URI", "DMLC_TRACKER_PORT"}
    assert (env["DMLC_NUM_WORKER"], env["DMLC_NUM_SERVER"]) == ("3", "0")
    env = {}
    tr = port_tracker.submit(2, 0, lambda n, e: env.update(e),
                             start_tracker=True)
    try:
        assert env["DMLC_LEGACY_TRACKER_PORT"] == str(tr.port)
    finally:
        tr.stop()
