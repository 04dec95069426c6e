"""The serving fleet of the port (``serve/fleet/*``: tracker-supervised
replicas, the consistent-hash router, staged rollouts, autoscale, the
load generator; the port bench's ``--fleet``) on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_fleet.py``'s ``TestHashRing``, ``TestRolloutPure``,
``TestAutoscalePolicy``, ``TestLoadgenPure``, ``TestFleetRouter`` and
``TestFleetSoak`` (``slow``, as in its own file).  ``TestFleetSoak``'s
replica subprocesses get ``FLEET_DEVICE=cpu`` in place of the JAX
package's ``JAX_PLATFORMS=cpu`` (the port's device setting; no
assertion changes).

Left out: ``TestFrontendDrain``.  It is a timing test — a 0.1 s sleep
stands in for "the three requests are in flight" — and the JAX original
fails on a loaded host when that sleep is not enough.
:func:`test_frontend_drain_deterministic` holds the same contract
against the port without a sleep: the model's ``predict``
blocks on an event, and ``/drain`` is sent only once the frontend
reports three requests in flight.

The port's own checks: a JAX ``HashRing`` and the port's place every key
on the same replica, also after a membership change; a JAX-fit model's
serving checkpoint served by port ``Replica(device="cpu")``s behind a
port ``FleetRouter`` answers what JAX's ``predict`` answers (rtol 1e-5,
atol 1e-6, the tolerance ``test_torch_serve.py`` holds a registry to);
``replica_env`` returns the JAX package's env; a replica subprocess
without ``FLEET_DEVICE`` on a host with no GPU exits non-zero and never
registers; the HTTP round trip builds its opener once; the port bench's
``--fleet`` record.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu.serve import checkpoint_model as jax_checkpoint_model  # noqa: E402
from dmlc_core_tpu.serve.fleet import replica as jax_replica  # noqa: E402
from dmlc_core_tpu.serve.fleet.router import HashRing as JaxHashRing  # noqa: E402
from dmlc_core_tpu_torch.base.resilience import RetryPolicy  # noqa: E402
from dmlc_core_tpu_torch.serve import (ModelRegistry,  # noqa: E402
                                       ResilientClient, ServeFrontend)
from dmlc_core_tpu_torch.serve.fleet import (FleetRouter,  # noqa: E402
                                             FleetTracker, HashRing, Replica)
from dmlc_core_tpu_torch.serve.fleet import replica as port_replica  # noqa: E402
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

_FLEET = load_port("test_fleet.py", [
    ('env = {"JAX_PLATFORMS": "cpu", "DMLC_TPU_FORCE_CPU": "1"}',
     'env = {"FLEET_DEVICE": "cpu"}')])
export(globals(), _FLEET, ["TestHashRing", "TestRolloutPure",
                           "TestAutoscalePolicy", "TestLoadgenPure",
                           "TestFleetRouter", "TestFleetSoak"])


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def _data(n=400, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# the same routing in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodes,vnodes", [([0, 1, 2], 64),
                                          ([0, 1, 2, 3, 4], 64),
                                          (["a", "b", "c"], 16)])
def test_hash_ring_places_keys_as_jax(nodes, vnodes):
    """Every key on the same replica in both packages, and the same
    failover order; after a node leaves, again the same map."""
    keys = [f"req-{i}".encode() for i in range(2000)]
    keys += [b"t03\x00" + json.dumps({"rows": [[float(i)] * 6]}).encode()
             for i in range(200)]
    for members in (nodes, nodes[:-1], nodes[1:]):
        jr, tr = JaxHashRing(members, vnodes=vnodes), \
            HashRing(members, vnodes=vnodes)
        assert [tr.lookup(k) for k in keys] == [jr.lookup(k) for k in keys]
        assert [tr.sequence(k) for k in keys[:300]] == \
            [jr.sequence(k) for k in keys[:300]]


def test_replica_env_is_jax_env():
    """``replica_env`` with the JAX package's arguments returns its
    dict, apart from the ``PYTHONPATH`` root (each package's own)."""
    kw = dict(model_uri="file:///m.ckpt", name="f", max_batch=32,
              max_queue=64, tenancy=True, extra_env={"X": "1"})
    want = jax_replica.replica_env("10.0.0.1", 9100, **kw)
    got = port_replica.replica_env("10.0.0.1", 9100, **kw)
    assert got.pop("PYTHONPATH").split(os.pathsep)[0] == ROOT
    want.pop("PYTHONPATH")
    assert got == want
    assert port_replica.REPLICA_COMMAND[1:] == [
        "-m", "dmlc_core_tpu_torch.serve.fleet.replica"]


# ---------------------------------------------------------------------------
# a JAX-fit model behind the port's fleet
# ---------------------------------------------------------------------------

def test_routed_predict_of_jax_model_matches_jax(tmp_path):
    """Two port replicas on the CPU load a serving checkpoint JAX wrote
    for a model JAX fit; predicts through the port router answer JAX's
    ``predict`` within rtol 1e-5, atol 1e-6 — also after one replica
    drops out uncleanly."""
    X, y = _data()
    jm = JaxHistGBT(n_trees=4, max_depth=3, n_bins=16,
                    mesh=local_mesh(1)).fit(X, y)
    uri = f"file://{tmp_path}/jax.ckpt"
    jax_checkpoint_model(uri, jm, version=3)
    want = np.asarray(jm.predict(X))
    tracker = FleetTracker(nworker=4)
    tracker.start()
    replicas = [Replica("127.0.0.1", tracker.port, model_uri=uri,
                        max_batch=32, heartbeat_s=0.1, device="cpu")
                for _ in range(2)]
    router = FleetRouter(tracker, probe_s=0.1).start()
    try:
        assert all(r.registry.current()[1].model.device.type == "cpu"
                   for r in replicas)
        client = ResilientClient(router.url, policy=RetryPolicy(
            max_attempts=6, base_backoff_s=0.01))
        for lo, k in ((0, 1), (9, 7), (120, 32), (391, 9)):
            got, version = client.predict(X[lo:lo + k])
            assert version == 3
            np.testing.assert_allclose(got, want[lo:lo + k], rtol=1e-5,
                                       atol=1e-6)
        replicas[1].close(clean=False)
        router.probe_now()
        for lo, k in ((3, 5), (200, 17)):
            got, _ = client.predict(X[lo:lo + k])
            np.testing.assert_allclose(got, want[lo:lo + k], rtol=1e-5,
                                       atol=1e-6)
    finally:
        router.close()
        for r in replicas:
            try:
                r.close()
            except Exception:
                pass
        tracker.stop()


def test_replica_without_gpu_exits_and_never_registers():
    """A replica subprocess with ``FLEET_DEVICE`` unset asks for
    ``cuda``; on a host without a GPU it raises before registering and
    its process exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the replica would serve on it")
    tracker = FleetTracker(nworker=2)
    tracker.start()
    env = {k: v for k, v in os.environ.items() if k != "FLEET_DEVICE"}
    env.update(port_replica.replica_env("127.0.0.1", tracker.port))
    env.pop("FLEET_DEVICE", None)
    try:
        res = subprocess.run(port_replica.REPLICA_COMMAND, env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert "no CUDA GPU" in res.stderr
        assert tracker.serve_endpoints() == {}
    finally:
        tracker.stop()


def test_round_trip_builds_its_opener_once(monkeypatch):
    """``http_request`` reuses one redirect-following opener: building
    one per request (the JAX module's way) loads the CA store each time,
    the floor of every routed predict."""
    from dmlc_core_tpu_torch.io import http_util

    built = []
    real = urllib.request.build_opener

    def counting(*handlers):
        built.append(handlers)
        return real(*handlers)

    monkeypatch.setattr(urllib.request, "build_opener", counting)
    monkeypatch.setattr(http_util, "_follow_opener", None)
    reg = ModelRegistry(name="opener", device="cpu", max_batch=8)
    with ServeFrontend(reg, max_batch=8) as fe:
        for _ in range(3):
            status, _, body = http_util.http_request("GET",
                                                     fe.url + "/healthz")
            assert status == 200 and json.loads(body)["status"]
    assert len(built) == 1


# ---------------------------------------------------------------------------
# drain, deterministically
# ---------------------------------------------------------------------------

def _post(url, body=b"", headers=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        hdrs = {k.lower(): v for k, v in e.headers.items()}
        return e.code, json.loads(e.read() or b"{}"), hdrs


def test_frontend_drain_deterministic():
    """``TestFrontendDrain``'s contract without its sleep: the model
    blocks on an event, ``/drain`` is sent once the frontend reports
    three requests in flight; new predicts get 503 with
    ``Retry-After``, ``/healthz`` says draining, the three complete with
    200 once released, and after ``close()`` the socket is gone."""
    F = 6
    release = threading.Event()

    class _Blocked:
        def predict(self, Z):
            assert release.wait(30)
            return Z[:, 0]

    reg = ModelRegistry(name="drain-det", device="cpu", max_batch=4,
                        min_bucket=1)
    reg.publish(_Blocked())
    fe = ServeFrontend(reg, max_batch=4, max_delay=0.0, max_queue=64,
                       request_timeout=30.0)
    fe.start()
    results = []
    json_hdr = {"Content-Type": "application/json"}

    def hit(i):
        body = json.dumps({"rows": [[float(i)] * F]}).encode()
        results.append(_post(fe.url + "/predict", body, json_hdr)[:2])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while fe.inflight() < 3:
            assert time.monotonic() < deadline, "requests never in flight"
            time.sleep(0.005)
        st, body, _ = _post(fe.url + "/drain")
        assert st == 200 and body["status"] == "draining"
        st, body, hdrs = _post(fe.url + "/predict", json.dumps(
            {"rows": [[1.0] * F]}).encode(), json_hdr)
        assert st == 503 and "retry-after" in {k.lower() for k in hdrs}
        with urllib.request.urlopen(fe.url + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "draining"
        assert fe.inflight() == 3 and not results
    finally:
        release.set()
        for t in threads:
            t.join(timeout=30)
    fe.close()
    assert sorted(st for st, _ in results) == [200, 200, 200]
    assert sorted(b["predictions"][0] for _, b in results) == [0.0, 1.0, 2.0]
    with pytest.raises(Exception):
        urllib.request.urlopen(fe.url + "/healthz", timeout=2)


# ---------------------------------------------------------------------------
# the port bench's --fleet
# ---------------------------------------------------------------------------

def test_bench_fleet_record():
    env = dict(os.environ, BENCH_FORCE_CPU="1", FLEET_SECONDS="3",
               FLEET_QPS="40", FLEET_TRAIN_ROWS="3000", FLEET_REPLICAS="2",
               FLEET_PROCS="1", FLEET_THREADS="2", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                          "--fleet"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    assert [r["phase"] for r in lines] == ["train", "spawn", "load", "done"]
    rec = lines[-1]
    assert rec["metric"] == "fleet_requests_per_sec"
    assert rec["provisional"] is False and rec["platform"] == "cpu"
    assert rec["ok"] > 0 and rec["dropped"] == 0 and rec["wrong"] == 0
    assert rec["rollout"]["outcome"] == "activated"
    assert rec["rollout"]["version"] == 2
    assert rec["launch"]["backend"] == "local"
    assert rec["launch"]["respawns"] == 0
    assert set(rec["by_version"]) <= {"1", "2"}
    # where the fleet ended: every replica on v2, every routed answer v2's
    assert sorted(rec["replica_versions"].values()) == [2, 2]
    assert rec["post_rollout"] == {"requests": 20, "wrong": 0,
                                   "by_version": {"2": 20}}
    assert rec["failover"].get("transport", 0) == 0
    for k in ("requests", "by_version", "latency_p50_ms", "latency_p99_ms",
              "per_replica_routed", "replicas", "qps", "duration_s"):
        assert k in rec, k
