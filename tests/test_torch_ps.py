"""The port's parameter server (``parallel/ps``), its ``DistAsyncKVStore``
(``parallel/kvstore.py``), ``PSTracker.start`` and ``fit_ps`` of
``GBLinear`` and ``FM`` on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_ps.py`` — partition math, wire framing, the dist_sync init
broadcast, the in-process scheduler/server/client triad behind the
dist_async store, ``GBLinear.fit_ps`` learning a sparse CTR problem, and
the CSR minibatches.  Left out: ``TestDistSyncSatellites``'s
``test_fused_pull_bit_identical_to_eager`` and
``test_fused_pull_does_not_donate_caller_arrays``, which push JAX's
in-mesh form (a leading worker dim sharded over one process's devices,
JAX's donated jitted reducer), which has no counterpart in the port (one
process per card; ``test_torch_kvstore.py`` holds the bucketed pull on
gloo ranks instead).

The port's own checks: a JAX ``PSClient`` against port servers and a port
client against JAX servers (one wire format); server snapshots written by
either package restore in the other; ``GBLinear.fit_ps`` and
``FM.fit_ps`` on one worker and one server write the JAX package's
weights bit for bit, and the finalized models predict on their device as
numpy does on the same weights; ``PSTracker.start`` hosts the port's
scheduler; ``flush`` raises on a connection that died with pushes in
flight and the next request re-dials, and the ``--prodsim`` drill's
worker loop runs such a pass again (ROADMAP C17).
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dmlc_core_tpu.parallel.ps as jax_ps  # noqa: E402
import dmlc_core_tpu_torch.parallel.ps as port_ps  # noqa: E402
from dmlc_core_tpu.data.row_block import RowBlock as JaxRowBlock  # noqa: E402
from dmlc_core_tpu.models import FM as JaxFM  # noqa: E402
from dmlc_core_tpu.models import GBLinear as JaxGBLinear  # noqa: E402
from dmlc_core_tpu.parallel.kvstore import \
    DistAsyncKVStore as JaxDistAsync  # noqa: E402
from dmlc_core_tpu_torch.data.row_block import RowBlock  # noqa: E402
from dmlc_core_tpu_torch.models import FM, GBLinear  # noqa: E402
from dmlc_core_tpu_torch.parallel.kvstore import (DistAsyncKVStore,  # noqa: E402
                                                  KVStore)
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

_PS = load_port("test_ps.py")
export(globals(), _PS, ["TestPartition", "TestWire", "TestDistSyncSatellites",
                        "TestPSTriad", "TestCsrMinibatches"], left_out={
    "TestDistSyncSatellites": ("test_fused_pull_bit_identical_to_eager",
                               "test_fused_pull_does_not_donate_caller_"
                               "arrays")})


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


class _Fleet:
    """A scheduler and ``nserver`` server threads of one package."""

    def __init__(self, ps, nworker=1, nserver=2, snapshot_dir=""):
        self.sched = ps.PSScheduler("127.0.0.1", nworker=nworker,
                                    nserver=nserver)
        self.sched.start()
        self.servers = [
            ps.PSServer("127.0.0.1", self.sched.port, server_id=i,
                        snapshot_dir=snapshot_dir,
                        snapshot_stride=1 if snapshot_dir else 0)
            for i in range(nserver)]
        for s in self.servers:
            s.start()
        self.threads = [threading.Thread(target=s.serve_forever,
                                         daemon=True)
                        for s in self.servers]
        for t in self.threads:
            t.start()

    def join(self):
        for t in self.threads:
            t.join(timeout=30)
        self.sched.join(timeout=30)


PACKAGES = {"jax": jax_ps, "port": port_ps}


@pytest.mark.parametrize("server,client", [("port", "jax"),
                                           ("jax", "port")])
def test_one_wire_format(server, client):
    fleet = _Fleet(PACKAGES[server], nserver=3)
    c = PACKAGES[client].PSClient(root_uri="127.0.0.1",
                                  root_port=fleet.sched.port, rank=0,
                                  staleness=4)
    c.init("w", n_keys=100, lr=0.5)
    c.init("v", n_keys=20, width=(3,), init_scale=0.01, seed=9)
    ids = np.array([0, 50, 99, 50, 7], np.int64)
    c.push("w", ids, np.arange(5, dtype=np.float32), wait=True)
    c.tick()
    want = np.zeros(100, np.float32)
    np.add.at(want, ids, -0.5 * np.arange(5, dtype=np.float32))
    np.testing.assert_array_equal(c.pull("w", np.arange(100)), want)
    np.testing.assert_array_equal(c.pull_dense("w"), want)
    v = c.pull_dense("v")
    assert v.shape == (20, 3) and v.std() > 0
    c.close()
    fleet.join()
    # the other package's fleet draws the same server-side init
    fleet = _Fleet(PACKAGES[client], nserver=3)
    c = PACKAGES[server].PSClient(root_uri="127.0.0.1",
                                  root_port=fleet.sched.port, rank=0)
    c.init("v", n_keys=20, width=(3,), init_scale=0.01, seed=9)
    assert c.pull_dense("v").tobytes() == v.tobytes()
    c.close()
    fleet.join()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flush_raises_on_a_dead_connection_then_redials(pkg):
    """``flush`` raises ``ConnectionError`` on a connection that died with
    pushes in flight, in both packages; the next request re-resolves the
    server and goes through."""
    fleet = _Fleet(PACKAGES[pkg], nserver=2)
    c = PACKAGES[pkg].PSClient(root_uri="127.0.0.1",
                               root_port=fleet.sched.port, rank=0)
    c.init("w", n_keys=40, lr=1.0)
    c.push("w", np.arange(40), np.ones(40, np.float32))
    c.flush()
    dead = c._conns[1]
    with dead._lock:
        dead._dead = "connection reset by peer"
    with pytest.raises(ConnectionError):
        c.flush()
    np.testing.assert_array_equal(c.pull("w", np.arange(40)),
                                  np.full(40, -1.0, np.float32))
    assert c._conns[1] is not dead
    c.close()
    fleet.join()


def test_prodsim_worker_reruns_a_pass_that_lost_its_server(tmp_path):
    """C17: the drill's PS worker loop runs a ``fit_ps`` pass again when
    its closing flush finds a server connection dead, instead of exiting
    (the JAX drill's worker exits, and its peer then waits at the
    respawned server's staleness gate)."""
    from dmlc_core_tpu_torch import bench
    fleet = _Fleet(port_ps, nserver=2)
    c = port_ps.PSClient(root_uri="127.0.0.1", root_port=fleet.sched.port,
                         rank=0)
    kv = DistAsyncKVStore(c, learning_rate=0.5, device="cpu")
    flush, calls = c.flush, []

    def flush_losing_server_1_once():
        calls.append(1)
        if len(calls) == 1:
            with c._conns[1]._lock:
                c._conns[1]._dead = "connection reset by peer"
        flush()

    c.flush = flush_losing_server_1_once
    stop = tmp_path / "stop"
    stop.write_text("")
    blocks = bench._prodsim_ps_blocks(0, 200, 300)
    model, passes, reruns = bench._prodsim_ps_passes(kv, blocks, 200,
                                                     str(stop))
    assert (passes, reruns, len(calls)) == (1, 1, 2)
    assert model.weights.shape == (200,)
    assert np.isfinite(model.weights).all() and np.abs(model.weights).sum()
    kv.close()
    fleet.join()


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_server_snapshots_cross_load(writer, reader, tmp_path):
    d = str(tmp_path)
    fleet = _Fleet(PACKAGES[writer], nserver=1, snapshot_dir=d)
    c = PACKAGES[writer].PSClient(root_uri="127.0.0.1",
                                  root_port=fleet.sched.port, rank=0)
    c.init("w", n_keys=10, lr=1.0)
    for step in range(3):
        c.push("w", np.arange(10), np.full(10, step + 1, np.float32),
               wait=True)
        c.tick()
    want = c.pull_dense("w")
    c.close()
    fleet.join()
    assert os.path.exists(os.path.join(d, "ps-server-0.ckpt"))
    fleet = _Fleet(PACKAGES[reader], nserver=1, snapshot_dir=d)
    assert fleet.servers[0].restored_version == 3
    c = PACKAGES[reader].PSClient(root_uri="127.0.0.1",
                                  root_port=fleet.sched.port, rank=0)
    c.init("w", n_keys=10, lr=1.0)          # restored: a no-op
    assert c.pull_dense("w").tobytes() == want.tobytes()
    c.close()
    fleet.join()


def _ctr_blocks(rb, n=600, F=400, nnz=6, seed=3):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, F, size=(n, nnz)).astype(np.int64)
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    y = (vals[:, 0] * (idx[:, 0] % 2) - vals[:, 1] > 0).astype(np.float32)
    off = np.arange(0, n * nnz + 1, nnz, dtype=np.int64)
    return F, [rb(offset=off, label=y, index=idx.ravel(),
                  value=vals.ravel())]


def _fit_ps(pkg, model, rb, **kw):
    F, blocks = _ctr_blocks(rb)
    fleet = _Fleet(PACKAGES[pkg], nserver=1)
    store = JaxDistAsync if pkg == "jax" else DistAsyncKVStore
    kv = store(PACKAGES[pkg].PSClient(root_uri="127.0.0.1",
                                      root_port=fleet.sched.port, rank=0),
               learning_rate=0.3)
    model.fit_ps(blocks, kv, num_col=F, batch_rows=128, **kw)
    kv.close()
    fleet.join()
    return F, blocks


def test_gblinear_fit_ps_writes_jax_weights():
    jm = JaxGBLinear(learning_rate=0.3, reg_lambda=0.5)
    _fit_ps("jax", jm, JaxRowBlock, n_epochs=2)
    tm = GBLinear(learning_rate=0.3, reg_lambda=0.5, device="cpu")
    F, blocks = _fit_ps("port", tm, RowBlock, n_epochs=2)
    assert tm.weights.tobytes() == np.asarray(jm.weights).tobytes()
    assert tm.bias == jm.bias
    X = blocks[0].to_dense(F)
    margin = X @ tm.weights + np.float32(tm.bias)
    np.testing.assert_allclose(tm.predict(X, output_margin=True), margin,
                               rtol=1e-5, atol=1e-5)


def test_fm_fit_ps_writes_jax_weights():
    jm = JaxFM(n_factors=4, n_epochs=2, seed=5)
    _fit_ps("jax", jm, JaxRowBlock)
    tm = FM(n_factors=4, n_epochs=2, seed=5, device="cpu")
    F, blocks = _fit_ps("port", tm, RowBlock)
    for k in ("v", "w", "w0"):
        got = tm.params[k].cpu().numpy()
        assert tm.params[k].device.type == "cpu"
        assert got.tobytes() == np.asarray(jm.params[k]).tobytes(), k
    X = blocks[0].to_dense(F)
    np.testing.assert_allclose(tm.predict(X, output_margin=True),
                               np.asarray(jm.predict(X, output_margin=True)),
                               rtol=1e-5, atol=1e-5)


def test_ps_tracker_hosts_the_scheduler():
    from dmlc_core_tpu_torch.tracker import tracker as port_tracker

    env = {}
    tr = port_tracker.submit(1, 1, lambda n, e: env.update(e),
                             start_tracker=True)
    try:
        assert isinstance(tr, port_tracker.PSTracker) and tr.port > 0
        assert env["DMLC_PS_ROOT_PORT"] == str(tr.port)
        server = port_ps.PSServer("127.0.0.1", tr.port)
        server.start()
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        kv = KVStore.create("dist_async", client=port_ps.PSClient(
            root_uri="127.0.0.1", root_port=tr.port, rank=0),
            learning_rate=0.5)
        kv.init("w", np.ones(4, np.float32))
        kv.push("w", np.ones(4, np.float32))
        kv.flush()
        out = kv.pull("w")
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), np.full(4, 0.5))
        kv.close()
        th.join(timeout=30)
        assert tr.join(timeout=30)
    finally:
        tr.stop()
