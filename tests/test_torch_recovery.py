"""The port's elastic recovery layer (``parallel/recovery.py``), its host
transport (``parallel/collectives.set_host_transport``) and sharded
checkpoints (``parallel/checkpoint.py``) on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_recovery.py`` whole — the round checkpointer, the tracker's
grace deadline and floor, the thread-local transport hook, the
checkpoint-floor property of ``ElasticTrainer.run_device``, the engines'
resume, and the elastic protocol with one thread per worker, each with
its own ``ElasticSession`` as its thread's transport.  Its
``jax.numpy`` becomes ``torch`` (``ones``, ``asarray``), and the port's
``compute_cuts`` is handed a tensor.  Nothing is
left out.

The port's own checks: the elastic protocol's 3-worker file equal to the
port's 1-process ``fit_external`` file of the same cuts; a round
checkpoint written by either package restores in the other.  Sharded
checkpoints are held in ``test_torch_kvstore.py``.
"""

import os
import sys
import tempfile

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_suites import (export, load_port, on_cpu,  # noqa: E402,F401
                           patch_cpu_default)

torch.set_num_threads(2)

_REC = load_port("test_recovery.py", [
    ("import jax.numpy as jnp\n", "import torch as jnp\n"),
    ("cuts = compute_cuts(X, 16)", "cuts = compute_cuts(jnp.from_numpy(X), 16)")])
export(globals(), _REC, [
    "TestFoldParts", "TestRoundCheckpointer", "TestTrackerGraceDeadline",
    "TestHostTransportHook", "TestCheckpointFloorProperty",
    "TestEngineResume", "TestElasticProtocol", "TestKVStoreRecovery"])


@pytest.fixture(scope="module")
def clean_blob():
    """The loaded file's module fixture (one uninterrupted 3-worker run,
    the byte oracle), with ``device=None`` the CPU for its duration: the
    function-scoped ``on_cpu`` starts after a module fixture."""
    with pytest.MonkeyPatch.context() as mp:
        patch_cpu_default(mp)
        with tempfile.TemporaryDirectory(prefix="dmlc_rec") as d:
            out = _REC._run_clean(d)
    blobs = [v[0] for v in out.values()]
    assert all(b == blobs[0] for b in blobs), \
        "workers disagree on the clean ensemble"
    yield blobs[0]


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def test_elastic_run_writes_the_one_process_file(clean_blob, tmp_path):
    """The 3-worker elastic run (each worker's rows a third, the sketch
    merged over the workers through the tracker hub) writes the file of a
    1-process ``fit_external`` over all rows with the run's cuts: the
    histogram sums are exact, so the world size changes no byte."""
    from dmlc_core_tpu_torch.data.iter import ArrayRowIter
    from dmlc_core_tpu_torch.models import HistGBT

    path = tmp_path / "clean.gbt"
    path.write_bytes(clean_blob)
    cuts = HistGBT.load_model(str(path), device="cpu").cuts
    X, y = _REC._DATA
    one = HistGBT(device="cpu", **_REC._KW)
    one.fit_external(ArrayRowIter(X, y), cuts=cuts.numpy())
    assert _REC._save_bytes(one) == clean_blob


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_round_checkpoints_cross_load(writer, tmp_path):
    from dmlc_core_tpu.models import HistGBT as JaxHistGBT
    from dmlc_core_tpu.parallel import recovery as jrec
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.parallel import recovery as trec

    X, y = _REC._synth(400, 5, seed=2)
    kw = dict(n_trees=3, max_depth=3, n_bins=16, learning_rate=0.3)
    src = (JaxHistGBT(**kw) if writer == "jax"
           else HistGBT(device="cpu", **kw)).fit(X, y)
    (jrec if writer == "jax" else trec).RoundCheckpointer(
        str(tmp_path), rank=1).commit(src, 3, cursor={"rounds": 3})
    if writer == "jax":
        v, got, cursor = trec.RoundCheckpointer(
            str(tmp_path), rank=0).restore_model(HistGBT, floor=3,
                                                 device="cpu")
    else:
        v, got, cursor = jrec.RoundCheckpointer(
            str(tmp_path), rank=0).restore_model(JaxHistGBT, floor=3)
    assert v == 3 and cursor == {"rounds": 3}
    assert _REC._save_bytes(got) == _REC._save_bytes(src)


_LAUNCHED = r"""
import os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from dmlc_core_tpu_torch.parallel.recovery import ElasticSession
rank = int(os.environ["DMLC_TASK_ID"])
sess = ElasticSession(os.environ["DMLC_TRACKER_URI"],
                      int(os.environ["DMLC_TRACKER_PORT"]), rank=rank)
sess.join(timeout_s=60)
total = sess.allreduce(np.array([rank + 1], np.int64))
assert int(total[0]) == sum(range(1, sess.world + 1)), total
assert sess.commit(1) == 1
sess.shutdown()
"""


def test_elastic_launcher_runs_a_supervised_worker_set(tmp_path):
    """``ElasticLauncher``: its tracker and a JobSet of worker processes
    (the port's ``LocalTransport``) wired to it by the env ABI; each
    worker pins its rank to ``DMLC_TASK_ID``, joins the epoch, sums
    through the hub and commits round 1, which becomes the floor."""
    from dmlc_core_tpu_torch.launch import LocalTransport
    from dmlc_core_tpu_torch.parallel.recovery import ElasticLauncher

    script = tmp_path / "worker.py"
    script.write_text(_LAUNCHED)
    launcher = ElasticLauncher(
        [sys.executable, str(script), ROOT], nworker=2, grace_s=30.0,
        transport=LocalTransport(log_dir=str(tmp_path / "logs")),
        restart_limit=0)
    assert launcher.run(timeout=120) == [0, 0]
    assert launcher.tracker.recovery_floor() == 1
