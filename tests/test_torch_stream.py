"""The port's streaming tier (``stream/tail.py``, ``stream/publisher.py``,
``stream/trainer.py``, the port bench's ``--stream``) on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_stream.py`` whole — the dataset, the tailer (torn tails,
resync, the cursor, a SIGKILL inside the cursor commit), the warm-start
parity contract, the publisher's staging, gate and rollback, and the
slow soak and bench mode (``python -m dmlc_core_tpu_torch.bench
--stream`` under ``BENCH_FORCE_CPU``).  Nothing is left out.

The port's own checks: each ``OnlineTrainer`` refresh against the JAX
package's on the same shard at parity level (b); the warm-start contract
(``window_chunks=1, decay=1.0``) as equal model files; a cursor written
by either package resumes in the other.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.stream import OnlineTrainer as JaxOnlineTrainer  # noqa: E402
from dmlc_core_tpu.stream import RecordIOTailer as JaxTailer  # noqa: E402
from dmlc_core_tpu_torch.io.recordio import encode_records  # noqa: E402
from dmlc_core_tpu_torch.models import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.stream import (OnlineTrainer,  # noqa: E402
                                        RecordIOTailer, encode_dense_events)
from _torch_parity import assert_level_b  # noqa: E402
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

_STREAM = load_port("test_stream.py", [
    ('[sys.executable, os.path.join(repo, "bench.py"), "--stream"]',
     '[sys.executable, "-m", "dmlc_core_tpu.bench", "--stream"]')])
export(globals(), _STREAM, [
    "TestDataset", "TestTailer", "TestSigkillResume", "TestWarmStartParity",
    "TestPublisher", "TestStreamSoak", "TestStreamBenchMode"])


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


N_F = 6
KW = dict(n_trees=3, max_depth=3, n_bins=16, learning_rate=0.3)


def _xy(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_F)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2] > 0).astype(np.float32)
    return X, y


def _shard(path, chunks):
    with open(path, "wb") as f:
        for X, y in chunks:
            f.write(encode_records(encode_dense_events(X, y)))


def _model_bytes(model, tmp_path, name):
    path = str(tmp_path / name)
    model.save_model(path)
    with open(path, "rb") as f:
        return f.read()


def test_each_refresh_meets_level_b_against_jax(tmp_path):
    """The same shard through the JAX package's ``OnlineTrainer`` and the
    port's (window 2, ``decay`` 0.5: the weighted windows), refresh by
    refresh: the same rows and window, and each continued ensemble at
    parity level (b) on the refresh's window and held-out rows."""
    chunks = [_xy(200, 70 + i) for i in range(3)]
    shard = str(tmp_path / "events.rec")
    _shard(shard, chunks)
    Xv, _ = _xy(300, 79)
    jt = JaxOnlineTrainer(JaxHistGBT(**KW), JaxTailer(shard, name="j"),
                          n_features=N_F, chunk_rows=200, window_chunks=2,
                          decay=0.5, commit_cursor=False)
    tt = OnlineTrainer(HistGBT(device="cpu", **KW),
                       RecordIOTailer(shard, name="t"), n_features=N_F,
                       chunk_rows=200, window_chunks=2, decay=0.5,
                       commit_cursor=False)
    for i in range(3):
        rj, rt = jt.refresh(timeout=1.0), tt.refresh(timeout=1.0)
        for k in ("refresh", "rows", "window_rows", "records_total",
                  "trees_total"):
            assert rj[k] == rt[k], k
        Xw = np.concatenate([c[0] for c in chunks[max(0, i - 1):i + 1]])
        n_differ, parted = assert_level_b(jt.model, tt.model, Xv, X=Xw)
        assert parted is None, (i, n_differ)


def test_warm_start_contract_as_model_files(tmp_path):
    """``window_chunks=1, decay=1.0`` over chunks A then B writes the
    model file of ``fit(A); fit(B)``, byte for byte."""
    A, B = _xy(256, 11), _xy(256, 12)
    shard = str(tmp_path / "events.rec")
    _shard(shard, [A, B])
    manual = HistGBT(device="cpu", **KW)
    manual.fit(*A)
    manual.fit(*B)
    online = HistGBT(device="cpu", **KW)
    OnlineTrainer(online, RecordIOTailer(shard, name="w"), n_features=N_F,
                  chunk_rows=256, window_chunks=1, decay=1.0,
                  commit_cursor=False).run(max_refreshes=2, timeout=0.5)
    assert (_model_bytes(online, tmp_path, "online")
            == _model_bytes(manual, tmp_path, "manual"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cursor_resumes_across_packages(writer, tmp_path):
    X, y = _xy(120, 5)
    shard = str(tmp_path / "events.rec")
    _shard(shard, [(X[:100], y[:100])])
    cursor = str(tmp_path / "cursor.ckpt")
    first, second = ((JaxTailer, RecordIOTailer) if writer == "jax"
                     else (RecordIOTailer, JaxTailer))
    t = first(shard, cursor_uri=cursor, name="a")
    assert len(t.poll()) == 100 and t.commit() == 1
    t.close()
    with open(shard, "ab") as f:
        f.write(encode_records(encode_dense_events(X[100:], y[100:])))
    t2 = second(shard, cursor_uri=cursor, name="b")
    assert t2.records_seen == 100
    got = t2.poll()
    assert len(got) == 20 and t2.commit() == 2
    t2.close()
