"""``dmlc-submit`` on the port, end to end on the CPU: workers started by
``python -m dmlc_core_tpu_torch.tracker.submit --cluster local`` each read
their ``InputSplit`` part of libsvm shards from ``s3://`` (an in-process
S3 fake reached through ``S3_ENDPOINT``), parse it with the native parser
and train data-parallel with ``fit_external`` over a gloo group.

* 20,000 × 28 HIGGS-like rows (the bench's rule, seed 7) written with
  ``%.9g`` into 4 shards; configuration 1's widths (depth 6, 256 bins,
  pack and bundle requested, 5 trees), grown depth-wise: the external
  engine's chunked route, which several ranks take, grows depth-wise
  whatever ``DMLC_GROW_POLICY`` says, as the JAX package's does, so
  configuration 1's lossguide would part the ranks' file from the
  in-core one by design;
* the native parse of the shards gives the generator's f32 rows bit for
  bit, and equals the Python route's parse;
* 2 workers from ``s3://`` and 1 worker from the local shards write the
  file of the 1-process in-core fit on the parsed rows with the same cuts;
  every rank parsed natively (its call counts), and the local worker read
  through the native chunk reader;
* that file meets parity level (b) against the JAX package's ``HistGBT``
  fitted on the same rows and cuts.

Where no C++ compiler is found the native library is absent and the
tests skip, as the JAX package's native tests do.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import assert_level_b  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.data import _native  # noqa: E402
from dmlc_core_tpu_torch.data.iter import RowBlockIter  # noqa: E402
from dmlc_core_tpu_torch.data.parsers import _py_parse_libsvm  # noqa: E402
from test_remote_fs import _S3Fake  # noqa: E402

torch.set_num_threads(2)



@pytest.fixture(autouse=True)
def _native_library():
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler: the native library is absent")

ROWS, F, SHARDS, SEED = 20_000, 28, 4, 7
KW = dict(n_trees=5, max_depth=6, n_bins=256)
LEVERS = {"DMLC_BIN_PACK": "1", "DMLC_FEATURE_BUNDLE": "1"}


def higgs_like(n, seed):
    """The bench's HIGGS-like rule: dense gaussians, a nonlinear label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    return X, (margin > 0).astype(np.float32)


def libsvm_shards(X, y, shards):
    """``%.9g`` libsvm text of the rows, every feature written, cut into
    ``shards`` consecutive pieces."""
    out = []
    for part in np.array_split(np.arange(len(y)), shards):
        lines = [f"{y[i]:.9g} " + " ".join(
            f"{j}:{v:.9g}" for j, v in enumerate(X[i])) for i in part]
        out.append(("\n".join(lines) + "\n").encode())
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("submit")
    X, y = higgs_like(ROWS, SEED)
    shards = libsvm_shards(X, y, SHARDS)
    local = d / "shards"
    local.mkdir()
    for k, blob in enumerate(shards):
        (local / f"part-{k}.libsvm").write_bytes(blob)
    return {"dir": d, "X": X, "y": y, "shards": shards, "local": local}


@pytest.fixture
def s3(data):
    store = {f"bkt/higgs/part-{k}.libsvm": blob
             for k, blob in enumerate(data["shards"])}
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              type("H", (_S3Fake,), {"store": store}))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _parsed(local):
    it = RowBlockIter.create(str(local), 0, 1, "libsvm")
    block = it.value
    Xp = block.to_dense(F)
    yp = np.asarray(block.label, np.float32)
    it.close()
    return Xp, yp


def test_native_parse_is_the_generators_rows(data):
    _native.reset_calls()
    Xp, yp = _parsed(data["local"])
    assert _native.calls()["parse_libsvm"] > 0
    assert Xp.tobytes() == data["X"].tobytes()
    assert yp.tobytes() == data["y"].tobytes()
    for blob in data["shards"]:
        nat, py = _native.parse_libsvm(blob), _py_parse_libsvm(blob)
        for k in ("offset", "label", "index", "value"):
            assert nat[k].tobytes() == np.asarray(
                py[k], nat[k].dtype).tobytes(), k


def _submit(job, world, d, env):
    job_path = d / f"job{world}.json"
    job_path.write_text(json.dumps(job))
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
           "--cluster", "local", "--num-workers", str(world),
           "--max-attempts", "1", "--log-level", "WARNING", "--",
           sys.executable, "-m", "dmlc_core_tpu_torch.parallel.launch",
           "--worker", str(job_path)]
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]


def test_submit_from_s3_writes_the_in_core_file(data, s3, monkeypatch):
    for k in ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", *LEVERS):
        monkeypatch.delenv(k, raising=False)
    d = data["dir"]
    Xp, yp = _parsed(data["local"])
    with monkeypatch.context() as m:
        for k, v in LEVERS.items():
            m.setenv(k, v)
        cuts = HistGBT(device="cpu", **KW).fit(Xp, yp).cuts.numpy()
        incore = HistGBT(device="cpu", **KW).fit(Xp, yp, cuts=cuts)
        jm = JaxHistGBT(mesh=local_mesh(1), **KW).fit(Xp, yp, cuts=cuts)
    np.save(d / "cuts.npy", cuts)
    incore.save_model(str(d / "incore.model"))
    want = (d / "incore.model").read_bytes()

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DMLC_")}
    env.update(PYTHONPATH=ROOT, S3_ENDPOINT=s3,
               AWS_ACCESS_KEY_ID="AKIDEXAMPLE", AWS_SECRET_ACCESS_KEY="s",
               AWS_REGION="us-east-1")
    runs = {2: ("s3", "s3://bkt/higgs/"), 1: ("local", str(data["local"]))}
    for world, (name, uri) in runs.items():
        _submit({"cuts": str(d / "cuts.npy"), "backend": "gloo",
                 "device": "cpu", "threads": 1, "params": KW,
                 "runs": [{"name": name, "env": LEVERS, "external": {
                     "uri": uri, "num_col": F}}],
                 "out": str(d / "out")}, world, d, env)
        for r in range(world):
            assert (d / "out" / f"{name}.{r}.model").read_bytes() == want
            stats = json.loads((d / "out" / f"{name}.{r}.json").read_text())
            assert stats["world"] == world
            assert stats["native"]["parse_libsvm"] > 0, stats["native"]
            if name == "local":
                assert stats["native"]["prefetch_chunks"] > 0
    # the ranks wrote the in-core model's bytes: its fit (train margins
    # included) stands for theirs against JAX's
    Xv, _ = higgs_like(2_000, SEED + 1)
    assert assert_level_b(jm, incore, Xv, X=Xp, y=yp)[1] is None
