"""The serving tier of the port (``serve/*``, ``parallel/checkpoint.py``,
``base/tracectx.py``, ``base/resilience.py``, ``io/http_util.py``, the
port bench's ``--serve``) on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_serve.py``, ``tests/test_serve_http.py`` (with the port
bench as ``python -m dmlc_core_tpu_torch.bench``),
``tests/test_resilience.py`` and ``tests/test_tracectx.py``.  Left out,
each for what the port does not have yet:

* ``test_resilience.py``: ``test_chaos_soak_train_and_serve`` (it
  installs the lock-order, race and leak checkers,
  ``base/lockcheck.py``, ``racecheck.py``, ``leakcheck.py``, not
  ported);
* ``test_tracectx.py``: ``TestTraceCollect`` (``scripts/trace_collect.py``
  is a script of the repository, not a module of either package; its
  own file runs it).

The port's own checks: serving checkpoints, model files and generic
state trees written by either package load in the other, the same bytes
for the same state (the checkpoint's leaf order is ``jax.tree``'s);
``ModelRunner`` over every family (FM too) on the CPU; the registry's
``device``; the port bench's ``--serve`` record.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.models import FM as JaxFM  # noqa: E402
from dmlc_core_tpu.models import GBLinear as JaxGBLinear  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel import checkpoint as jax_ckpt  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu.serve import registry as jax_reg  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models import (FM, GBLinear, HistGBT,  # noqa: E402
                                        SparseHistGBT)
from dmlc_core_tpu_torch.parallel import checkpoint as ckpt  # noqa: E402
from dmlc_core_tpu_torch.serve import (ModelRegistry, ModelRunner,  # noqa: E402
                                       checkpoint_model, clone_model,
                                       load_model_checkpoint,
                                       model_from_bytes, model_to_bytes)
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

_SERVE = load_port("test_serve.py", [
    ("import bench as bench_mod\n",
     "from dmlc_core_tpu import bench as bench_mod\n")])
export(globals(), _SERVE, ["TestModelRunner", "TestDynamicBatcher",
                           "TestModelRegistry", "TestServeBenchHelpers"])
_HTTP = load_port("test_serve_http.py", [
    ('[sys.executable, "bench.py", "--serve"]',
     '[sys.executable, "-m", "dmlc_core_tpu.bench", "--serve"]')])
export(globals(), _HTTP, ["TestServeHTTP", "TestServeSoak"])
_RES = load_port("test_resilience.py")
export(globals(), _RES, ["TestRetryPolicy", "TestCircuitBreaker",
                         "TestFaultInject", "TestChaosSchedule",
                         "TestProducerRestart", "TestCheckpointDurability",
                         "TestTrackerGrace"])
_TRACE = load_port("test_tracectx.py")
export(globals(), _TRACE, ["TestEncoding", "TestDisabledDiscipline",
                           "TestSpanParenting", "TestTracerMetadata"])
# the loaded file's autouse fixture (tracing state isolation)
_trace_isolation = _TRACE._trace_isolation


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def _data(n=400, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_state_tree_checkpoint_bytes_equal_jax(tmp_path):
    """The same state through both packages' ``checkpoint``: the same
    file and sidecar bytes; each package loads the other's."""
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(3, 4)).astype(np.float32),
            rng.integers(0, 9, 5).astype(np.int64))
    state_np = {"z": [a, None, (b, 2.5)], "a": {"k": 7, "c": "s"},
                "m": np.float32(1.5)}
    state_t = {"z": [torch.from_numpy(a), None, (torch.from_numpy(b), 2.5)],
               "a": {"k": 7, "c": "s"}, "m": np.float32(1.5)}
    jax_ckpt.checkpoint(str(tmp_path / "j.ckpt"), state_np, version=3)
    ckpt.checkpoint(str(tmp_path / "t.ckpt"), state_t, version=3)
    for suffix in ("", ".crc"):
        assert ((tmp_path / f"j.ckpt{suffix}").read_bytes()
                == (tmp_path / f"t.ckpt{suffix}").read_bytes())
    like = {"z": [torch.zeros(1), None, (torch.zeros(1), 0.0)],
            "a": {"k": 0, "c": ""}, "m": np.float32(0)}
    v, got = ckpt.load_checkpoint(str(tmp_path / "j.ckpt"), like)
    assert v == 3 and got["a"] == {"k": 7, "c": "s"} and got["m"] == 1.5
    assert isinstance(got["z"][0], torch.Tensor)
    np.testing.assert_array_equal(got["z"][0].numpy(), a)
    assert got["z"][1] is None and got["z"][2][1] == 2.5
    np.testing.assert_array_equal(got["z"][2][0].numpy(), b)
    v, got = jax_ckpt.load_checkpoint(str(tmp_path / "t.ckpt"), state_np)
    np.testing.assert_array_equal(np.asarray(got["z"][0]), a)
    assert ckpt.load_checkpoint(str(tmp_path / "none"), like) == (0, like)
    # sharded=True in a world of one is the unsharded path, as in JAX
    ckpt.checkpoint(str(tmp_path / "s"), state_t, version=3, sharded=True)
    assert (tmp_path / "s").read_bytes() == (tmp_path / "t.ckpt").read_bytes()
    v, got = ckpt.load_checkpoint(str(tmp_path / "j.ckpt"), like,
                                  sharded=True)
    assert v == 3 and got["a"] == {"k": 7, "c": "s"}


def _families(X, y):
    """One fitted port model of each family a checkpoint can hold."""
    return {
        "histgbt": HistGBT(device="cpu", n_trees=3, max_depth=3,
                           n_bins=16).fit(X, y),
        "gblinear": GBLinear(device="cpu", n_rounds=5).fit(X, y),
        "fm": FM(device="cpu", n_factors=3, n_epochs=2,
                 batch_size=64).fit(X, y),
    }


@pytest.mark.parametrize("family", ["histgbt", "gblinear", "fm"])
def test_serving_checkpoints_cross_load(family, tmp_path):
    X, y = _data()
    tm = _families(X, y)[family]
    port_uri = str(tmp_path / "port.ckpt")
    checkpoint_model(port_uri, tm, version=4)
    v, jm = jax_reg.load_model_checkpoint(port_uri)
    assert v == 4 and type(jm).__name__ == type(tm).__name__
    # the JAX model re-checkpointed: the same bytes
    jax_uri = str(tmp_path / "jax.ckpt")
    jax_reg.checkpoint_model(jax_uri, jm, version=4)
    assert (tmp_path / "port.ckpt").read_bytes() == \
        (tmp_path / "jax.ckpt").read_bytes()
    v, back = load_model_checkpoint(jax_uri, device="cpu")
    assert v == 4 and back.device.type == "cpu"
    if family == "histgbt":
        np.testing.assert_array_equal(back.predict(X, output_margin=True),
                                      jm.predict(X, output_margin=True))
    else:
        np.testing.assert_allclose(back.predict(X, output_margin=True),
                                   jm.predict(X, output_margin=True),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(back.predict(X), tm.predict(X))
    # a model JAX trained, checkpointed by JAX, served by the port
    jfit = {"histgbt": lambda: JaxHistGBT(n_trees=3, max_depth=3, n_bins=16,
                                          mesh=local_mesh(1)),
            "gblinear": lambda: JaxGBLinear(n_rounds=5),
            "fm": lambda: JaxFM(n_factors=3, n_epochs=2, batch_size=64)}
    j2 = jfit[family]().fit(X, y)
    jax_reg.checkpoint_model(str(tmp_path / "j2.ckpt"), j2, version=9)
    reg = ModelRegistry(name=f"x-{family}", device="cpu", max_batch=64,
                        min_bucket=8)
    assert reg.load(str(tmp_path / "j2.ckpt")) == 9
    _, runner = reg.current()
    np.testing.assert_allclose(runner.predict(X[:37]), j2.predict(X[:37]),
                               rtol=1e-5, atol=1e-6)


def test_model_bytes_and_clone():
    X, y = _data(200)
    for m in _families(X, y).values():
        blob = model_to_bytes(m)
        again = model_from_bytes(blob, device="cpu")
        assert model_to_bytes(again) == blob
        twin = clone_model(m)
        assert type(twin) is type(m) and twin.device == m.device
        np.testing.assert_array_equal(twin.predict(X), m.predict(X))
    with pytest.raises(ValueError, match="magic"):
        model_from_bytes(b"not a model")


# ---------------------------------------------------------------------------
# the runner over every family
# ---------------------------------------------------------------------------

def test_runner_serves_fm_and_sparse():
    X, y = _data(300)
    fm = FM(device="cpu", n_factors=3, n_epochs=2, batch_size=64).fit(X, y)
    n, F = X.shape
    sparse = SparseHistGBT(device="cpu", n_trees=3, max_depth=3, n_bins=16)
    sparse.fit(np.arange(0, n * F + 1, F, dtype=np.int64),
               np.tile(np.arange(F, dtype=np.int64), n), X.reshape(-1).copy(),
               y, n_features=F)
    for model in (fm, sparse):
        r = ModelRunner(model, max_batch=64, min_bucket=8)
        assert r.n_features == F and r._device is None
        r.warmup()
        assert sorted(r.compiled_shapes) == [8, 16, 32, 64]
        got = r.predict(X[:150])                       # chunked: 64+64+22
        np.testing.assert_array_equal(got[:37], r.predict(X[:37]))
        assert got.shape == (150,)


def test_registry_device_and_prewarm(monkeypatch, tmp_path):
    X, y = _data(200)
    m = HistGBT(device="cpu", n_trees=2, max_depth=3, n_bins=16).fit(X, y)
    checkpoint_model(str(tmp_path / "m.ckpt"), m, version=1)
    monkeypatch.setenv("DMLC_SERVE_PREWARM", "1")
    reg = ModelRegistry(name="dev", device="cpu", max_batch=32, min_bucket=8)
    reg.load(str(tmp_path / "m.ckpt"))
    _, runner = reg.current()
    assert runner.model.device.type == "cpu"
    assert sorted(runner.compiled_shapes) == [8, 16, 32]   # prewarmed


# ---------------------------------------------------------------------------
# the port bench's --serve
# ---------------------------------------------------------------------------

def test_bench_serve_record():
    env = dict(os.environ, BENCH_FORCE_CPU="1", SERVE_SECONDS="1",
               SERVE_QPS="60", SERVE_TRAIN_ROWS="3000", SERVE_TREES="3",
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                          "--serve"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    assert [r["phase"] for r in lines] == ["train", "warmup", "load",
                                           "done"]
    rec = lines[-1]
    assert rec["metric"] == "serve_requests_per_sec"
    assert rec["provisional"] is False and rec["platform"] == "cpu"
    assert rec["completed"] > 0 and rec["latency_p99_ms"] is not None
    assert rec["compiled_shapes"] and \
        len(rec["compiled_shapes"]) <= rec["shape_bound"]
    for k in ("qps", "duration_s", "max_batch", "max_delay_ms",
              "req_sizes", "train_rows", "n_trees", "submitted",
              "rejected", "errors", "warmup_seconds", "batches"):
        assert k in rec, k


def test_bench_serve_needs_a_gpu_unless_forced():
    env = {k: v for k, v in os.environ.items() if k != "BENCH_FORCE_CPU"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                          "--serve"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode != 0
    rec = json.loads(res.stdout.splitlines()[-1])
    assert rec["provisional"] is False and "no CUDA GPU" in rec["error"]


# ---------------------------------------------------------------------------
# the copies the serving tier and the wrappers needed (ROADMAP C9)
# ---------------------------------------------------------------------------

def test_metrics_histogram_time():
    from dmlc_core_tpu_torch.base import metrics as M

    reg = M.MetricsRegistry()
    h = reg.histogram("t_seconds", "t", labels=("k",))
    with h.time(k="a"):
        pass
    h.observe(2.0, k="a")
    assert h.count(k="a") == 2
    (series,) = reg.snapshot()["metrics"]["dmlc_t_seconds"]["series"]
    assert 0.0 <= series["min"] < 1.0 and series["max"] == 2.0
    M.set_enabled(False)
    try:
        with h.time(k="a"):
            pass
    finally:
        M.set_enabled(True)
    assert h.count(k="a") == 2


def test_parameter_fields():
    from dmlc_core_tpu.models.histgbt import HistGBTParam as JaxParam
    from dmlc_core_tpu_torch.models.histgbt import HistGBTParam

    assert list(HistGBTParam.fields()) == list(JaxParam.fields())
    assert "gamma" in HistGBTParam.fields()
