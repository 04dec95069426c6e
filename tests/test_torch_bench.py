"""The port's bench (``python -m dmlc_core_tpu_torch.bench``) and the
pieces of ``HistGBT`` it runs on: the chunked ``fit_device`` with warmup
rounds, the host binning route, the boosting metrics.

* ``chunk_stats``, ``scaling_summary``, ``_host_cuts`` and the cost model
  ``_derived_metrics`` give ``bench.py``'s values on the same inputs;
* the bench under ``BENCH_FORCE_CPU=1`` (a subprocess, small rows) ends
  with a final record carrying ``bench.py``'s flagship fields, the
  kvstore smoke's ``kvstore_sync_ms`` among them; without a GPU and
  without ``BENCH_FORCE_CPU`` it fails (the flagship, ``--fleet``,
  ``--tenants`` and ``--stream``); a mode it does not have
  (``--prodsim``) is refused;
* any chunk size (``DMLC_TPU_ROUNDS_PER_DISPATCH``) and any number of
  warmup rounds write the model file of ``fit``, byte for byte, and
  ``chunk_callback`` fires once per chunk;
* ``_host_bin_t`` is bit-equal to the JAX package's and to
  ``apply_bins``, and the host route's model file is the device route's.
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

import bench as jbench  # noqa: E402
from dmlc_core_tpu.models import gbt_split as jsplit  # noqa: E402
from dmlc_core_tpu.models import histgbt as jgbt  # noqa: E402
from dmlc_core_tpu_torch import bench as tbench  # noqa: E402
from dmlc_core_tpu_torch.base import metrics as tmetrics  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models import gbt_split as tsplit  # noqa: E402
from dmlc_core_tpu_torch.models import histgbt as tgbt  # noqa: E402
from dmlc_core_tpu_torch.ops.quantile import apply_bins  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

CHUNKS = [
    [(25, 3.0), (50, 6.1), (75, 9.1), (100, 12.2)],
    [(25, 3.0), (50, 43.0), (75, 46.0), (100, 49.0)],
    [(25, 3.0)],
    [],
    [(25, 1.0), (50, 1.0), (75, 2.0)],
    [(3, 0.5), (6, 0.9), (7, 1.0)],
]


@pytest.mark.parametrize("chunks", CHUNKS)
def test_chunk_stats_is_bench_pys(chunks):
    total = chunks[-1][0] if chunks else 100
    secs = chunks[-1][1] if chunks else 50.0
    assert tbench.chunk_stats(chunks, total, secs) == \
        jbench.chunk_stats(chunks, total, secs)


@pytest.mark.parametrize("args", [(8, 2.0, 2.5), (1, 3.0, 3.0),
                                  (4, 1.0, 0.0), (0, 1.0, 2.0),
                                  (2, 5.0, None)])
def test_scaling_summary_is_bench_pys(args):
    assert tbench.scaling_summary(*args) == jbench.scaling_summary(*args)


def test_host_cuts_are_bench_pys():
    X = np.random.default_rng(2).normal(size=(5000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tbench._host_cuts(X, 16, sample=1000),
                                  jbench._host_cuts(X, 16, sample=1000))


@pytest.mark.parametrize("policy,leaves,fused", [
    ("depthwise", 0, False), ("depthwise", 0, True),
    ("lossguide", 16, True)])
def test_derived_metrics_are_bench_pys(policy, leaves, fused):
    kw = dict(grow_policy=policy, max_leaves=leaves, fused=fused)
    got = tbench._derived_metrics(10_000_000, 28, 6, 256, 0.05, "gpu", **kw)
    want = jbench._derived_metrics(10_000_000, 28, 6, 256, 0.05, "gpu", **kw)
    assert got == want and got["mfu"] is None


def _bench(env_extra, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "DMLC_"))}
    env.update(env_extra)
    return subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_bench_final_record_on_the_cpu():
    res = _bench({"BENCH_FORCE_CPU": "1", "BENCH_ROWS": "20000",
                  "BENCH_ROUNDS": "4", "BENCH_WARMUP": "2"})
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()]
    assert all(r["metric"] == "histgbt_rounds_per_sec_per_chip"
               for r in lines)
    assert all(r["provisional"] for r in lines[:-1])
    rec = lines[-1]
    assert rec["provisional"] is False and "error" not in rec
    assert rec["platform"] == "cpu" and rec["phase"] == "done"
    assert rec["value"] > 0 and rec["value_basis"] == "wall"
    assert rec["rounds_done"] == rec["rounds"] == 4
    assert rec["rows"] == 20000 and rec["features"] == 28
    for key in ("rounds_per_sec_median_chunk", "chunk_seconds_per_round",
                "warmup_seconds", "bin_seconds", "time_to_first_tree",
                "warm_dispatch_seconds", "warmup_breakdown", "compile_cache",
                "hbm_bytes_per_round", "hbm_gbps", "mxu_flops_per_round",
                "hist_psum_bytes_per_round", "runs", "metrics_summary"):
        assert key in rec, key
    assert rec["mfu"] is None
    assert rec["levers"] == {"bin_pack": True, "feature_bundle": True,
                             "grow_policy": "lossguide", "max_leaves": 16,
                             "fused_round": "auto", "hist_quant": False}
    kernel = rec["kernel"]
    assert kernel["fused_round"] is True and kernel["bin_layout"] is None
    assert kernel["leaves_built_per_round"] == 16
    assert 0.0 <= rec["infeed_stall_frac"]["value"] <= 1.0
    assert rec["kvstore_sync_ms"]["value"] > 0
    assert rec["metrics_summary"]["rounds_total"] == 4.0


def test_bench_needs_a_gpu_unless_forced_to_the_cpu():
    res = _bench({"BENCH_ROWS": "20000", "BENCH_ROUNDS": "4"})
    assert res.returncode != 0
    assert "no CUDA GPU" in res.stderr
    rec = json.loads(res.stdout.splitlines()[-1])
    assert rec["provisional"] is False and "no CUDA GPU" in rec["error"]


def test_bench_refuses_the_modes_it_does_not_have():
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                          "--prodsim"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 2 and "not ported" in res.stderr


@pytest.mark.parametrize("mode,metric", [
    ("--fleet", "fleet_requests_per_sec"),
    ("--tenants", "tenant_requests_per_sec"),
    ("--stream", "stream_staleness_seconds")])
def test_bench_fleet_and_tenants_need_a_gpu(mode, metric):
    # without BENCH_FORCE_CPU they ask for the card: no fallback
    env = {k: v for k, v in os.environ.items() if k != "BENCH_FORCE_CPU"}
    env.update(CUDA_VISIBLE_DEVICES="", FLEET_TRAIN_ROWS="2000",
               TENANTS_TRAIN_ROWS="2000")
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                          mode], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA GPU" in res.stderr
    rec = json.loads(res.stdout.splitlines()[-1])
    assert rec["metric"] == metric and rec["provisional"] is False
    assert "no CUDA GPU" in rec["error"]


# ---------------------------------------------------------------------------
# chunked fit_device, warmup rounds, host binning
# ---------------------------------------------------------------------------

def _data(n=3000, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] + X[:, 2]) > 0).astype(np.float32)
    return X, y


PARAMS = dict(n_trees=7, max_depth=4, n_bins=32, learning_rate=0.3)


def _file(model, tmp_path, name):
    path = str(tmp_path / name)
    model.save_model(path)
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def env(monkeypatch):
    for k in ("DMLC_TPU_ROUNDS_PER_DISPATCH", "DMLC_TPU_BIN_BACKEND",
              "DMLC_GROW_POLICY", "DMLC_MAX_LEAVES"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
@pytest.mark.parametrize("k", [1, 3, 25])
@pytest.mark.parametrize("warmup", [0, 2])
def test_any_chunking_and_warmup_writes_fits_model_file(env, tmp_path,
                                                        policy, k, warmup):
    X, y = _data()
    if policy == "lossguide":
        env.setenv("DMLC_GROW_POLICY", "lossguide")
        env.setenv("DMLC_MAX_LEAVES", "6")
    ref = tgbt.HistGBT(device="cpu", **PARAMS).fit(X, y)
    env.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", str(k))
    model = tgbt.HistGBT(device="cpu", **PARAMS)
    dd = model.make_device_data(X, y)
    calls = []
    model.fit_device(dd, warmup_rounds=warmup,
                     chunk_callback=lambda *a: calls.append(a))
    assert _file(model, tmp_path, "a") == _file(ref, tmp_path, "b")
    np.testing.assert_array_equal(model.train_margins(), ref.train_margins())
    n_chunks = -(-PARAMS["n_trees"] // k)
    assert len(calls) == len(model.last_chunk_times) == n_chunks
    assert calls == model.last_chunk_times
    assert [c[0] for c in calls] == [min((i + 1) * k, PARAMS["n_trees"])
                                     for i in range(n_chunks)]
    assert all(a[1] <= b[1] for a, b in zip(calls, calls[1:]))
    assert len(model.last_tree_times) == PARAMS["n_trees"]
    assert model.last_warmup_seconds >= model.last_warm_dispatch_seconds
    assert set(model.last_warmup_breakdown) == {"trace", "dispatch",
                                                "device"}
    assert (model.last_warmup_breakdown["dispatch"] > 0) == (warmup > 0)
    # a second fit on the same handle is a new fit, not a continuation
    model.fit_device(dd)
    assert _file(model, tmp_path, "c") == _file(ref, tmp_path, "b")


def test_rounds_schedule_is_jaxs(env):
    for k_env in (None, "1", "3", "25", "40"):
        if k_env is None:
            env.delenv("DMLC_TPU_ROUNDS_PER_DISPATCH", raising=False)
        else:
            env.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", k_env)
        for n_trees in (1, 7, 25, 100, 101):
            assert tgbt._rounds_schedule(n_trees) == \
                jgbt._rounds_schedule(n_trees, 0)
    env.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", "0")
    with pytest.raises(Error):
        tgbt._rounds_schedule(10)


def test_fit_device_reports_the_boosting_metrics(env):
    X, y = _data(n=800)
    reg = tmetrics.default_registry()
    m = tsplit.gbt_metrics()
    rounds0 = m["rounds"].value(engine="incore")
    trees0 = m["trees"].value(engine="incore")
    phase0 = m["phase"].count(engine="incore", phase="round")
    env.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", "3")
    model = tgbt.HistGBT(device="cpu", **PARAMS)
    model.fit_device(model.make_device_data(X, y), warmup_rounds=1)
    assert m["rounds"].value(engine="incore") - rounds0 == PARAMS["n_trees"]
    assert m["trees"].value(engine="incore") - trees0 == PARAMS["n_trees"]
    assert m["phase"].count(engine="incore", phase="round") - phase0 == 3
    assert m["phase"].count(engine="incore", phase="warmup") >= 1
    names = reg.snapshot()["metrics"]
    assert names["dmlc_gbt_phase_seconds"]["kind"] == "histogram"
    assert "dmlc_gbt_rounds_total" in names


def test_start_warmup_has_nothing_to_build_on_the_cpu():
    model = tgbt.HistGBT(device="cpu", **PARAMS)
    assert model.start_warmup(1000, 6) is False
    X, y = _data(n=500)
    model.fit(X, y)
    assert model.last_compile_seconds is None
    assert model.last_compile_cache is None


def test_host_bin_t_is_jaxs_and_apply_bins():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(4000, 5)).astype(np.float32)
    X[::7, 2] = 0.0                          # ties on a cut
    for n_bins in (16, 256):
        cuts = np.sort(rng.normal(size=(5, n_bins - 1)).astype(np.float32),
                       axis=1)
        cuts[:, 0] = 0.0
        got = tsplit._host_bin_t(X, cuts)
        assert got.dtype == np.uint8 and got.shape == (5, 4000)
        np.testing.assert_array_equal(got, jsplit._host_bin_t(X, cuts))
        np.testing.assert_array_equal(got, apply_bins(
            torch.from_numpy(X), torch.from_numpy(cuts)).numpy())
    Xm = X.copy()
    Xm[::5, 1] = np.nan
    np.testing.assert_array_equal(
        tsplit._host_bin_t(Xm, cuts[:, :-1], missing=True),
        jsplit._host_bin_t(Xm, cuts[:, :-1], missing=True))


def test_host_bin_backend_knob(env):
    assert tsplit._host_bin_requested() is False
    env.setenv("DMLC_TPU_BIN_BACKEND", "")
    assert tsplit._host_bin_requested() is False
    env.setenv("DMLC_TPU_BIN_BACKEND", "cpu")
    assert tsplit._host_bin_requested() is True
    env.setenv("DMLC_TPU_BIN_BACKEND", "tpu")
    with pytest.raises(Error):
        tsplit._host_bin_requested()


@pytest.mark.parametrize("levers", [{}, {"DMLC_BIN_PACK": "1",
                                         "DMLC_FEATURE_BUNDLE": "1"}])
def test_host_route_writes_the_device_routes_model(env, tmp_path, levers):
    rng = np.random.default_rng(6)
    X, y = _data(n=2000, F=6, seed=6)
    X[:, 4] = rng.integers(0, 3, len(X))           # narrow: packs
    w = rng.uniform(0.5, 2.0, len(X)).astype(np.float32)
    for k, v in levers.items():
        env.setenv(k, v)
    dev = tgbt.HistGBT(device="cpu", **PARAMS)
    dd_dev = dev.make_device_data(X, y, weight=w)
    dev.fit_device(dd_dev)
    env.setenv("DMLC_TPU_BIN_BACKEND", "cpu")
    host = tgbt.HistGBT(device="cpu", **PARAMS)
    dd_host = host.make_device_data(X, y, weight=w)
    assert torch.equal(dd_host["bins_t"], dd_dev["bins_t"])
    assert (dd_host["layout"] is None) == (dd_dev["layout"] is None)
    host.fit_device(dd_host)
    assert _file(host, tmp_path, "h") == _file(dev, tmp_path, "d")
