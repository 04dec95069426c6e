"""``GBLinear`` (``models/linear.py``) in the port, against the JAX
package, on the CPU.

Tolerances: weights and bias within rtol 2e-4, atol 2e-6 of the JAX
package's fit on the same rows — its own bound between two f32
summation orders (``tests/test_linear.py``, 8 devices against 1); the
bfloat16 feature matrix bit-equal to JAX's ``astype(bfloat16)``; model
files cross-load both ways with margins within rtol 1e-6; 2 gloo ranks
against 1 process within the same tolerance.

``tests/test_linear.py`` is loaded against the port as well
(``*_port``).  Left out: ``test_mesh_matches_single_device`` (a JAX
mesh of 8 CPU devices; the port's data axis is processes, held here by
``test_two_ranks_match_one_process``).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402
from dmlc_core_tpu.models.linear import GBLinear as JaxGBLinear  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.data.iter import ArrayRowIter, RowBlockIter  # noqa: E402
from dmlc_core_tpu_torch.models.linear import GBLinear  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import launch  # noqa: E402
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-6

_SUITE = load_port("test_linear.py", [
    ("import jax\nfrom jax.sharding import Mesh\n", "")])
export(globals(), _SUITE, ["TestGBLinear", "TestScalePosWeightLinear"],
       left_out={"TestGBLinear": ["test_mesh_matches_single_device"]})


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def _problem(n=3000, F=7, seed=0, dead=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    w = np.linspace(1.0, -1.0, F).astype(np.float32)
    yc = (X @ w + 0.3 + 0.1 * rng.normal(size=n)).astype(np.float32)
    if dead:
        X[:, 3] = 0.0
    return X, yc


def _close(tm, jm):
    np.testing.assert_allclose(tm.weights, jm.weights, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.bias, jm.bias, rtol=RTOL, atol=ATOL)


CASES = {
    "logistic": dict(objective="binary:logistic"),
    "regression": dict(objective="reg:squarederror"),
    "l1": dict(objective="reg:squarederror", reg_alpha=20.0,
               reg_lambda=1e-3),
    "bf16": dict(objective="binary:logistic", feature_dtype="bfloat16"),
    "bf16_l1": dict(objective="reg:squarederror", feature_dtype="bfloat16",
                    reg_alpha=5.0),
    "dead_column_zero_lambda": dict(objective="reg:squarederror",
                                    reg_lambda=0.0),
    "scale_pos_weight": dict(objective="binary:logistic",
                             scale_pos_weight=3.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("weighted", [False, True])
def test_weights_match_jax(case, weighted):
    kw = dict(n_rounds=40, **CASES[case])
    X, yc = _problem(dead=case.startswith("dead"))
    y = (yc > 0.3).astype(np.float32) if "logistic" in kw["objective"] \
        else yc
    weight = (np.random.default_rng(5).uniform(0, 2, len(y))
              .astype(np.float32) if weighted else None)
    jm = JaxGBLinear(**kw).fit(X, y, weight=weight)
    tm = GBLinear(device="cpu", **kw).fit(X, y, weight=weight)
    _close(tm, jm)
    if case.startswith("dead"):
        assert tm.weights[3] == 0.0 and np.isfinite(tm.weights).all()
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_bf16_matrix_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    X = (rng.normal(size=(4000, 9)) * 10.0 ** rng.integers(
        -3, 4, size=(4000, 9))).astype(np.float32)
    X[0, :4] = [0.0, -0.0, 1e-40, -3.0000002]           # ±0, subnormal
    m = GBLinear(device="cpu", feature_dtype="bfloat16")
    got = m._upload(len(X), X.shape[1], [(0, X[:1500]), (1500, X[1500:])])
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(X).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16), want)


def test_chunks_and_warmup():
    X, yc = _problem(n=600)
    m = GBLinear(device="cpu", n_rounds=60, objective="reg:squarederror")
    m.fit(X, yc, warmup_rounds=1)
    assert [d for d, _ in m.last_chunk_times] == [25, 50, 60]
    assert m.last_warmup_seconds > 0
    again = GBLinear(device="cpu", n_rounds=60,
                     objective="reg:squarederror").fit(X, yc)
    np.testing.assert_array_equal(m.weights, again.weights)


def test_row_blocks_and_upload_slabs_give_the_same_model(monkeypatch):
    import dmlc_core_tpu_torch.models.linear as L

    X, yc = _problem(n=2500)
    y = (yc > 0.3).astype(np.float32)
    ref = GBLinear(device="cpu", n_rounds=20).fit(X, y)
    monkeypatch.setattr(L, "_BLOCK_ROWS", 512)
    monkeypatch.setattr(L, "_UPLOAD_ROWS", 333)
    small = GBLinear(device="cpu", n_rounds=20).fit(X, y)
    np.testing.assert_allclose(small.weights, ref.weights, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fit_iter_and_predict_iter(dtype):
    X, yc = _problem(n=1700, F=5)
    y = (yc > 0.3).astype(np.float32)
    kw = dict(device="cpu", n_rounds=30, feature_dtype=dtype)
    core = GBLinear(**kw).fit(X, y)
    it = GBLinear(**kw).fit_iter(ArrayRowIter(X, y, page_rows=300),
                                 rows_per_upload=256)
    np.testing.assert_array_equal(it.weights, core.weights)
    assert it.bias == core.bias
    # another batch shape may sum the product in another order
    np.testing.assert_allclose(
        core.predict_iter(ArrayRowIter(X, y, page_rows=400),
                          batch_rows=512), core.predict(X), rtol=1e-6,
        atol=1e-7)


def test_fit_iter_libsvm_matches_jax(tmp_path):
    from dmlc_core_tpu.data.iter import RowBlockIter as JaxRowBlockIter

    X, yc = _problem(n=900, F=4)
    y = (yc > 0.3).astype(np.float32)
    path = tmp_path / "lin.svm"
    with open(path, "w") as f:
        for i in range(len(y)):
            feats = " ".join(f"{j}:{X[i, j]:.6f}" for j in range(4))
            f.write(f"{int(y[i])} {feats}\n")
    it = RowBlockIter.create(str(path), 0, 1, "libsvm")
    tm = GBLinear(device="cpu", n_rounds=25).fit_iter(it, num_col=4)
    it.close()
    jit = JaxRowBlockIter.create(str(path), 0, 1, "libsvm")
    jm = JaxGBLinear(n_rounds=25).fit_iter(jit, num_col=4)
    jit.close()
    _close(tm, jm)


@pytest.mark.parametrize("objective", ["binary:logistic",
                                       "reg:squarederror"])
def test_model_files_cross_load(objective, tmp_path):
    X, yc = _problem(n=800)
    y = (yc > 0.3).astype(np.float32) if objective == "binary:logistic" \
        else yc
    kw = dict(n_rounds=15, objective=objective)
    jm = JaxGBLinear(**kw).fit(X, y)
    tm = GBLinear(device="cpu", **kw).fit(X, y)
    jm.save_model(str(tmp_path / "jax.model"))
    tm.save_model(str(tmp_path / "port.model"))
    from_jax = GBLinear.load_model(str(tmp_path / "jax.model"), device="cpu")
    from_port = JaxGBLinear.load_model(str(tmp_path / "port.model"))
    np.testing.assert_array_equal(from_jax.weights, jm.weights)
    assert from_jax.bias == jm.bias and from_port.bias == tm.bias
    np.testing.assert_array_equal(from_port.weights, tm.weights)
    assert from_jax.param.to_dict() == jm.param.to_dict()
    for a, b in ((from_jax, jm), (tm, from_port)):
        np.testing.assert_allclose(a.predict(X, output_margin=True),
                                   b.predict(X, output_margin=True),
                                   rtol=1e-6, atol=1e-6)
    # the same weights through both writers: the same bytes
    tm.save_model(str(tmp_path / "again.model"))
    from_port.save_model(str(tmp_path / "jax_again.model"))
    assert ((tmp_path / "again.model").read_bytes()
            == (tmp_path / "jax_again.model").read_bytes())


def test_fit_ps_waits_for_the_kvstore():
    """``fit_ps`` over the port's dist_async KVStore (an in-process
    scheduler and server): the finalized weights are the fleet's, and
    ``predict`` on them is the dense margin."""
    import threading

    from dmlc_core_tpu_torch.parallel.kvstore import DistAsyncKVStore
    from dmlc_core_tpu_torch.parallel.ps import (PSClient, PSScheduler,
                                                 PSServer)

    X, yc = _problem(n=400, F=5)
    y = (yc > 0.3).astype(np.float32)
    sched = PSScheduler("127.0.0.1", nworker=1, nserver=1)
    sched.start()
    server = PSServer("127.0.0.1", sched.port)
    server.start()
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    kv = DistAsyncKVStore(PSClient(root_uri="127.0.0.1",
                                   root_port=sched.port, rank=0),
                          learning_rate=0.5)
    m = GBLinear(device="cpu", reg_lambda=0.0)
    m.fit_ps(ArrayRowIter(X, y, page_rows=128), kv, batch_rows=64,
             n_epochs=3)
    w = kv.pull_sparse("gblinear", np.arange(6, dtype=np.int64))
    kv.close()
    th.join(timeout=30)
    sched.join(timeout=30)
    assert m.weights.tobytes() == w[:-1].tobytes() and m.bias == float(w[-1])
    np.testing.assert_allclose(m.predict(X, output_margin=True),
                               X @ m.weights + np.float32(m.bias),
                               rtol=1e-5, atol=1e-5)
    acc = ((m.predict(X) > 0.5) == (y > 0.5)).mean()
    assert acc > 0.7, acc
    with pytest.raises(Error):
        GBLinear(device="cpu").fit_ps(
            ArrayRowIter(np.zeros((4, 0), np.float32),
                         np.zeros(4, np.float32)), kv=None)


@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16"])
def test_two_ranks_match_one_process(feature_dtype, tmp_path):
    X, yc = _problem(n=2001, F=6)
    y = (yc > 0.3).astype(np.float32)
    weight = np.random.default_rng(4).uniform(0, 2, len(y)).astype(
        np.float32)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    np.save(tmp_path / "w.npy", weight)
    params = dict(n_rounds=30, feature_dtype=feature_dtype, reg_alpha=0.5)
    launch({"X": str(tmp_path / "X.npy"), "y": str(tmp_path / "y.npy"),
            "weight": str(tmp_path / "w.npy"), "backend": "gloo",
            "device": "cpu", "params": params,
            "runs": [{"name": "lin", "model": "gblinear"}],
            "out": str(tmp_path / "out")}, world=2, timeout=120)
    one = GBLinear(device="cpu", **params).fit(X, y, weight=weight)
    for r in range(2):
        two = GBLinear.load_model(str(tmp_path / "out" / f"lin.{r}.model"),
                                  device="cpu")
        np.testing.assert_allclose(two.weights, one.weights, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(two.bias, one.bias, rtol=RTOL, atol=ATOL)


def test_chip_smoke_criteo_rows_match_gen_libsvm(tmp_path, monkeypatch):
    """``chip_smoke.criteo_like`` (the ``linear`` phase's rows) against
    the text of the compiled ``cpp/gen_libsvm.cc`` on the same seed:
    labels and values bit for bit, absent entries 0."""
    import shutil
    import subprocess

    import chip_smoke

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build cpp/gen_libsvm.cc")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    exe, out = tmp_path / "gen_libsvm", tmp_path / "rows.libsvm"
    subprocess.run([cxx, "-O2", "-o", str(exe),
                    os.path.join(root, "cpp", "gen_libsvm.cc")], check=True)
    n, F, seed = 3000, 39, 7
    subprocess.run([str(exe), str(n), str(F), str(out), str(seed)],
                   check=True, capture_output=True)
    want_X = np.zeros((n, F), np.float32)
    want_y = np.zeros(n, np.float32)
    with open(out) as f:
        for i, line in enumerate(f):
            label, *feats = line.split()
            want_y[i] = float(label)
            for tok in feats:
                j, v = tok.split(":")
                want_X[i, int(j)] = np.float32(float(v))
    assert i == n - 1
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    X, y = chip_smoke.criteo_like(torch, np, n, F, seed, block=1024)
    np.testing.assert_array_equal(y.view(np.uint32), want_y.view(np.uint32))
    np.testing.assert_array_equal(X.view(np.uint32), want_X.view(np.uint32))
    assert (X == 0).mean() > 0.03 and 0.2 < y.mean() < 0.8
