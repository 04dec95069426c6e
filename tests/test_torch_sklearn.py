"""The sklearn-style wrappers (``models/sklearn.py``) in the port, against
the JAX package, on the CPU.

* ``gbtree``: the wrapped ``HistGBT`` fits held to JAX's at parity level
  (b) (``tests/_torch_parity.py``; a fit that parts at a near tie is
  held past it, ROADMAP C4), then probabilities within 1e-5 (the
  packages' softmax and sigmoid round differently), classes equal
  wherever the margins are no near tie, leaf indices equal;
* ``gblinear``: the wrapped ``GBLinear`` within ``GBLinear``'s parity
  tolerance (rtol 2e-4, atol 2e-6), probabilities within 1e-4;
* scipy CSR input: the wrapped ``SparseHistGBT`` at the sparse level (b)
  (``tests/test_torch_sparse.py``);
* ``device=`` passes through to the booster, ``cuda`` by default;
* the wrappers import and fit with scikit-learn unimportable (a
  subprocess with ``sys.modules["sklearn"] = None``).

``tests/test_sklearn_api.py`` is loaded against the port as well
(``*_port``); nothing is left out (its slow-marked tests stay slow).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import scipy.sparse as sp  # noqa: E402
from dmlc_core_tpu.models import sklearn as jsk  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models import sklearn as tsk  # noqa: E402
from _torch_parity import (assert_level_b,  # noqa: E402
                           assert_level_b_through)
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401
from test_torch_sparse import assert_sparse_level_b  # noqa: E402

torch.set_num_threads(2)

_SUITE = load_port("test_sklearn_api.py")
export(globals(), _SUITE, [
    "TestClassifier", "TestRegressor", "TestRanker", "TestWrapperCheckpoint",
    "TestSklearnComposition", "TestEvalsResult", "TestScipySparseInput"])


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def _cls_data(n=1200, F=6, seed=0, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
    if classes == 2:
        return X, np.where(s > 0, "pos", "neg")
    return X, np.digitize(s, [-0.5, 0.5]) * 10 + 3


@pytest.mark.parametrize("classes", [2, 3])
def test_gbtree_classifier_matches_jax(classes):
    X, y = _cls_data(classes=classes)
    Xv, _ = _cls_data(n=300, seed=1, classes=classes)
    kw = dict(n_estimators=6, max_depth=3, n_bins=32, learning_rate=0.4)
    je = jsk.GBTClassifier(**kw).fit(X, y)
    te = tsk.GBTClassifier(device="cpu", **kw).fit(X, y)
    np.testing.assert_array_equal(te.classes_, je.classes_)
    codes = np.searchsorted(te.classes_, y).astype(np.float32)
    # fits that part at a near tie (ROADMAP C4) are held past it from the
    # port's trees up to it, loaded into both packages
    jm, tm, parted = assert_level_b_through(je.model, te.model, X, codes,
                                            Xv)[-1]
    assert parted is None
    je._model, te._model = jm, tm
    np.testing.assert_allclose(te.predict_proba(Xv), je.predict_proba(Xv),
                               rtol=0, atol=1e-5)
    # classes: equal wherever the margins' argmax is not a near-tie
    margin = jm.predict(Xv, output_margin=True)
    if classes == 2:
        clear = np.abs(margin) > 1e-4
    else:
        srt = np.sort(margin, axis=1)
        clear = srt[:, -1] - srt[:, -2] > 1e-4
    np.testing.assert_array_equal(te.predict(Xv)[clear],
                                  je.predict(Xv)[clear])
    np.testing.assert_array_equal(te.apply(Xv), je.apply(Xv))
    np.testing.assert_allclose(te.feature_importances_,
                               je.feature_importances_, rtol=1e-4)


def test_gbtree_regressor_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(1000, 5)).astype(np.float32)
    y = (2 * X[:, 0] - X[:, 1] + 0.1 * rng.normal(size=1000)).astype(
        np.float32)
    kw = dict(n_estimators=6, max_depth=3, n_bins=32)
    je = jsk.GBTRegressor(**kw).fit(X, y)
    te = tsk.GBTRegressor(device="cpu", **kw).fit(X, y)
    _, parted = assert_level_b(je.model, te.model, X[:200], X=X, y=y)
    assert parted is None
    np.testing.assert_allclose(te.predict(X), je.predict(X), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("wrapper", ["classifier", "regressor"])
def test_gblinear_matches_jax(wrapper):
    X, y = _cls_data(n=1500, seed=4)
    kw = dict(booster="gblinear", n_estimators=30, reg_alpha=0.1)
    if wrapper == "classifier":
        je = jsk.GBTClassifier(**kw).fit(X, y)
        te = tsk.GBTClassifier(device="cpu", **kw).fit(X, y)
        np.testing.assert_allclose(te.predict_proba(X),
                                   je.predict_proba(X), rtol=1e-4,
                                   atol=1e-5)
    else:
        yr = X[:, 0] - 2 * X[:, 1]
        je = jsk.GBTRegressor(**kw).fit(X, yr)
        te = tsk.GBTRegressor(device="cpu", **kw).fit(X, yr)
        np.testing.assert_allclose(te.predict(X), je.predict(X), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(te.model.weights, je.model.weights,
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(te.feature_importances_,
                               je.feature_importances_, rtol=1e-3)


def test_sparse_route_matches_jax():
    rng = np.random.default_rng(0)
    n, F = 600, 40
    mask = rng.random((n, F)) < 0.15
    mask[:, 0] |= rng.random(n) < 0.5
    vals = rng.normal(size=(n, F)).astype(np.float32)
    y = (np.where(mask[:, 0], vals[:, 0], -0.5) > 0).astype(int)
    X = sp.csr_matrix(np.where(mask, vals, 0.0).astype(np.float32))
    kw = dict(n_estimators=5, max_depth=3, n_bins=16, learning_rate=0.4)
    je = jsk.GBTClassifier(**kw).fit(X, y)
    te = tsk.GBTClassifier(device="cpu", **kw).fit(X, y)
    csr = (X.indptr.astype(np.int64), X.indices.astype(np.int64),
           X.data.astype(np.float32), y.astype(np.float32))
    assert_sparse_level_b(je.model, te.model, csr)
    np.testing.assert_allclose(te.predict_proba(X), je.predict_proba(X),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))


def test_device_passes_through(monkeypatch):
    X, y = _cls_data(n=200)
    for booster in ("gbtree", "gblinear"):
        est = tsk.GBTClassifier(booster=booster, n_estimators=2,
                                device="cpu").fit(X, y)
        assert est.model.device.type == "cpu"
        assert est.get_params()["device"] == "cpu"
    csr = sp.csr_matrix(X)
    assert tsk.GBTRegressor(n_estimators=2, device="cpu").fit(
        csr, X[:, 0]).model.device.type == "cpu"


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.undo()     # the real resolver: None means cuda again
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _cls_data(n=100)
    for booster in ("gbtree", "gblinear"):
        with pytest.raises(Error, match="no CUDA GPU"):
            tsk.GBTClassifier(booster=booster, n_estimators=1).fit(X, y)


def test_wrappers_work_without_sklearn():
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from dmlc_core_tpu_torch.models import GBTClassifier, GBTRegressor\n"
        "from dmlc_core_tpu_torch.models import sklearn as sk\n"
        "assert sk._SkBase.__module__ == sk.__name__, sk._SkBase\n"
        "rng = np.random.default_rng(0)\n"
        "X = rng.normal(size=(300, 4)).astype(np.float32)\n"
        "y = (X[:, 0] > 0).astype(int)\n"
        "for b in ('gbtree', 'gblinear'):\n"
        "    c = GBTClassifier(booster=b, n_estimators=3, device='cpu')\n"
        "    assert c.fit(X, y).score(X, y) > 0.8\n"
        "    c.set_params(n_estimators=4)\n"
        "    assert c.get_params()['n_estimators'] == 4\n"
        "r = GBTRegressor(n_estimators=3, device='cpu').fit(X, X[:, 0])\n"
        "assert r.score(X, X[:, 0]) > 0.5\n"
        "print('OK', 'sklearn' in sys.modules and sys.modules['sklearn'])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK None" in res.stdout
