"""``predict_leaf``, ``dump_model`` and ``feature_importances`` in the port
against the JAX package, on the CPU.

The port reads the JAX package's trees (a JAX fit's model file, loaded),
so every comparison is on the same trees and cuts: ``predict_leaf`` equal
(int32 ``[n, T]``, ``[n, T, K]`` for ``multi:softmax``), ``dump_model``
equal string for string (with and without stats, with feature names,
missing mode's ``missing=`` targets, class headers), and
``feature_importances`` equal for every ``importance_type``; the port's
own fits give its own trees' answers the same way (leaf paths that
replay its margins).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

KW = dict(n_trees=3, max_depth=3, n_bins=16)
NAMES = ["lepton_pt", "lepton_eta", "jet1_pt", "jet1_eta", "mjj", "met"]


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
              "DMLC_FEATURE_BUNDLE"):
        monkeypatch.delenv(k, raising=False)


def _data(n=1200, seed=2, nan=False, classes=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    z = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    y = (np.digitize(z, [-0.5, 0.5]) if classes else z > 0
         ).astype(np.float32)
    if nan:
        X[:, 1:][rng.random((n, 5)) < 0.1] = np.nan
        X[X[:, 0] > 1.0, 0] = np.nan
    return X, y


CASES = {"binary": {}, "nan": {"nan": True},
         "softmax": {"classes": 3}, "lossguide": {}}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    """A JAX fit and the port's load of its file, per case."""
    case = request.param
    X, y = _data(**CASES[case])
    kw = dict(KW)
    if CASES[case].get("classes"):
        kw.update(objective="multi:softmax", num_class=3)
    saved = os.environ.copy()
    if case == "lossguide":
        os.environ.update(DMLC_GROW_POLICY="lossguide", DMLC_MAX_LEAVES="5")
    try:
        jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
        own = HistGBT(device="cpu", **kw).fit(X, y)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    path = str(tmp_path_factory.mktemp(case) / "m.bin")
    jm.save_model(path)
    return case, X, jm, HistGBT.load_model(path, device="cpu"), own


def test_predict_leaf_equals_jax(pair):
    case, X, jm, tm, _ = pair
    Xv, _ = _data(700, seed=5, nan=case == "nan")
    for n_trees in (None, 2):
        want = np.asarray(jm.predict_leaf(Xv, n_trees=n_trees))
        got = tm.predict_leaf(Xv, n_trees=n_trees)
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    T = len(tm.trees)
    assert got.shape[:2] == (len(Xv), 2) and (
        got.shape[2:] == ((3,) if case == "softmax" else ()))
    assert tm.predict_leaf(Xv[:0]).shape == \
        np.asarray(jm.predict_leaf(Xv[:0])).shape
    assert tm.predict_leaf(Xv).shape[1] == T


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("names", [None, NAMES])
def test_dump_model_equals_jax(pair, with_stats, names):
    case, _, jm, tm, _ = pair
    want = jm.dump_model(with_stats=with_stats, feature_names=names)
    got = tm.dump_model(with_stats=with_stats, feature_names=names)
    assert got == want
    if case == "nan":
        assert ",missing=" in got
    if case == "softmax":
        assert "booster[0] class[2]:" in got


@pytest.mark.parametrize("importance_type", ["weight", "gain"])
def test_feature_importances_equal_jax(pair, importance_type):
    _, _, jm, tm, _ = pair
    want = np.asarray(jm.feature_importances(importance_type))
    got = tm.feature_importances(importance_type)
    assert got.dtype == want.dtype and got.shape == want.shape == (6,)
    np.testing.assert_array_equal(got, want)


def test_own_leaf_paths_replay_the_margins(pair):
    case, X, _, _, own = pair
    leaves = own.predict_leaf(X)
    margin = np.full(own._margin_shape(len(X)), own.param.base_score,
                     np.float32)
    for t, tree in enumerate(own.trees):
        if case == "softmax":
            for c in range(3):
                margin[:, c] += tree["leaf"][c][leaves[:, t, c]]
        else:
            margin += tree["leaf"][leaves[:, t]]
    np.testing.assert_array_equal(margin, own.train_margins())
    assert own.dump_model().count("booster[") == KW["n_trees"] * (
        3 if case == "softmax" else 1)


def test_introspection_refusals_mirror_jax(pair):
    _, _, jm, tm, _ = pair
    for model, exc in ((jm, JaxError), (tm, Error)):
        with pytest.raises(exc, match="unsupported importance_type"):
            model.feature_importances("cover")
        with pytest.raises(exc, match="feature_names length"):
            model.dump_model(feature_names=["a"])
