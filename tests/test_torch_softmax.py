"""``multi:softmax`` in the port against the JAX package, on the CPU.

* ``_Softmax.grad_hess`` within 1e-6 of JAX's on the same ``[n, K]``
  margins (JAX's softmax is f32, the port's f64 rounded once, so that
  the CPU and the GPU agree), ``transform``/``prob`` likewise, and
  ``mlogloss``/``merror`` within 1e-6;
* fits of K = 3 and 7 classes meet parity level (b)
  (tests/_torch_parity.py; past the near ties where they part, from the
  port's trees up to each, loaded into both packages): K trees a round, stacked ``[K, ...]`` per
  round in the file, margins ``[n, K]``; also with NaN (missing mode per
  class) and with lossguide; ``predict`` (argmax classes) equal and
  ``predict_proba`` within 1e-5;
* model files cross-load both ways (parity level (c)), ``predict_leaf``
  ``[n, T, K]``;
* an eval set scores ``mlogloss``/``merror`` as JAX's does;
* the refusals (``num_class`` rules, labels out of range) have JAX's
  messages.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import (  # noqa: E402
    assert_level_b, assert_level_b_through)
from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.models.gbt_objectives import (  # noqa: E402
    EVAL_METRICS as JAX_METRICS, OBJECTIVES as JAX_OBJECTIVES)
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models.gbt_objectives import (  # noqa: E402
    EVAL_METRICS, OBJECTIVES)

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

KW = dict(n_trees=3, max_depth=4, n_bins=32, objective="multi:softmax")
LEVERS = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
          "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS", "DMLC_TPU_FUSED_DESCEND",
          "DMLC_FUSED_ROUND", "DMLC_TPU_BIN_BACKEND")


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in LEVERS:
        monkeypatch.delenv(k, raising=False)


def _data(n, K, F=6, seed=0, nan=False):
    """Gaussian rows, the class the bucket of a nonlinear score."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.7 * np.abs(X[:, 3])
    edges = np.quantile(z, np.linspace(0, 1, K + 1)[1:-1])
    y = np.digitize(z, edges).astype(np.float32)
    if nan:
        X[:, 1:][rng.random((n, F - 1)) < 0.1] = np.nan
        X[X[:, 0] > 1.0, 0] = np.nan
    return X, y


@pytest.mark.parametrize("K", [3, 7])
def test_grad_hess_transform_and_metrics_match_jax(K):
    rng = np.random.default_rng(K)
    m = (rng.normal(size=(4000, K)) * 3).astype(np.float32)
    y = rng.integers(0, K, 4000).astype(np.float32)
    jo, to = JAX_OBJECTIVES["multi:softmax"], OBJECTIVES["multi:softmax"]
    jg, jh = jo.grad_hess(jnp.asarray(m), jnp.asarray(y))
    tg, th_ = to.grad_hess(torch.from_numpy(m), torch.from_numpy(y))
    assert tg.dtype == th_.dtype == torch.float32 and tg.shape == (4000, K)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(th_.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6)
    assert float(th_.min()) >= np.float32(1e-6)
    np.testing.assert_array_equal(to.transform(torch.from_numpy(m)).numpy(),
                                  np.asarray(jo.transform(jnp.asarray(m))))
    np.testing.assert_allclose(to.prob(torch.from_numpy(m)).numpy(),
                               np.asarray(jo.prob(jnp.asarray(m))),
                               rtol=0, atol=1e-6)
    for name in ("mlogloss", "merror"):
        got = float(EVAL_METRICS[name][0](torch.from_numpy(m),
                                          torch.from_numpy(y)))
        want = float(JAX_METRICS[name][0](jnp.asarray(m), jnp.asarray(y)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (name, got,
                                                               want)
        assert EVAL_METRICS[name][1] == JAX_METRICS[name][1]


def _fits(K, nan=False, **extra):
    X, y = _data(1500, K, nan=nan)
    kw = dict(KW, num_class=K, **extra)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    return X, y, jm, tm


@pytest.mark.parametrize("K", [3, 7])
def test_softmax_fit_meets_level_b(K):
    X, y, jm, tm = _fits(K)
    Xv, _ = _data(2000, K, seed=5)
    for t in tm.trees:
        assert list(t) == ["feat", "gain", "leaf", "thr"]
        assert t["feat"].shape == (K, KW["max_depth"], 8)
        assert t["leaf"].shape == (K, 2 ** KW["max_depth"])
    assert tm.train_margins().shape == (len(X), K)
    assert tm.predict(Xv).dtype == np.float32
    # these fits part at near ties (ROADMAP C4): held past each parting
    # from the port's trees up to it, loaded into both packages
    jm, tm, parted = assert_level_b_through(jm, tm, X, y, Xv)[-1]
    assert parted is None
    # classes: equal wherever the margins' argmax is not a near-tie
    mj = jm.predict(Xv, output_margin=True)
    srt = np.sort(mj, axis=1)
    clear = srt[:, -1] - srt[:, -2] > 1e-4
    np.testing.assert_array_equal(tm.predict(Xv)[clear],
                                  jm.predict(Xv)[clear])
    np.testing.assert_allclose(tm.predict_proba(Xv), jm.predict_proba(Xv),
                               atol=1e-5)


def test_softmax_with_nan_meets_level_b():
    X, y, jm, tm = _fits(3, nan=True)
    assert tm._missing and tm.trees[0]["dir"].shape == (3, 4, 8)
    assert list(tm.trees[0]) == ["dir", "feat", "gain", "leaf", "thr"]
    Xv, _ = _data(2000, 3, seed=5, nan=True)
    assert assert_level_b(jm, tm, Xv, X=X)[1] is None


def test_softmax_lossguide_meets_level_b(monkeypatch):
    monkeypatch.setenv("DMLC_GROW_POLICY", "lossguide")
    monkeypatch.setenv("DMLC_MAX_LEAVES", "6")
    X, y, jm, tm = _fits(3)
    Xv, _ = _data(2000, 3, seed=5)
    assert assert_level_b(jm, tm, Xv, X=X)[1] is None


def test_softmax_files_cross_load(tmp_path):
    X, y, jm, tm = _fits(3)
    Xv, _ = _data(500, 3, seed=6)
    tm.save_model(str(tmp_path / "port.bin"))
    jm.save_model(str(tmp_path / "jax.bin"))
    j2 = JaxHistGBT.load_model(str(tmp_path / "port.bin"),
                               mesh=local_mesh(1))
    t2 = HistGBT.load_model(str(tmp_path / "jax.bin"), device="cpu")
    np.testing.assert_allclose(j2.predict_proba(Xv), tm.predict_proba(Xv),
                               atol=1e-6)
    np.testing.assert_allclose(t2.predict(Xv, output_margin=True),
                               jm.predict(Xv, output_margin=True), atol=1e-6)
    np.testing.assert_array_equal(t2.predict_leaf(Xv), jm.predict_leaf(Xv))
    assert t2.predict_leaf(Xv).shape == (len(Xv), KW["n_trees"], 3)
    # the port's re-save of JAX's file is JAX's file
    t2.save_model(str(tmp_path / "again.bin"))
    assert (tmp_path / "again.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()


@pytest.mark.parametrize("metric", ["mlogloss", "merror", ""])
def test_softmax_eval_set_matches_jax(metric):
    X, y = _data(1500, 3)
    Xv, yv = _data(600, 3, seed=7)
    kw = dict(KW, num_class=3, n_trees=5, eval_metric=metric)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw)
    tm = HistGBT(device="cpu", **kw)
    for m in (jm, tm):
        m.fit(X, y, eval_set=(Xv, yv), early_stopping_rounds=2,
              eval_every=1)
    rounds = [r for r, _ in tm.eval_history]
    assert rounds == [r for r, _ in jm.eval_history] == [1, 2, 3, 4, 5]
    assert tm.eval_metric_name == jm.eval_metric_name
    # each package's score is its own model's metric at that round
    name = metric or "mlogloss"
    for m, fn in ((tm, EVAL_METRICS[name][0]),
                  (jm, lambda a, b: JAX_METRICS[name][0](
                      jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))):
        for r, score in m.eval_history:
            want = float(fn(torch.from_numpy(np.array(
                m.predict(Xv, output_margin=True, n_trees=r))),
                torch.from_numpy(yv)))
            assert abs(score - want) <= 1e-6 * max(1.0, abs(want))
    # these fits part at near ties (ROADMAP C4).  Round r scores trees
    # 0..r-1: at each stage of the continued fits' chain, rounds up to
    # its parting tree score trees that meet level (b) and agree within
    # 1e-5; the round that adds the parting tree scores two tied trees,
    # two fits of equal quality, and agrees within 1e-3 (merror: a
    # row's class in 600, 1.7e-3, is its grain; two rows allowed)
    fit_kw = dict(eval_set=(Xv, yv), early_stopping_rounds=2, eval_every=1)
    stages = assert_level_b_through(jm, tm, X, y, Xv, **fit_kw)
    grain = 2 / len(yv) if name == "merror" else 0.0
    tight = 0
    for sj, st, parted in stages:
        assert [r for r, _ in st.eval_history] == \
            [r for r, _ in sj.eval_history]
        assert st.best_iteration == sj.best_iteration or parted is not None
        for (r, a), (_, b) in zip(st.eval_history, sj.eval_history):
            if parted is None or r <= parted:
                tight += 1
                assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (r, a, b)
            elif r == parted + 1:
                assert abs(a - b) <= max(1e-3 * max(1.0, abs(b)), grain), \
                    (r, a, b)
    assert tight >= 3, stages


def test_softmax_refusals_mirror_jax():
    X, y = _data(300, 3)

    def both(exc_msg, fn):
        with pytest.raises(JaxError, match=exc_msg):
            fn(lambda **k: JaxHistGBT(mesh=local_mesh(1), **k))
        with pytest.raises(Error, match=exc_msg):
            fn(lambda **k: HistGBT(device="cpu", **k))

    both("multi:softmax needs num_class >= 2",
         lambda make: make(objective="multi:softmax", num_class=1))
    both("num_class > 1 requires multi:softmax",
         lambda make: make(num_class=3))
    both(r"multi:softmax labels must be in \[0, 3\)",
         lambda make: make(**dict(KW, num_class=3)).fit(X, y + 1.0))
    both("eval_metric 'auc' incompatible",
         lambda make: make(objective="multi:softmax", num_class=3,
                           eval_metric="auc"))
    both("predict_proba needs a classification objective",
         lambda make: make(n_trees=1, max_depth=2, n_bins=8,
                           objective="reg:squarederror").fit(X, y)
         .predict_proba(X))
