"""Eval sets and early stopping in the port against the JAX package, on
the CPU: ``fit(eval_set=, early_stopping_rounds=, eval_every=)``.

Each chunk's end scores the eval set (``eval_history``: round, score);
``best_iteration``/``best_score`` keep the best, and boosting stops at
the first chunk end ``early_stopping_rounds`` past it.  Held here, on
tests/test_models.py's problems:

* the same chunk ends, stop round and ``best_iteration`` as JAX, and the
  scores within rtol 1e-5 (the two packages' margins differ by their f32
  leaf sums, tests/test_torch_histgbt.py; the port reduces a metric in
  float64, JAX in f32);
* the chunk schedule equal to JAX's over a grid of (n_trees, eval_every,
  ``DMLC_TPU_ROUNDS_PER_DISPATCH``);
* AUC with ties equal to JAX's ``_metric_auc`` (midranks: every sum is
  exact in both), and each metric within rtol 1e-6 of JAX's;
* the early-stopping state through the model file, both ways;
* JAX's refusals: a metric that does not fit the objective, early
  stopping without an eval set, NaN in the eval set of a model not in
  missing mode.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.models import histgbt as jhg  # noqa: E402
from dmlc_core_tpu.models.gbt_objectives import (  # noqa: E402
    EVAL_METRICS as JAX_METRICS)
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models import histgbt as thg  # noqa: E402
from dmlc_core_tpu_torch.models.gbt_objectives import (  # noqa: E402
    EVAL_METRICS, _metric_auc)

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

KW = dict(n_trees=200, max_depth=3, n_bins=32, learning_rate=0.5)


@pytest.fixture(autouse=True)
def _levers(monkeypatch):
    for k in ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_FUSED_ROUND",
              "DMLC_TPU_ROUNDS_PER_DISPATCH"):
        monkeypatch.delenv(k, raising=False)


def _data(n, F=6, seed=0):
    """tests/test_models.py's TestHistGBT._data / TestEvalMetrics._data."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2] > 0).astype(np.float32)
    return X, y


def _mnar(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    X[X[:, 0] > 0, 0] = np.nan
    return X, y


def _fit_both(X, y, Xv, yv, es, fit_kw=None, **kw):
    fit_kw = dict(fit_kw or {})
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(
        X, y, eval_set=(Xv, yv), early_stopping_rounds=es, **fit_kw)
    tm = HistGBT(device="cpu", **kw).fit(
        X, y, eval_set=(Xv, yv), early_stopping_rounds=es, **fit_kw)
    return jm, tm


def _same_curve(jm, tm):
    assert tm.eval_metric_name == jm.eval_metric_name
    assert [r for r, _ in tm.eval_history] == [r for r, _ in jm.eval_history]
    np.testing.assert_allclose([s for _, s in tm.eval_history],
                               [s for _, s in jm.eval_history], rtol=1e-5)
    assert len(tm.trees) == len(jm.trees)           # the same stop round
    assert tm.best_iteration == jm.best_iteration
    np.testing.assert_allclose(tm.best_score, jm.best_score, rtol=1e-5)
    assert tm._early_stopped == jm._early_stopped


@pytest.mark.parametrize("k", ["5", "25"])
def test_early_stopping_matches_jax(k, monkeypatch):
    # tests/test_models.py::test_early_stopping, at chunks of 5 and at the
    # default 25
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", k)
    X, y = _data(4000)
    Xv, yv = _data(2000, seed=9)
    jm, tm = _fit_both(X, y, Xv, yv, 10, **KW)
    _same_curve(jm, tm)
    assert len(tm.trees) < 200                       # stopped early
    assert tm.eval_metric_name == "loss"
    np.testing.assert_array_equal(
        tm.predict(Xv, output_margin=True),
        tm.predict(Xv, output_margin=True, n_trees=tm.best_iteration + 1))
    np.testing.assert_allclose(tm.predict(Xv), jm.predict(Xv), atol=1e-5)


def test_early_stop_state_survives_save_load(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", "5")
    X, y = _data(4000)
    Xv, yv = _data(2000, seed=9)
    jm, tm = _fit_both(X, y, Xv, yv, 10, **KW)
    tm.save_model(str(tmp_path / "torch.bin"))
    jm.save_model(str(tmp_path / "jax.bin"))
    for back, ref in ((HistGBT.load_model(str(tmp_path / "torch.bin"),
                                          device="cpu"), tm),
                      (JaxHistGBT.load_model(str(tmp_path / "torch.bin"),
                                             mesh=local_mesh(1)), tm),
                      (HistGBT.load_model(str(tmp_path / "jax.bin"),
                                          device="cpu"), jm)):
        assert back.best_iteration == ref.best_iteration
        assert back.best_score == ref.best_score
        assert back._early_stopped
        np.testing.assert_array_equal(back.predict(Xv, output_margin=True),
                                      ref.predict(Xv, output_margin=True))


@pytest.mark.parametrize("metric", ["auc", "error", "logloss"])
def test_metric_early_stopping_matches_jax(metric, monkeypatch):
    # tests/test_models.py::test_auc_early_stopping_maximizes and
    # ::test_error_metric
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", "5")
    X, y = _data(4000, seed=0)
    Xv, yv = _data(2000, seed=9)
    jm, tm = _fit_both(X, y, Xv, yv, 10, **dict(KW, n_trees=150,
                                                eval_metric=metric))
    _same_curve(jm, tm)
    if metric == "auc":
        assert 0.9 < tm.best_score <= 1.0
        # maximised: the best is the curve's largest
        assert tm.best_score == max(s for _, s in tm.eval_history)


def test_regression_metrics_match_jax(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", "4")
    X, _ = _data(2000, seed=2)
    Xv, _ = _data(800, seed=3)
    y = X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
    yv = Xv[:, 0] + 0.5 * Xv[:, 1] * Xv[:, 2]
    for metric in ("rmse", "mae", ""):
        jm, tm = _fit_both(X, y, Xv, yv, 3, **dict(
            n_trees=40, max_depth=3, n_bins=32, learning_rate=0.3,
            objective="reg:squarederror", eval_metric=metric))
        _same_curve(jm, tm)


def test_eval_set_early_stopping_with_nan(monkeypatch):
    # tests/test_models.py::test_eval_set_early_stopping_with_nan
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", "1")
    Xm, y = _mnar(1200, 5)
    jm, tm = _fit_both(Xm[:900], y[:900], Xm[900:], y[900:], 5,
                       n_trees=10, max_depth=3, n_bins=32,
                       eval_metric="logloss")
    assert tm._missing and tm.best_score is not None
    _same_curve(jm, tm)
    assert len(tm.eval_history) == len(tm.trees)      # a score a round


def test_eval_every_sets_the_chunk_ends(monkeypatch):
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", "25")
    X, y = _data(1500, seed=4)
    Xv, yv = _data(500, seed=5)
    jm, tm = _fit_both(X, y, Xv, yv, 0, fit_kw={"eval_every": 7},
                       n_trees=30, max_depth=3, n_bins=32)
    # the chunk ends are JAX's; the scores are the port's own model's
    # (trees 11 and 24 take a threshold of a tie — an empty bin between
    # two cuts — that JAX's f32 sums place one bin over, parity level
    # (b), which moves a few eval rows)
    assert [r for r, _ in tm.eval_history] == [7, 14, 21, 28, 30]
    assert [r for r, _ in jm.eval_history] == [7, 14, 21, 28, 30]
    for r, score in tm.eval_history:
        m = torch.from_numpy(tm.predict(Xv, output_margin=True, n_trees=r))
        assert score == float(tm._obj.eval_loss(m, torch.from_numpy(yv)))
    assert not tm._early_stopped and len(tm.trees) == 30
    assert tm.best_iteration == 29


@pytest.mark.parametrize("k_env", [1, 3, 25, 64])
def test_rounds_schedule_matches_jax(k_env, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", str(k_env))
    for n_trees in (1, 5, 7, 24, 25, 26, 100, 149):
        for eval_every in (0, 1, 2, 5, 7, 12, 25, 50):
            assert thg._rounds_schedule(n_trees, eval_every) == \
                jhg._rounds_schedule(n_trees, eval_every), (n_trees,
                                                            eval_every)


def test_auc_with_ties_equals_jax():
    rng = np.random.default_rng(3)
    for n, levels in ((500, 7), (2000, 40), (6, 1)):
        y = (rng.random(n) > 0.4).astype(np.float32)
        s = (rng.integers(0, levels, n) * 0.25 + y * 0.3).astype(np.float32)
        want = float(jhg._metric_auc(jnp.asarray(s), jnp.asarray(y)))
        got = float(_metric_auc(torch.from_numpy(s), torch.from_numpy(y)))
        assert got == want, (n, got, want)
    # all tied: 0.5; a single class: 0.5, not NaN
    z = torch.zeros(6)
    assert float(_metric_auc(z, torch.tensor([1., 1, 1, 0, 0, 0]))) == 0.5
    assert float(_metric_auc(z, torch.ones(6))) == 0.5


@pytest.mark.parametrize("name", sorted(EVAL_METRICS))
def test_each_metric_matches_jax(name):
    rng = np.random.default_rng(len(name))
    multi = name in ("mlogloss", "merror")       # [n, K] margins, labels
    m = rng.normal(size=(3000, 3) if multi else 3000).astype(np.float32)
    y = ((rng.random(3000) > 0.5) if name in ("auc", "error", "logloss")
         else rng.integers(0, 3, 3000) if multi
         else rng.normal(size=3000)).astype(np.float32)
    fn, maximize = EVAL_METRICS[name]
    jfn, jmax = JAX_METRICS[name]
    assert maximize == jmax
    got = fn(torch.from_numpy(m), torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got),
                               float(jfn(jnp.asarray(m), jnp.asarray(y))),
                               rtol=1e-6)


def test_eval_refusals_mirror_jax():
    X, y = _data(300)
    Xn = X.copy()
    Xn[0, 0] = np.nan
    cases = [
        (lambda: JaxHistGBT(eval_metric="merror"),
         lambda: HistGBT(device="cpu", eval_metric="merror")),
        (lambda: JaxHistGBT(objective="reg:squarederror", eval_metric="auc"),
         lambda: HistGBT(device="cpu", objective="reg:squarederror",
                         eval_metric="auc")),
        (lambda: JaxHistGBT(n_trees=2, max_depth=2, n_bins=16).fit(
            X, y, early_stopping_rounds=3),
         lambda: HistGBT(device="cpu", n_trees=2, max_depth=2, n_bins=16
                         ).fit(X, y, early_stopping_rounds=3)),
        (lambda: JaxHistGBT(n_trees=2, max_depth=2, n_bins=16).fit(
            X, y, eval_set=(Xn, y)),
         lambda: HistGBT(device="cpu", n_trees=2, max_depth=2, n_bins=16
                         ).fit(X, y, eval_set=(Xn, y))),
    ]
    for jax_fn, port_fn in cases:
        with pytest.raises(JaxError):
            jax_fn()
        with pytest.raises(Error):
            port_fn()


def test_fit_without_eval_set_resets_the_state():
    X, y = _data(600)
    m = HistGBT(device="cpu", n_trees=4, max_depth=2, n_bins=16)
    m.fit(X, y, eval_set=(X[:100], y[:100]), early_stopping_rounds=1)
    assert m.eval_history and m.best_iteration is not None
    m.fit_device(m.make_device_data(X, y))
    assert m.eval_history == [] and m.best_iteration is None
    assert not m._early_stopped and m.eval_metric_name is None
