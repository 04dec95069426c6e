"""Continued training in the port, held on itself and against the JAX
package, on the CPU.

* 3 + 2 rounds write the 5-round file, byte for byte, and leave the same
  training margins, by ``fit`` on a fitted model (margins replayed from
  the trees), by ``fit_device(resume=True)`` (the carried margins) and by
  the same with the carried margins dropped (the replay on the handle),
  on plain and NaN data, sampled or not (chunks of one round, so that a
  round's draw does not depend on where a leg ends);
* a saved 3-round model, loaded and fit on, writes the 5-round file;
* the port's continued file loads in the JAX package and continues there
  to the same trees as the port continuing it (parity level (b)), and the
  reverse;
* the eval set of a continued fit counts global rounds, as JAX's;
* a resume on a packed handle without carried margins raises, as in JAX.
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

KW = dict(max_depth=4, n_bins=32)
LEVERS = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
          "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS", "DMLC_TPU_FUSED_DESCEND",
          "DMLC_FUSED_ROUND", "DMLC_TPU_BIN_BACKEND",
          "DMLC_TPU_ROUNDS_PER_DISPATCH")


@pytest.fixture(autouse=True)
def _one_round_chunks(monkeypatch):
    for k in LEVERS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", "1")


def _data(n=1500, F=6, seed=4, nan=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] + 0.5 * X[:, 2]
          - 0.8 * X[:, 3] * (X[:, 4] > 0)) > 0).astype(np.float32)
    if nan:
        X[:, 1:][rng.random((n, F - 1)) < 0.1] = np.nan
        X[X[:, 0] > 1.0, 0] = np.nan
    return X, y


def _file(model, tmp_path, name="m.bin"):
    path = str(tmp_path / name)
    model.save_model(path)
    with open(path, "rb") as f:
        return f.read()


def _extend(model, n):
    model.param.n_trees = n
    return model


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("route", ["fit", "fit_device", "replay"])
def test_three_plus_two_writes_the_five_round_file(route, nan, sampled,
                                                   tmp_path):
    X, y = _data(nan=nan)
    kw = dict(KW, subsample=0.8, colsample_bytree=0.7, seed=3) \
        if sampled else KW
    full = HistGBT(device="cpu", n_trees=5, **kw).fit(X, y)
    m = HistGBT(device="cpu", n_trees=3, **kw)
    if route == "fit":
        m.fit(X, y)
        _extend(m, 2).fit(X, y)
    else:
        dd = m.make_device_data(X, y)
        m.fit_device(dd)
        if route == "replay":
            m._train_preds = None            # a restored process's state
        _extend(m, 2).fit_device(dd, resume=True)
    assert len(m.trees) == 5 and m._missing == nan
    assert _file(_extend(m, 5), tmp_path) == _file(full, tmp_path, "f.bin")
    assert np.array_equal(m.train_margins(), full.train_margins())


def test_replayed_margins_equal_the_carried_ones():
    X, y = _data(nan=True)
    m = HistGBT(device="cpu", n_trees=3, **KW)
    dd = m.make_device_data(X, y)
    m.fit_device(dd)
    carried = m._train_preds.clone()
    m._train_preds = None
    replayed = m._resume_margin(dd)
    assert torch.equal(replayed, carried)


def test_load_model_then_fit_continues(tmp_path):
    X, y = _data()
    full = HistGBT(device="cpu", n_trees=5, **KW).fit(X, y)
    HistGBT(device="cpu", n_trees=3, **KW).fit(X, y).save_model(
        str(tmp_path / "three.bin"))
    m = HistGBT.load_model(str(tmp_path / "three.bin"), device="cpu")
    _extend(m, 2).fit(X, y)
    assert _file(_extend(m, 5), tmp_path) == _file(full, tmp_path, "f.bin")


def _same_structure(a_trees, b_trees, n_bins):
    """Parity level (b)'s structure, with its tie rule: every node's
    (feat, thr) agrees, or the two gains agree within rtol 1e-5."""
    assert len(a_trees) == len(b_trees)
    for i, (a, b) in enumerate(zip(a_trees, b_trees)):
        assert list(a) == list(b)
        differ = (a["feat"] != b["feat"]) | (a["thr"] != b["thr"])
        np.testing.assert_allclose(b["gain"][differ], a["gain"][differ],
                                   rtol=1e-5, atol=1e-6, err_msg=str(i))
        np.testing.assert_allclose(b["gain"][~differ], a["gain"][~differ],
                                   rtol=1e-4, atol=1e-5, err_msg=str(i))
        if not differ.any():
            np.testing.assert_allclose(b["leaf"], a["leaf"], rtol=1e-5,
                                       atol=1e-5, err_msg=str(i))


@pytest.mark.parametrize("nan", [False, True])
def test_continued_files_cross_load_and_continue_alike(nan, tmp_path):
    X, y = _data(nan=nan)
    # the port's 3 + 2 file, continued 2 more in each package
    m = HistGBT(device="cpu", n_trees=3, **KW).fit(X, y)
    _extend(m, 2).fit(X, y)
    m.save_model(str(tmp_path / "port.bin"))
    jm = JaxHistGBT.load_model(str(tmp_path / "port.bin"),
                               mesh=local_mesh(1))
    assert jm._missing == nan
    np.testing.assert_allclose(jm.predict(X, output_margin=True),
                               m.predict(X, output_margin=True), atol=1e-6)
    jm.fit(X, y)
    _extend(m, 2).fit(X, y)
    assert len(jm.trees) == len(m.trees) == 7
    _same_structure(jm.trees, m.trees, KW["n_bins"])
    # and the reverse: JAX's continued file, continued in the port
    j2 = JaxHistGBT(mesh=local_mesh(1), n_trees=3, **KW).fit(X, y)
    j2.param.n_trees = 2
    j2.fit(X, y)
    j2.save_model(str(tmp_path / "jax.bin"))
    t2 = HistGBT.load_model(str(tmp_path / "jax.bin"), device="cpu")
    np.testing.assert_allclose(t2.predict(X, output_margin=True),
                               j2.predict(X, output_margin=True), atol=1e-6)
    t2.fit(X, y)
    j2.fit(X, y)
    _same_structure(j2.trees, t2.trees, KW["n_bins"])
    np.testing.assert_allclose(t2.train_margins(), j2.train_margins(),
                               atol=1e-5)


def test_continued_eval_set_counts_global_rounds():
    X, y = _data()
    Xv, yv = _data(400, seed=9)
    kw = dict(KW, n_trees=3, eval_metric="logloss")
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    jm.fit(X, y, eval_set=(Xv, yv), early_stopping_rounds=2)
    tm.fit(X, y, eval_set=(Xv, yv), early_stopping_rounds=2)
    assert [r for r, _ in tm.eval_history] == \
        [r for r, _ in jm.eval_history] == [4, 5, 6]
    np.testing.assert_allclose([s for _, s in tm.eval_history],
                               [s for _, s in jm.eval_history], rtol=1e-5)
    assert tm.best_iteration == jm.best_iteration


def _packed_data(n=1200, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[:, 2] = rng.integers(0, 3, n).astype(np.float32)
    X[:, 5] = rng.integers(0, 4, n).astype(np.float32)
    return X, (X[:, 0] + X[:, 2] > 0.5).astype(np.float32)


def test_resume_on_a_packed_handle_without_margins_raises(monkeypatch):
    monkeypatch.setenv("DMLC_BIN_PACK", "1")
    X, y = _packed_data()
    msg = "resume-fit margin replay on a packed/bundled handle"
    jm = JaxHistGBT(mesh=local_mesh(1), n_trees=2, **KW)
    jdd = jm.make_device_data(X, y)
    assert jdd["layout"] is not None
    jm.fit_device(jdd)
    jm._train_preds = None
    with pytest.raises(JaxError, match=msg):
        jm.fit_device(jdd, resume=True)
    tm = HistGBT(device="cpu", n_trees=2, **KW)
    dd = tm.make_device_data(X, y)
    assert dd["layout"] is not None
    tm.fit_device(dd)
    carried = tm._train_preds
    tm._train_preds = None
    with pytest.raises(Error, match=msg):
        tm.fit_device(dd, resume=True)
    # with the carried margins the packed handle resumes
    tm._train_preds = carried
    tm.fit_device(dd, resume=True)
    assert len(tm.trees) == 4


def test_continued_fit_uses_the_plain_matrix(monkeypatch, tmp_path):
    # the levers are ignored on the continue branch (JAX's plain [F, n]
    # matrix); packing changes no byte, so the file is the unpacked one's
    X, y = _packed_data()
    ref = HistGBT(device="cpu", n_trees=4, **KW).fit(X, y)
    monkeypatch.setenv("DMLC_BIN_PACK", "1")
    m = HistGBT(device="cpu", n_trees=2, **KW).fit(X, y)
    assert m._bin_layout is not None
    _extend(m, 2).fit(X, y)
    assert m._bin_layout is None
    assert _file(_extend(m, 4), tmp_path) == _file(ref, tmp_path, "r.bin")


def test_continue_with_nan_on_a_plain_model_raises_like_jax():
    X, y = _data()
    Xn, _ = _data(nan=True)
    jm = JaxHistGBT(mesh=local_mesh(1), n_trees=2, **KW).fit(X, y)
    tm = HistGBT(device="cpu", n_trees=2, **KW).fit(X, y)
    msg = "fit \\(continued\\): X contains NaN"
    with pytest.raises(JaxError, match=msg):
        jm.fit(Xn, y)
    with pytest.raises(Error, match=msg):
        tm.fit(Xn, y)
