"""The port's slice as a whole: ``dmlc_core_tpu_torch.HistGBT(device="cpu")``
against the JAX package's ``HistGBT``, on HIGGS-like data (bench.py's
decision rule) at a small size.

Tolerances, and why:

* tree 0 — BIT-IDENTICAL: at margin 0 every g is ±0.5 and h is 0.25, so
  every histogram sum, gain and leaf is exact in both packages;
* later trees — the same ``feat``/``thr`` everywhere, leaves at rtol 1e-5
  / atol 1e-6: the JAX CPU path sums f32 gradients in a running order,
  the port in fixed point, and the leaf of a small node is a cancelling
  sum (both stay within ~1e-6 of the float64 truth);
* predictions — atol 1e-5 on probabilities, the leaves' error summed over
  the trees.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.models.gbt_split import (  # noqa: E402
    _advance_node as jax_advance_node, _make_best_split as jax_best_split)
from dmlc_core_tpu.models.histgbt import HistGBTParam as JaxParam  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT, HistGBTParam  # noqa: E402
from dmlc_core_tpu_torch.models.gbt_split import (  # noqa: E402
    _advance_node, _make_best_split)

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

KW = dict(n_trees=4, max_depth=4, n_bins=32)


def _higgs_like(n, F=6, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    return X, (margin > 0).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return _higgs_like(2000)


@pytest.fixture(scope="module")
def fitted(data):
    X, y = data
    jm = JaxHistGBT(mesh=local_mesh(1), **KW).fit(X, y)
    tm = HistGBT(device="cpu", **KW).fit(X, y)
    return jm, tm


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_param_dict_matches_jax():
    assert HistGBTParam().to_dict() == JaxParam().to_dict()
    custom = dict(max_depth=3, learning_rate=0.1, reg_alpha=0.5,
                  objective="reg:squarederror", hist_method="pallas")
    assert HistGBTParam(**custom).to_dict() == JaxParam(**custom).to_dict()


def test_cuts_bit_equal_and_tree0_bit_identical(fitted):
    jm, tm = fitted
    assert _same_bits(tm.cuts.numpy(), jm.cuts)
    assert list(tm.trees[0]) == list(jm.trees[0])
    for key in jm.trees[0]:
        assert _same_bits(tm.trees[0][key], jm.trees[0][key]), key


def test_every_tree_same_structure(fitted):
    jm, tm = fitted
    assert len(tm.trees) == len(jm.trees) == KW["n_trees"]
    for i, (a, b) in enumerate(zip(jm.trees, tm.trees)):
        np.testing.assert_array_equal(b["feat"], a["feat"], err_msg=str(i))
        np.testing.assert_array_equal(b["thr"], a["thr"], err_msg=str(i))
        np.testing.assert_allclose(b["leaf"], a["leaf"], rtol=1e-5,
                                   atol=1e-6, err_msg=str(i))
        np.testing.assert_allclose(b["gain"], a["gain"], rtol=1e-4,
                                   atol=1e-5, err_msg=str(i))


def test_predictions_match(fitted, data):
    jm, tm = fitted
    X, _ = data
    Xv, _ = _higgs_like(500, seed=8)
    for x in (X, Xv):
        np.testing.assert_allclose(tm.predict(x), jm.predict(x), atol=1e-5)
        np.testing.assert_allclose(tm.predict(x, output_margin=True),
                                   jm.predict(x, output_margin=True),
                                   atol=1e-5)
    np.testing.assert_allclose(tm.predict_proba(Xv), jm.predict_proba(Xv),
                               atol=1e-5)
    np.testing.assert_allclose(tm.train_margins(), jm.train_margins(),
                               atol=1e-5)


def test_tree0_matches_jax_kernel_path(data, monkeypatch):
    # the JAX package's Pallas path forced on the CPU (interpret mode):
    # root histogram kernel + fused round kernel.  Tree 0's g/h are
    # bf16-exact, so its bf16 one-hot sums are exact; later trees differ
    # by that kernel's bf16 rounding of g/h and are not compared bitwise.
    X, y = data
    X, y = X[:1200], y[:1200]
    monkeypatch.setenv("DMLC_FUSED_ROUND", "1")
    kw = dict(KW, n_trees=1, max_depth=3)
    jm = JaxHistGBT(mesh=local_mesh(1), hist_method="pallas", **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    for key in jm.trees[0]:
        assert _same_bits(tm.trees[0][key], jm.trees[0][key]), key


def test_best_split_same_choice_and_first_maximum_on_ties():
    rng = np.random.default_rng(3)
    N, F, B = 4, 5, 16
    g = rng.normal(size=(N, F, B)).astype(np.float32)
    h = rng.random((N, F, B)).astype(np.float32) * 4
    # node 1: features 2 and 4 carry the same histogram -> an exact tie
    # across features; node 2: empty bins -> equal gains at thresholds
    # 3..6 of every feature (the same left sums)
    g[1, 4], h[1, 4] = g[1, 2], h[1, 2]
    g[2, :, 4:7] = 0.0
    h[2, :, 4:7] = 0.0
    hist = np.stack([g, h])
    for with_sums in (False, True):
        want = jax_best_split(B, 1.0, 0.0, 1.0, with_child_sums=with_sums)(
            jnp.asarray(hist))
        got = _make_best_split(B, 1.0, 0.0, 1.0,
                               with_child_sums=with_sums)(
            torch.from_numpy(hist))
        for w, t in zip(want, got):
            assert _same_bits(t.numpy(), w)
    feat, thr, _ = _make_best_split(B, 1.0, 0.0, 1.0)(torch.from_numpy(hist))
    assert int(feat[1]) != 4      # the first of the tied features wins


def test_advance_node_matches_jax():
    rng = np.random.default_rng(4)
    n, F, B, N = 777, 5, 32, 4
    bins_t = rng.integers(0, B, (F, n)).astype(np.uint8)
    node = rng.integers(-1, N, n).astype(np.int32)
    feat = rng.integers(0, F, N).astype(np.int32)
    thr = rng.integers(0, B, N).astype(np.int32)
    want = np.asarray(jax_advance_node(jnp.asarray(bins_t), jnp.asarray(node),
                                       jnp.asarray(feat), jnp.asarray(thr)))
    got = _advance_node(*(torch.from_numpy(a) for a in (bins_t, node, feat,
                                                       thr)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _same_predictions(a, b, X):
    """Same trees: margins bit-identical (the same f32 adds in the same
    order); probabilities within 1e-6 — the two packages' sigmoids may
    differ in the last place."""
    np.testing.assert_array_equal(a.predict(X, output_margin=True),
                                  b.predict(X, output_margin=True))
    np.testing.assert_allclose(a.predict(X), b.predict(X), rtol=0, atol=1e-6)


def test_model_files_cross_load(fitted, data, tmp_path):
    jm, tm = fitted
    X, _ = data
    jm.save_model(str(tmp_path / "jax.model"))
    tm.save_model(str(tmp_path / "torch.model"))
    from_jax = HistGBT.load_model(str(tmp_path / "jax.model"), device="cpu")
    from_torch = JaxHistGBT.load_model(str(tmp_path / "torch.model"),
                                       mesh=local_mesh(1))
    _same_predictions(from_jax, jm, X)
    _same_predictions(from_torch, tm, X)
    # mem:// streams too
    tm.save_model("mem://port/model")
    np.testing.assert_array_equal(
        HistGBT.load_model("mem://port/model", device="cpu").predict(X),
        tm.predict(X))


def test_same_weights_give_byte_identical_files(fitted, tmp_path):
    jm, _ = fitted
    # the JAX model's (param, cuts, trees) through the port's writer
    port = HistGBT.from_state({
        "param": jm.param.to_dict(), "cuts": np.asarray(jm.cuts),
        "trees": jm.trees}, device="cpu")
    jm.save_model(str(tmp_path / "a"))
    port.save_model(str(tmp_path / "b"))
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_from_state_predicts_like_jax(fitted, data):
    jm, tm = fitted
    X, _ = data
    state = {"param": jm.param.to_dict(), "cuts": np.asarray(jm.cuts),
             "trees": [dict(t) for t in jm.trees]}
    port = HistGBT.from_state(state, device="cpu")
    _same_predictions(port, jm, X)
    # a payload saved after early stopping predicts with the best prefix
    stopped = HistGBT.from_state(dict(state, best_iteration=1,
                                      early_stopped=True), device="cpu")
    np.testing.assert_array_equal(stopped.predict(X, output_margin=True),
                                  jm.predict(X, output_margin=True,
                                             n_trees=2))
    again = HistGBT.from_state(tm.to_state(), device="cpu")
    np.testing.assert_array_equal(again.predict(X), tm.predict(X))


def test_squared_error_and_l1_match_jax(data):
    X, y = data
    X, y = X[:800], X[:800, 0] + 0.5 * y[:800]
    kw = dict(KW, n_trees=2, objective="reg:squarederror", reg_alpha=0.3,
              gamma=0.05)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    for a, b in zip(jm.trees, tm.trees):
        np.testing.assert_array_equal(b["feat"], a["feat"])
        np.testing.assert_array_equal(b["thr"], a["thr"])
        np.testing.assert_allclose(b["leaf"], a["leaf"], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), atol=1e-5)


# --- parity level (b) at exact ties ------------------------------------
#
# Among partitions whose gains are equal in exact arithmetic, each package
# takes the first maximum of its own f32 gains.  JAX's histogram is an f32
# sum whose rounding depends on the order of the rows, the port's an exact
# int64 fixed-point sum, so at such a tie the two may pick different
# (feat, thr): a threshold in a gap of the node's bins (the same cut of its
# training rows), or, in a node whose rows all share a label, another
# feature at a gain near zero.  The criterion, on a setup that makes such
# ties (min_child_weight 0 lets one-row children compete):
#
# * a node whose splits agree keeps the checks above: same feat/thr, gain
#   rtol 1e-4 / atol 1e-5, and a leaf under agreeing splits rtol 1e-5 /
#   atol 1e-6;
# * a node whose splits differ has gains within TIE_RTOL / TIE_ATOL: the
#   two gains are one real number at a tie, each from f32 sums of at most
#   3000 weighted rows, whose order-dependent rounding moves a gain by a
#   few ulp of the parent's score (measured: 1.2e-6 at gains up to 0.82,
#   ~4e-12 near zero);
# * the margins of the training rows agree within 1e-5, as in
#   test_predictions_match: differing splits cut the training rows alike,
#   or differ only between children with the same leaf;
# * a held-out row whose path in neither model crosses a differing node
#   has the same margin, within 1e-5.
TIE_RTOL = 1e-5
TIE_ATOL = 1e-6
TIE_KW = dict(n_trees=4, max_depth=6, n_bins=256)


def _tie_data():
    """X [3000, 5] normal, noise, weights U(0.1, 1.1) from one generator,
    y = X0 + 0.5·X1² + 0.3·noise > 0.6."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3000, 5)).astype(np.float32)
    noise = rng.normal(size=3000)
    w = rng.uniform(0.1, 1.1, 3000).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.3 * noise) > 0.6)
    return X, y.astype(np.float32), w


def _paths(tree, bins_t):
    """Each row's node at every level, ``[depth + 1, n]`` (the last row the
    leaf), routed by the port's ``_advance_node`` (held equal to JAX's
    above)."""
    node = torch.zeros(bins_t.shape[1], dtype=torch.int32)
    out = [node]
    for lvl in range(tree["feat"].shape[0]):
        node = _advance_node(bins_t, node,
                             torch.tensor(np.asarray(tree["feat"][lvl])),
                             torch.tensor(np.asarray(tree["thr"][lvl])))
        out.append(node)
    return torch.stack(out).numpy()


@pytest.mark.parametrize("min_child_weight", [0.0, 1.0])
def test_tied_splits_equal_gains_and_training_cuts(min_child_weight):
    X, y, w = _tie_data()
    kw = dict(TIE_KW, min_child_weight=min_child_weight)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y, weight=w)
    tm = HistGBT(device="cpu", **kw).fit(X, y, weight=w)
    assert _same_bits(tm.cuts.numpy(), jm.cuts)
    Xv = np.random.default_rng(99).normal(size=(20000, 5)).astype(np.float32)
    cuts = tm.cuts
    from dmlc_core_tpu_torch.ops.quantile import apply_bins
    bins_v = apply_bins(torch.from_numpy(Xv), cuts)
    depth = TIE_KW["max_depth"]
    crosses = np.zeros(len(Xv), bool)
    n_differ = 0
    for t, (a, b) in enumerate(zip(jm.trees, tm.trees)):
        fa, ta, ga = (np.asarray(a[k]) for k in ("feat", "thr", "gain"))
        fb, tb, gb = (np.asarray(b[k]) for k in ("feat", "thr", "gain"))
        # level l holds 2^l nodes; the rest of its row is padding
        live = np.arange(fa.shape[1])[None, :] < 2 ** np.arange(depth)[:, None]
        differ = live & ((fa != fb) | (ta != tb))
        agree = live & ~differ
        n_differ += int(differ.sum())
        np.testing.assert_allclose(gb[agree], ga[agree], rtol=1e-4,
                                   atol=1e-5, err_msg=f"tree {t}")
        np.testing.assert_allclose(gb[differ], ga[differ], rtol=TIE_RTOL,
                                   atol=TIE_ATOL, err_msg=f"tree {t}")
        # a leaf under splits that all agree: rtol 1e-5
        clean = np.ones(2 ** depth, bool)
        for lvl in range(depth):
            bad = np.flatnonzero(differ[lvl])
            span = 2 ** (depth - lvl)
            for i in bad:
                clean[i * span:(i + 1) * span] = False
        np.testing.assert_allclose(np.asarray(b["leaf"])[clean],
                                   np.asarray(a["leaf"])[clean], rtol=1e-5,
                                   atol=1e-6, err_msg=f"tree {t}")
        for tree in (a, b):
            p = _paths(tree, bins_v)
            for lvl in range(depth):
                crosses |= differ[lvl][p[lvl]]
    if min_child_weight == 1.0:
        assert n_differ <= 2
    np.testing.assert_allclose(tm.train_margins(), jm.train_margins(),
                               atol=1e-5)
    same = ~crosses
    # the check has teeth: most rows (97.9% at min_child_weight 0) take
    # only agreeing nodes
    assert same.mean() > 0.9
    np.testing.assert_allclose(tm.predict(Xv[same], output_margin=True),
                               jm.predict(Xv[same], output_margin=True),
                               atol=1e-5)
