"""Parity level (b) proven in float64 (ROADMAP C5, C6), on the CPU.

``tests/_torch_parity.py``'s :func:`assert_level_b_f64` audits each
package's trees against float64 sums of its own inputs, within error
bounds it derives from how each package sums, and explains every node
where the two packages' splits differ as an exact tie, a
``min_child_weight`` boundary, a ``gamma`` boundary or a near tie of
last-place different inputs.

* C5: ``default_rng(0)``, X 3000 × 6, ``max_depth=9``, 2 trees.  At tree
  1, level 4, node 15 the port's split has a left child whose hessian
  sum is exactly ``min_child_weight``; JAX's f32 sums put it below, so
  JAX takes another split: the node is the ``mcw`` boundary, and the
  fits continue from the port's trees (``assert_level_b_through``);
* the ``gamma`` boundary: ``gamma`` set to one package's stored gain at
  a node where the two gains differ in the last place;
* C6's configurations, whose exact ties or gains lay outside the fixed
  tolerances the helper used before;
* the audit has teeth: a moved threshold or a leaf off by 1e-4 fails;
* mutations at the fixed tolerances' scale (the most populated leaf off
  by 2e-5 with the margins that follow; the largest level-3 gain off by
  3e-4 relative) fail the float64 audit, and fail ``assert_level_b``,
  which holds the float64 proofs AND the fixed tolerances (``fixed``,
  the default, for its callers from before the proofs).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import (  # noqa: E402
    _leaf_of, assert_level_b, assert_level_b_f64, assert_level_b_through)
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402

torch.set_num_threads(2)

LEVERS = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
          "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS", "DMLC_TPU_FUSED_DESCEND",
          "DMLC_FUSED_ROUND", "DMLC_TPU_BIN_BACKEND",
          "DMLC_TPU_ROUNDS_PER_DISPATCH")


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in LEVERS:
        monkeypatch.delenv(k, raising=False)


def _rows(seed, n=3000):
    """ROADMAP C5/C6's rows: z = x0 + 0.5·x1·x2 − 0.7·|x3| + 0.3·N(0, 1)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    z = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.7 * np.abs(X[:, 3])
         + 0.3 * rng.standard_normal(n))
    return X, z.astype(np.float32)


X, Z = _rows(0)
XV, _ = _rows(5)
Y = (Z > 0).astype(np.float32)
Y3 = np.digitize(Z, np.quantile(Z, [1 / 3, 2 / 3])).astype(np.float32)


def _fit_both(y, **kw):
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    return jm, tm


def test_c5_min_child_weight_boundary():
    kw = dict(n_trees=2, max_depth=9, n_bins=32)
    jm, tm = _fit_both(Y, **kw)
    _, parted, report = assert_level_b_f64(jm, tm, X, Y, XV)
    assert parted == 1
    assert (1, 0, 4, 15, "mcw") in report
    # the port splits feature 4 at 10 (its exact left hessian sum is
    # min_child_weight), JAX at 11
    assert (tm.trees[1]["feat"][4][15], tm.trees[1]["thr"][4][15]) == (4, 10)
    assert (jm.trees[1]["feat"][4][15], jm.trees[1]["thr"][4][15]) == (4, 11)
    stages = assert_level_b_through(jm, tm, X, Y, XV, fixed=False)
    assert stages[-1][2] in (None, 1)


def test_gamma_boundary():
    kw = dict(n_trees=2, max_depth=4, n_bins=32)
    jm, tm = _fit_both(Y, **kw)
    # a real split whose two stored gains differ in the last place
    found = None
    for t in range(len(tm.trees)):
        gj = np.asarray(jm.trees[t]["gain"])
        gp = tm.trees[t]["gain"]
        real = tm.trees[t]["thr"] < kw["n_bins"] - 1
        cand = np.argwhere(real & (gj != gp) & (gj > 0))
        if len(cand):
            lvl, i = cand[-1]
            found = (t, int(lvl), int(i),
                     float(min(gj[lvl][i], gp[lvl][i])))
            break
    assert found is not None
    t, lvl, i, gamma = found
    jm, tm = _fit_both(Y, gamma=gamma, **kw)
    _, _, report = assert_level_b_f64(jm, tm, X, Y, XV)
    assert any(r[4] == "gamma" for r in report), report


# ROADMAP C6: (params, labels, the differing nodes expected)
C6 = {
    "scale_pos_weight=3": (dict(scale_pos_weight=3.0), Y,
                           [(3, 0, 3, 7, "tie")]),
    "squarederror_base2": (dict(objective="reg:squarederror",
                                base_score=2.0), Z, [(3, 0, 3, 7, "tie")]),
    "softmax_alpha0.5": (dict(objective="multi:softmax", num_class=3,
                              reg_alpha=0.5), Y3, None),
    "base_score0.7": (dict(base_score=0.7), Y, []),
    "n_bins2": (dict(n_bins=2), Y, []),
    "n_bins3": (dict(n_bins=3), Y, []),
    "softmax_base0.5": (dict(objective="multi:softmax", num_class=3,
                             base_score=0.5), Y3, None),
}


@pytest.mark.parametrize("case", list(C6))
def test_c6_configurations_meet_level_b(case):
    extra, y, expect = C6[case]
    kw = dict(dict(n_trees=4, max_depth=4, n_bins=32), **extra)
    jm, tm = _fit_both(y, **kw)
    n_differ, parted, report = assert_level_b_f64(jm, tm, X, y, XV)
    assert parted is None
    if expect is not None:
        assert report == expect
    assert all(r[4] == "tie" for r in report), report
    assert len(assert_level_b_through(jm, tm, X, y, XV, fixed=False)) == 1


@pytest.mark.parametrize("what", ["threshold", "leaf"])
def test_audit_rejects_a_wrong_tree(what):
    kw = dict(n_trees=2, max_depth=4, n_bins=32)
    jm, tm = _fit_both(Y, **kw)
    tree = {k: v.copy() for k, v in tm.trees[1].items()}
    if what == "threshold":
        tree["thr"][1][0] = (tree["thr"][1][0] + 5) % 31
    else:
        tree["leaf"][3] += np.float32(1e-4)
    tm.trees[1] = tree
    with pytest.raises(AssertionError):
        assert_level_b_f64(jm, tm, X, Y, XV)


@pytest.mark.parametrize("what", ["leaf", "gain"])
def test_level_b_keeps_the_fixed_tolerances(what):
    kw = dict(n_trees=2, max_depth=4, n_bins=32)
    jm, tm = _fit_both(Y, **kw)
    assert assert_level_b(jm, tm, XV, X=X, y=Y)[1] is None
    tree = {k: v.copy() for k, v in tm.trees[1].items()}
    if what == "leaf":
        # the leaf holding most rows, moved at the old atol's scale, and
        # the training margins that follow from it
        bins = tm._bins_of(torch.from_numpy(X)).numpy()
        at = _leaf_of(tree, bins)
        leaf = np.bincount(at).argmax()
        tree["leaf"][leaf] += np.float32(2e-5)
        tm._train_preds = tm._train_preds.clone()
        tm._train_preds[torch.from_numpy(at == leaf)] += np.float32(2e-5)
    else:
        lvl, i = 3, int(np.argmax(tree["gain"][3]))
        assert tree["gain"][lvl][i] > 1.0
        tree["gain"][lvl][i] *= np.float32(1 + 3e-4)
    tm.trees[1] = tree
    # the float64 bounds of this well-populated node are tighter than the
    # move (elsewhere a sparse node's can be wider: the default keeps
    # the fixed tolerances too)
    with pytest.raises(AssertionError):
        assert_level_b_f64(jm, tm, X, Y, XV)
    with pytest.raises(AssertionError):
        assert_level_b(jm, tm, XV, X=X, y=Y, fixed=True)
    with pytest.raises(AssertionError):
        assert_level_b(jm, tm, XV, X=X)
