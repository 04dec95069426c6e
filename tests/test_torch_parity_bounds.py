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
    # ROADMAP C12: reg_lambda = 0 — empty children, 0/0 leaves (the
    # port's exact sums) and residue leaves (JAX's f32 sums) at slots no
    # training row reaches, held by the audit's reach rule
    "lambda0": (dict(reg_lambda=0.0), Y, None),
    "lambda0_alpha0.5_gamma0.3": (dict(reg_lambda=0.0, reg_alpha=0.5,
                                       gamma=0.3), Y, None),
    "lambda0_squarederror": (dict(objective="reg:squarederror",
                                  reg_lambda=0.0), Z, None),
    # ROADMAP C12's repro (its own rows, host binning): y None
    "lambda0_c12_repro": (dict(objective="multi:softmax", num_class=3,
                               max_depth=5, n_bins=3, reg_lambda=0.0,
                               reg_alpha=0.5, gamma=0.3,
                               min_child_weight=5.0, n_trees=3), None, None),
}


def _c12_rows(seed=0):
    """ROADMAP C12's rows: X 3000 × 4 standard normal, labels the terciles
    of x0 + 0.5·x1·x2 + N(0, 1)."""
    rng = np.random.default_rng(seed)
    Xc = rng.standard_normal((3000, 4)).astype(np.float32)
    z = Xc[:, 0] + 0.5 * Xc[:, 1] * Xc[:, 2] + rng.standard_normal(3000)
    yc = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    return Xc, yc


@pytest.mark.parametrize("case", list(C6))
def test_c6_configurations_meet_level_b(case, monkeypatch):
    extra, y, expect = C6[case]
    kw = dict(dict(n_trees=4, max_depth=4, n_bins=32), **extra)
    if y is None:
        monkeypatch.setenv("DMLC_TPU_BIN_BACKEND", "cpu")
        Xc, y = _c12_rows()
        jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(Xc, y)
        tm = HistGBT(device="cpu", **kw).fit(Xc, y)
        n_differ, parted, report = assert_level_b_f64(jm, tm, Xc, y, XV[:, :4])
        assert parted is None and report == []
        # C12 (a), open by design: the files differ only at slots no
        # training row reaches (the port's 0/0 NaN, JAX's ±0.0)
        _assert_leaves_differ_only_unreached(jm, tm, Xc)
        return
    jm, tm = _fit_both(y, **kw)
    n_differ, parted, report = assert_level_b_f64(jm, tm, X, y, XV)
    assert parted is None
    if expect is not None:
        assert report == expect
    assert all(r[4] == "tie" for r in report), report
    assert len(assert_level_b_through(jm, tm, X, y, XV, fixed=False)) == 1


def test_c12_lambda0_gamma0_parts_only_at_ties_and_gamma_boundaries():
    """λ = 0 with γ = 0: nodes whose best gain is ~0 split in one package
    and not in the other (a ``gamma`` boundary, the gains within their
    bounds of 0) or at exact ties; each parting is explained, and the fits
    continued from the port's trees stay at level (b)."""
    kw = dict(n_trees=4, max_depth=6, n_bins=3, objective="multi:softmax",
              num_class=3, reg_lambda=0.0, min_child_weight=5.0)
    jm, tm = _fit_both(Y3, **kw)
    _, parted, report = assert_level_b_f64(jm, tm, X, Y3, XV)
    assert parted == 0
    assert {r[4] for r in report} <= {"tie", "gamma"}
    assert any(r[4] == "gamma" for r in report)
    stages = assert_level_b_through(jm, tm, X, Y3, XV, fixed=False)
    assert len(stages) >= 2


def _assert_leaves_differ_only_unreached(jm, tm, Xc):
    """Where the two files' leaves are not the same number (bitwise, NaN
    never is), no training row arrives; and the port's NaN leaves are
    there too.  The leaves rows reach are the audit's to hold."""
    bins = tm._bins_of(torch.from_numpy(Xc)).numpy()
    seen_nan = False
    for ja, tb in zip(jm.trees, tm.trees):
        for c in range(tm.param.num_class):
            a = {k: np.asarray(v)[c] for k, v in ja.items()}
            b = {k: np.asarray(v)[c] for k, v in tb.items()}
            reach = np.bincount(_leaf_of(b, bins),
                                minlength=b["leaf"].shape[0]) > 0
            nan = np.isnan(b["leaf"])
            seen_nan |= bool(nan.any())
            assert not (nan & reach).any()
            assert not (np.isnan(a["leaf"]) & reach).any()
    assert seen_nan      # the repro does reach the 0/0 case


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


@pytest.mark.parametrize("value", [7.0, np.nan])
def test_audit_holds_unreached_leaves_when_lambda_positive(value):
    """With λ > 0 a slot no training row reaches is held to float64 all
    the same (its leaf is 0), and held-out rows that land there are
    compared: garbage left at such a slot fails.  Only λ = 0 frees
    those slots (C12)."""
    kw = dict(n_trees=2, max_depth=6, n_bins=32, min_child_weight=50.0)
    jm, tm = _fit_both(Y, **kw)
    assert_level_b_f64(jm, tm, X, Y, XV)
    bins = tm._bins_of(torch.from_numpy(X)).numpy()
    tree = {k: v.copy() for k, v in tm.trees[0].items()}
    reached = np.bincount(_leaf_of(tree, bins),
                          minlength=tree["leaf"].shape[0]) > 0
    assert not reached.all()
    tree["leaf"][np.flatnonzero(~reached)[0]] = np.float32(value)
    tm.trees[0] = tree
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
