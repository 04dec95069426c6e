"""NaN-as-missing mode in the port against the JAX package, on the CPU.

NaN means missing: the first NaN of the training data puts a model in
missing mode — cuts ``[F, n_bins-2]`` over the finite values, NaN in the
reserved bin ``n_bins-1``, a learned direction per node (``dir``, 1 =
missing rows go left).  Held here, module by module, then whole:

* cuts and bins — BIT-EQUAL (integer work and the same f32 arithmetic),
  weighted and not, with the W-rank merge of a shard all-NaN for a
  feature and the finite ramp of a feature all-NaN everywhere;
* the split chooser on order-exact histograms (cells that are multiples
  of 0.5: every cumulative sum exact in both packages) — ``feat``,
  ``thr`` and ``dir`` equal, gains within rtol 1e-5 / atol 1e-6, child
  sums equal;
* the descend with a direction — ``new_node`` equal and the left-child
  histograms bit-equal on order-exact g/h, per node and per row;
* whole fits — the same trees (``feat``, ``thr``, ``dir``), leaves within
  rtol 1e-5 / atol 1e-5 and predictions within atol 1e-5, under the
  level-(b) criterion at exact ties (tests/test_torch_histgbt.py).  The
  leaves' atol is that of tests/test_torch_data_parallel.py's later
  trees: JAX sums real gradients in f32 in row order, the port exactly
  (one rounding), and in tree 4 of the MNAR fit a leaf of 734 rows comes
  out 0.3443476 in JAX, 0.3443532 in the port, whose value the float64
  sum of the same rows' gradients gives to the last place; model
  files that cross-load both ways; JAX's refusals; the mode's
  stickiness; the levers that leave the file unchanged.
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
from dmlc_core_tpu.models.gbt_split import (  # noqa: E402
    _host_bin_t as jax_host_bin_t, _make_best_split as jax_best_split)
from dmlc_core_tpu.ops import histogram as jh  # noqa: E402
from dmlc_core_tpu.ops import quantile as jq  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models.gbt_split import (  # noqa: E402
    _advance_node, _host_bin_t, _make_best_split)
from dmlc_core_tpu_torch.models.histgbt import _predict_trees  # noqa: E402
from dmlc_core_tpu_torch.ops import histogram as th  # noqa: E402
from dmlc_core_tpu_torch.ops import quantile as tq  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

LEVERS = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
          "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS", "DMLC_TPU_FUSED_DESCEND",
          "DMLC_FUSED_ROUND", "DMLC_TPU_BIN_BACKEND")


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in LEVERS:
        monkeypatch.delenv(k, raising=False)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _mnar_problem(n=1500, seed=0):
    """tests/test_models.py's MNAR problem: feature 0 is NaN exactly where
    it is positive, which is where y is 1."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    Xm = X.copy()
    mask = X[:, 0] > 0
    Xm[mask, 0] = np.nan
    return X, Xm, y, mask


def _higgs_nan(n, F=6, seed=7):
    """HIGGS-like rows (tests/test_torch_histgbt.py's rule) with NaN as
    chip_smoke.py's missing phase sets it: 10% of each of features 1.. at
    random, and feature 0 wherever it exceeds 1.0."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    y = (margin > 0).astype(np.float32)
    Xm = X.copy()
    Xm[:, 1:][rng.random((n, F - 1)) < 0.1] = np.nan
    Xm[X[:, 0] > 1.0, 0] = np.nan
    return Xm, y


# --- cuts and bins -----------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n_bins", [2, 15, 63, 255])
def test_missing_cuts_and_bins_bit_equal(weighted, n_bins):
    # n_bins value bins (a model of n_bins + 1 bins): cuts [F, n_bins-1],
    # NaN in bin n_bins
    rng = np.random.default_rng(n_bins)
    X = rng.normal(size=(2000, 5)).astype(np.float32)
    X[:, 3] = np.round(X[:, 3])                     # atoms
    X[rng.random(X.shape) < 0.15] = np.nan
    X[:1900, 4] = np.nan                            # a mostly-NaN feature
    w = rng.uniform(0.1, 2.0, 2000).astype(np.float32) if weighted else None
    want = np.asarray(jq.compute_cuts(X, n_bins, weight=w, missing=True))
    got = tq.compute_cuts(torch.from_numpy(X), n_bins,
                          weight=None if w is None else torch.from_numpy(w),
                          missing=True).numpy()
    assert _same_bits(got, want)
    assert np.isfinite(got).all()
    miss_bin = n_bins
    jb = np.asarray(jq.apply_bins_missing(jnp.asarray(X), jnp.asarray(want),
                                          miss_bin)).T
    tb = tq.apply_bins_missing(torch.from_numpy(X), torch.from_numpy(got),
                               miss_bin).numpy()
    assert _same_bits(tb, jb)
    assert (tb[np.isnan(X.T)] == miss_bin).all()
    assert _same_bits(_host_bin_t(X, got, missing=True), jb)
    assert _same_bits(jax_host_bin_t(X, want, missing=True), jb)


def test_missing_all_nan_on_one_shard_merges_like_jax():
    # tests/test_models.py::test_missing_all_nan_on_one_shard: a feature
    # all-NaN on one of W=2 workers still gets finite cuts, those of the
    # worker that saw it
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(500, 3)).astype(np.float32)
    x0[:, 1] = np.nan
    x1 = rng.normal(size=(500, 3)).astype(np.float32)
    s0 = tq.local_summary(torch.from_numpy(x0), None, 128, True)
    s1 = tq.local_summary(torch.from_numpy(x1), None, 128, True)
    j0 = jq.local_summary(jnp.asarray(x0), None, 128, True)
    j1 = jq.local_summary(jnp.asarray(x1), None, 128, True)
    assert _same_bits(s0.numpy(), j0) and _same_bits(s1.numpy(), j1)
    assert np.isnan(s0.numpy()[1]).all()             # the sentinel row
    cuts = tq.merge_summaries(torch.stack([s0, s1]), 16).numpy()
    assert _same_bits(cuts, jq.merge_summaries(jnp.stack([j0, j1]), 16))
    assert np.isfinite(cuts).all() and (np.diff(cuts, axis=1) > 0).all()
    solo = tq.merge_summaries(s1[None], 16).numpy()
    np.testing.assert_allclose(cuts[1], solo[1], rtol=1e-6)

    def gather(s):
        return np.stack([s0.numpy(), s])

    got = tq.compute_cuts(torch.from_numpy(x1), 16, n_summary=128,
                          allgather_fn=gather, missing=True).numpy()
    want = jq.compute_cuts(x1, 16, n_summary=128, missing=True,
                           allgather_fn=lambda s: np.stack([np.asarray(j0),
                                                            s]))
    assert _same_bits(got, want)


def test_missing_all_nan_everywhere_gives_the_ramp():
    rng = np.random.default_rng(1)
    x = np.full((50, 2), np.nan, np.float32)
    x[:, 0] = rng.normal(size=50)
    s = tq.local_summary(torch.from_numpy(x), None, 64, True)
    cuts = tq.merge_summaries(s[None], 8).numpy()
    want = jq.merge_summaries(jq.local_summary(jnp.asarray(x), None, 64,
                                               True)[None], 8)
    assert _same_bits(cuts, want)
    assert np.isfinite(cuts).all() and (np.diff(cuts, axis=1) > 0).all()
    np.testing.assert_allclose(cuts[1], np.arange(7), rtol=1e-5)


# --- split chooser -----------------------------------------------------

def _exact_hist(seed, N=6, F=4, B=16):
    """[2, N, F, B] histograms whose cells are multiples of 0.5 (every sum
    exact): node 0 has no missing mass, node 1's missing mass wants to go
    left, node 2 is empty (degenerate), node 3 holds only missing rows in
    feature 2, the rest random."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 12, (N, F, B)).astype(np.float32)
    g = rng.integers(-6, 7, (N, F, B)).astype(np.float32) * 0.5
    h = cnt * 0.5 + (cnt > 0) * 0.5
    g = np.where(cnt > 0, g, 0.0).astype(np.float32)
    # every feature of a node sees the same rows: equal totals
    tg, th_ = g[:, :1].sum(-1, keepdims=True), h[:, :1].sum(-1, keepdims=True)
    g[:, 1:, -1] += (tg - g[:, 1:].sum(-1, keepdims=True))[:, :, 0]
    h[:, 1:, -1] += (th_ - h[:, 1:].sum(-1, keepdims=True))[:, :, 0]
    h = np.abs(h)
    g[0, :, -1] = 0.0
    h[0, :, -1] = 0.0
    g[1, :, -1] = -8.0
    g[1, :, : B // 2] = np.abs(g[1, :, : B // 2]) * -1.0
    g[2] = 0.0
    h[2] = 0.0
    g[3, 2, :-1] = 0.0
    h[3, 2, :-1] = 0.0
    return np.stack([g, h]).astype(np.float32), B


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mcw,gamma,alpha", [(1.0, 0.0, 0.0),
                                             (0.0, 0.1, 0.0),
                                             (2.0, 0.0, 0.5)])
def test_missing_best_split_matches_jax(seed, mcw, gamma, alpha):
    hist, B = _exact_hist(seed)
    for with_sums in (False, True):
        want = jax_best_split(B, 1.0, gamma, mcw, with_child_sums=with_sums,
                              missing=True, alpha=alpha)(jnp.asarray(hist))
        got = _make_best_split(B, 1.0, gamma, mcw, with_child_sums=with_sums,
                               missing=True, alpha=alpha)(
            torch.from_numpy(hist))
        assert len(got) == len(want) == (6 if with_sums else 4)
        for i in (0, 1, 2):                          # feat, thr, dir
            assert _same_bits(got[i].numpy(), want[i]), i
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=1e-5, atol=1e-6)
        if with_sums:
            for i in (4, 5):                         # child g/h sums
                assert _same_bits(got[i].numpy(), want[i]), i
    feat, thr, dirv, _ = _make_best_split(B, 1.0, gamma, mcw, missing=True,
                                          alpha=alpha)(torch.from_numpy(hist))
    assert int(thr[2]) == B - 1 and int(dirv[2]) == 1   # degenerate node


def test_missing_split_without_missing_mass_is_the_plain_split():
    hist, B = _exact_hist(4)
    hist[:, :, :, -1] = 0.0
    plain = _make_best_split(B, 1.0, 0.0, 1.0)(torch.from_numpy(hist))
    miss = _make_best_split(B, 1.0, 0.0, 1.0, missing=True)(
        torch.from_numpy(hist))
    for a, b in zip(plain, (miss[0], miss[1], miss[3])):
        assert torch.equal(a, b)


# --- the descend with a direction --------------------------------------

@pytest.mark.parametrize("n_prev", [1, 2, 4, 8])
@pytest.mark.parametrize("fuse", [False, True])
def test_descend_with_direction_matches_jax(n_prev, fuse):
    B, F, n = 32, 5, 3001
    rng = np.random.default_rng(n_prev)
    bins_t = rng.integers(0, B - 1, (F, n)).astype(np.uint8)
    bins_t[rng.random((F, n)) < 0.2] = B - 1          # the NaN bin
    node = rng.integers(0, n_prev, n).astype(np.int32)
    node[rng.random(n) < 0.05] = -1
    feat = rng.integers(0, F, n_prev).astype(np.int32)
    thr = rng.integers(0, B - 1, n_prev).astype(np.int32)
    dirv = rng.integers(0, 2, n_prev).astype(np.int32)
    g = rng.choice(np.array([-1.0, -0.5, 0.5, 1.0], np.float32), n)
    h = rng.choice(np.array([0.5, 1.0], np.float32), n)
    safe = np.maximum(node, 0)
    jl, jn = jh.fused_descend_histogram(
        jnp.asarray(bins_t), jnp.asarray(node), jnp.asarray(feat[safe]),
        jnp.asarray(thr[safe]), jnp.asarray(g), jnp.asarray(h), n_prev, B,
        fuse=fuse, dir_sel=jnp.asarray(dirv[safe]), miss_bin=B - 1)
    t = torch.from_numpy
    for by_node in (True, False):
        tabs = ((feat, thr, dirv) if by_node
                else (feat[safe], thr[safe], dirv[safe]))
        tl, tn = th.fused_descend_histogram(
            t(bins_t), t(node), t(tabs[0]), t(tabs[1]), t(g), t(h), n_prev,
            B, fuse=fuse, dir_sel=t(tabs[2]), miss_bin=B - 1,
            by_node=by_node)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert _same_bits(tl.numpy(), jl)
    # the direction routes: rows in the NaN bin follow it, others the cut
    row_bin = bins_t[feat[safe], np.arange(n)]
    miss = (node >= 0) & (row_bin == B - 1)
    np.testing.assert_array_equal(tn.numpy()[miss] % 2,
                                  (dirv[safe] == 0)[miss])
    plain = _advance_node(t(bins_t), t(node), t(feat), t(thr), None,
                          t(dirv), B - 1)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jn))


# --- whole fits ---------------------------------------------------------

TIE_RTOL = 1e-5
TIE_ATOL = 1e-6


def _paths(tree, bins_t, miss_bin):
    """Each row's node at every level, ``[depth + 1, n]``, by the port's
    ``_advance_node`` with the tree's directions."""
    node = torch.zeros(bins_t.shape[1], dtype=torch.int32)
    out = [node]
    for lvl in range(tree["feat"].shape[0]):
        node = _advance_node(bins_t, node,
                             torch.tensor(np.asarray(tree["feat"][lvl])),
                             torch.tensor(np.asarray(tree["thr"][lvl])),
                             None, torch.tensor(np.asarray(tree["dir"][lvl])),
                             miss_bin)
        out.append(node)
    return torch.stack(out).numpy()


def _gain64(g, h, bins, f, thr, d, miss_bin, lam=1.0):
    """The split gain of (feature f, threshold thr, direction d) over the
    rows of ``g``/``h``/``bins`` in float64 (order plays no part)."""
    b = bins[f].astype(np.int64)
    left = np.where(b == miss_bin, d == 1 or thr == miss_bin, b <= thr)
    gl, hl = g[left].sum(), h[left].sum()
    gt, ht = g.sum(), h.sum()

    def score(G, H):
        return G * G / (H + lam)

    return 0.5 * (score(gl, hl) + score(gt - gl, ht - hl) - score(gt, ht))


def _assert_level_b(jm, tm, X, y, Xv, depth, min_same):
    """Parity level (b) with the direction, on ``binary:logistic`` fits
    of ``X`` (no weights): nodes whose (feat, thr, dir) agree keep gains
    rtol 1e-4 / atol 1e-5 and leaves under them rtol 1e-5 / atol 1e-5;
    nodes that differ have gains within TIE_RTOL / TIE_ATOL, and where
    every ancestor agrees the two choices are proven an exact tie — their
    gains over the node's training rows, in float64 from the port's
    margins, agree within 1e-9.  (In missing mode ties are common: a node
    whose rows hold no NaN of a feature scores both directions alike;
    JAX's f32 sibling subtraction leaves a few ulps of NaN mass there and
    picks a direction from them, the port's exact sums pick missing-
    right.)  Training margins agree within 1e-5, and held-out rows whose
    path crosses no differing node — at least ``min_same`` of them —
    predict the same within 1e-5.  Returns the differing nodes' count."""
    assert tm._missing and jm._missing
    assert _same_bits(tm.cuts.numpy(), jm.cuts)
    mb = tm._miss_bin()
    bins_tr = tq.apply_bins_missing(torch.from_numpy(X), tm.cuts, mb)
    bins_v = tq.apply_bins_missing(torch.from_numpy(Xv), tm.cuts, mb)
    y = np.asarray(y, np.float64)
    crosses = np.zeros(len(Xv), bool)
    n_differ = 0
    assert len(jm.trees) == len(tm.trees)
    margin = torch.zeros(len(X))
    for t, (a, b) in enumerate(zip(jm.trees, tm.trees)):
        assert list(b) == list(a)                    # key order: the file
        fa, ta, da, ga = (np.asarray(a[k]) for k in ("feat", "thr", "dir",
                                                      "gain"))
        fb, tb, db, gb = (np.asarray(b[k]) for k in ("feat", "thr", "dir",
                                                      "gain"))
        assert db.dtype == da.dtype == np.int32
        live = np.arange(fa.shape[1])[None, :] < 2 ** np.arange(depth)[:, None]
        differ = live & ((fa != fb) | (ta != tb) | (da != db))
        agree = live & ~differ
        n_differ += int(differ.sum())
        np.testing.assert_allclose(gb[agree], ga[agree], rtol=1e-4,
                                   atol=1e-5, err_msg=f"tree {t}")
        np.testing.assert_allclose(gb[differ], ga[differ], rtol=TIE_RTOL,
                                   atol=TIE_ATOL, err_msg=f"tree {t}")
        clean = np.ones(2 ** depth, bool)
        for lvl in range(depth):
            span = 2 ** (depth - lvl)
            for i in np.flatnonzero(differ[lvl]):
                clean[i * span:(i + 1) * span] = False
        np.testing.assert_allclose(np.asarray(b["leaf"])[clean],
                                   np.asarray(a["leaf"])[clean], rtol=1e-5,
                                   atol=1e-5, err_msg=f"tree {t}")
        # padding past each level's nodes is JAX's: zeros
        assert (db[~live] == 0).all()
        if differ.any():
            p = 1.0 / (1.0 + np.exp(-margin.double().numpy()))
            g, h = p - y, p * (1.0 - p)
            path = _paths(b, bins_tr, mb)
            bn = bins_tr.numpy()
            for lvl, i in zip(*np.nonzero(differ)):
                up = [(lv, i >> (lvl - lv)) for lv in range(lvl)]
                if any(differ[lv, j] for lv, j in up):
                    continue
                rows = path[lvl] == i
                ja = _gain64(g[rows], h[rows], bn[:, rows], fa[lvl, i],
                             ta[lvl, i], da[lvl, i], mb)
                jb = _gain64(g[rows], h[rows], bn[:, rows], fb[lvl, i],
                             tb[lvl, i], db[lvl, i], mb)
                assert abs(ja - jb) <= 1e-9 * max(abs(ja), 1.0), (
                    t, lvl, i, ja, jb)
        for tree in (a, b):
            pth = _paths(tree, bins_v, mb)
            for lvl in range(depth):
                crosses |= differ[lvl][pth[lvl]]
        st = tm._stacked_trees([b])
        margin = _predict_trees(bins_tr, st["feat"], st["thr"], st["leaf"],
                                depth, margin, st["dir"], mb)
    np.testing.assert_allclose(tm.train_margins(), jm.train_margins(),
                               atol=1e-5)
    same = ~crosses
    assert same.mean() > min_same, same.mean()
    np.testing.assert_allclose(tm.predict(Xv[same], output_margin=True),
                               jm.predict(Xv[same], output_margin=True),
                               atol=1e-5)
    np.testing.assert_allclose(tm.predict(Xv[same]), jm.predict(Xv[same]),
                               atol=1e-5)
    return n_differ


@pytest.fixture(scope="module")
def mnar_fits():
    _, Xm, y, mask = _mnar_problem()
    kw = dict(n_trees=6, max_depth=4, n_bins=64)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(Xm, y)
    tm = HistGBT(device="cpu", **kw).fit(Xm, y)
    return jm, tm, Xm, y, mask


def test_mnar_fit_matches_jax(mnar_fits):
    jm, tm, Xm, y, mask = mnar_fits
    assert "dir" in tm.trees[0]
    assert tm.cuts.shape[1] == 64 - 2
    _, Xv, _, _ = _mnar_problem(n=800, seed=1)
    assert _assert_level_b(jm, tm, Xm, y, Xv, 4, 0.99) == 0
    # the learned direction recovers the masked signal (JAX's own test)
    pred = tm.predict(Xm) > 0.5
    assert (pred == y).mean() > 0.95
    assert (pred[mask] == y[mask]).mean() > 0.95
    used = {int(d) for t in tm.trees for d in np.asarray(t["dir"])[0, :1]}
    assert used <= {0, 1}


def test_higgs_like_nan_fit_matches_jax():
    X, y = _higgs_nan(3000)
    Xv, _ = _higgs_nan(2000, seed=8)
    kw = dict(n_trees=4, max_depth=6, n_bins=256)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    # 6 nodes differ, each an exact tie; 78.5% of the held-out rows
    # (which hold NaN where the training rows of a node did not) cross
    # none of them
    assert _assert_level_b(jm, tm, X, y, Xv, 6, 0.75) <= 8
    dirs = np.concatenate([np.asarray(t["dir"])[0, :1] for t in tm.trees] +
                          [np.asarray(t["dir"]).ravel() for t in tm.trees])
    assert set(dirs.tolist()) == {0, 1}              # both directions


def test_missing_model_files_cross_load(mnar_fits, tmp_path):
    jm, tm, Xm, _, _ = mnar_fits
    jm.save_model(str(tmp_path / "jax.model"))
    tm.save_model(str(tmp_path / "torch.model"))
    from_jax = HistGBT.load_model(str(tmp_path / "jax.model"), device="cpu")
    from_torch = JaxHistGBT.load_model(str(tmp_path / "torch.model"),
                                       mesh=local_mesh(1))
    assert from_jax._missing and from_torch._missing
    for a, b in ((from_jax, jm), (from_torch, tm)):
        np.testing.assert_array_equal(a.predict(Xm, output_margin=True),
                                      b.predict(Xm, output_margin=True))
        np.testing.assert_allclose(a.predict(Xm), b.predict(Xm), rtol=0,
                                   atol=1e-6)
    # the JAX model's weights through the port's writer: the same bytes
    port = HistGBT.from_state({
        "param": jm.param.to_dict(), "cuts": np.asarray(jm.cuts),
        "trees": jm.trees, "best_iteration": None, "best_score": None,
        "early_stopped": False, "missing": True}, device="cpu")
    port.save_model(str(tmp_path / "again.model"))
    assert ((tmp_path / "again.model").read_bytes()
            == (tmp_path / "jax.model").read_bytes())
    # and a reloaded port model writes its own file again
    HistGBT.load_model(str(tmp_path / "torch.model"), device="cpu"
                       ).save_model(str(tmp_path / "round.model"))
    assert ((tmp_path / "round.model").read_bytes()
            == (tmp_path / "torch.model").read_bytes())


def _raises_in_both(fn_jax, fn_port):
    with pytest.raises(JaxError):
        fn_jax()
    with pytest.raises(Error):
        fn_port()


def test_missing_refusals_mirror_jax(monkeypatch):
    X, Xm, y, _ = _mnar_problem(n=400)
    kw = dict(n_trees=2, max_depth=3, n_bins=16)

    def jax_model(**k):
        return JaxHistGBT(mesh=local_mesh(1), **{**kw, **k})

    def port_model(**k):
        return HistGBT(device="cpu", **{**kw, **k})

    # n_bins < 3: no room for the NaN bin
    _raises_in_both(lambda: jax_model(n_bins=2).fit(Xm, y),
                    lambda: port_model(n_bins=2).fit(Xm, y))
    # a feature all-NaN
    Xa = Xm.copy()
    Xa[:, 3] = np.nan
    _raises_in_both(lambda: jax_model().fit(Xa, y),
                    lambda: port_model().fit(Xa, y))
    # NaN into a model whose cuts were made without it
    jm, tm = jax_model().fit(X, y), port_model().fit(X, y)
    assert not tm._missing and "dir" not in tm.trees[0]
    _raises_in_both(lambda: jm.predict(Xm), lambda: tm.predict(Xm))
    _raises_in_both(lambda: jm.make_device_data(Xm, y),
                    lambda: tm.make_device_data(Xm, y))
    # NaN with standard-width cuts given
    cuts = np.asarray(jq.compute_cuts(X, 16))
    _raises_in_both(lambda: jax_model().fit(Xm, y, cuts=cuts),
                    lambda: port_model().fit(Xm, y, cuts=cuts))
    # a cut width that does not match missing mode
    jd, td = jax_model(), port_model()
    jd.make_device_data(Xm, y)
    td.make_device_data(Xm, y)
    _raises_in_both(lambda: jd.make_device_data(Xm, y, cuts=cuts),
                    lambda: td.make_device_data(Xm, y, cuts=cuts))
    # lossguide with NaN
    monkeypatch.setenv("DMLC_GROW_POLICY", "lossguide")
    monkeypatch.setenv("DMLC_MAX_LEAVES", "4")
    _raises_in_both(lambda: jax_model().fit(Xm, y),
                    lambda: port_model().fit(Xm, y))


def test_missing_mode_is_sticky():
    X, Xm, y, _ = _mnar_problem(n=600)
    m = HistGBT(device="cpu", n_trees=2, max_depth=3, n_bins=16)
    m.make_device_data(Xm, y)
    cuts = m.cuts.clone()
    assert m._missing and cuts.shape[1] == 14
    dd = m.make_device_data(X, y)                 # NaN-free, still missing
    assert m._missing and torch.equal(m.cuts, cuts)
    assert torch.equal(dd["bins_t"], tq.apply_bins_missing(
        torch.from_numpy(X), cuts, 15))
    m.fit_device(dd)
    assert "dir" in m.trees[0]
    np.testing.assert_array_equal(m.predict(X), m.predict(X))
    # NaN-free data with no NaN anywhere: no missing mode, no dir key
    plain = HistGBT(device="cpu", n_trees=2, max_depth=3, n_bins=16
                    ).fit(X, y)
    assert not plain._missing and "dir" not in plain.trees[0]
    assert plain.to_state()["missing"] is False


@pytest.mark.parametrize("env", [
    {"DMLC_BIN_PACK": "1", "DMLC_FEATURE_BUNDLE": "1"},
    {"DMLC_TPU_FUSED_DESCEND": "1"},
    {"DMLC_HIST_BLOCKS": "8"},
    {"DMLC_HIST_BLOCKS": "8", "DMLC_TPU_FUSED_DESCEND": "1"},
    {"DMLC_TPU_BIN_BACKEND": "cpu"},
    {"DMLC_FUSED_ROUND": "1"},
], ids=["pack_bundle", "fused_descend", "blocks", "blocks_fused",
        "host_bins", "fused_round_on"])
def test_levers_leave_the_missing_file_unchanged(env, monkeypatch,
                                                 tmp_path):
    X, y = _higgs_nan(1500, F=7, seed=3)
    X[:, 5] = np.where(np.isnan(X[:, 5]), np.nan,
                       np.round(X[:, 5]).clip(-1, 1))  # a narrow feature
    kw = dict(n_trees=3, max_depth=4, n_bins=32)
    ref = HistGBT(device="cpu", **kw).fit(X, y)
    ref.save_model(str(tmp_path / "ref"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    m = HistGBT(device="cpu", **kw).fit(X, y)
    assert m._bin_layout is None
    m.save_model(str(tmp_path / "lever"))
    assert (tmp_path / "lever").read_bytes() == (tmp_path / "ref").read_bytes()
