"""The sparse engine (``ops.sparse_hist``, ``models.histgbt_sparse``) in
the port, against the JAX package, on the CPU.

* host passes bit-equal: candidates, cuts, their 2-shard merge, entry
  bins (the host and the device route), ``csr_rows`` — with ties and
  -0.0 among the values;
* ``level_histogram`` / ``node_totals`` bit-equal on order-exact g/h,
  ``route_level`` bit-equal, ``sparse_best_split`` the same (feat, thr,
  dir) with gains within rtol 1e-5, and the precision probe of a rare
  feature after heavy mass (the port's prefixes are exact);
* the first tree tree-exact against tests/test_sparse_gbt.py's
  brute-force oracle and against JAX's first tree (depth × mcw × gamma);
* full fits (binary, regression, subsample 0.8, L1) at parity level
  (b): the same (feat, thr) at every node, the same dir except where the
  node holds no absent mass of its feature (ROADMAP C8: then both
  directions are one partition and JAX's f32 absent mass is rounding
  noise), leaves, gains and predictions within tolerance;
* model files cross-load both ways; every JAX refusal is the port's;
* two gloo ranks with injected cuts write the 1-process file, and
  without cuts their merged cuts are JAX's merge of the same shards.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402
from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models.histgbt_sparse import (  # noqa: E402
    SparseHistGBT as JaxSparse)
from dmlc_core_tpu.ops import sparse_hist as JS  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.data.row_block import RowBlock  # noqa: E402
from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT  # noqa: E402
from dmlc_core_tpu_torch.ops import sparse_hist as S  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import launch  # noqa: E402
from test_sparse_gbt import _brute_first_tree, _sparse_problem  # noqa: E402

torch.set_num_threads(2)

KNOB = "DMLC_TPU_SPARSE_ROUNDS_PER_DISPATCH"


@pytest.fixture(autouse=True)
def _no_knob(monkeypatch):
    monkeypatch.delenv(KNOB, raising=False)


def _entries(seed, F=17, nnz=900, rounded=True):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, F, nnz)
    cols[cols == 5] = 6                  # feature 5 empty
    vals = rng.normal(size=nnz).astype(np.float32)
    if rounded:                          # ties, and -0.0 among them
        vals = np.round(vals, 1).astype(np.float32)
    return cols, vals


def _same_cuts(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


# ---------------------------------------------------------------------------
# host passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounded", [True, False])
@pytest.mark.parametrize("max_bins", [2, 8, 64])
def test_cuts_candidates_and_bins_bit_equal(rounded, max_bins):
    cols, vals = _entries(1, rounded=rounded)
    if rounded:
        assert (np.signbit(vals) & (vals == 0)).any()     # -0.0 present
    cand = S.sparse_cut_candidates(cols, vals, 17, max_bins)
    jcand = JS.sparse_cut_candidates(cols, vals, 17, max_bins)
    assert cand.tobytes() == jcand.tobytes()
    cuts = S.build_sparse_cuts(cols, vals, 17, max_bins)
    _same_cuts(cuts, JS.build_sparse_cuts(cols, vals, 17, max_bins))
    gb = S.bin_sparse_entries(cols, vals, cuts)
    assert gb.dtype == np.int32
    assert gb.tobytes() == JS.bin_sparse_entries(cols, vals, cuts).tobytes()
    dev = S.bin_sparse_entries(cols, vals, cuts, device="cpu")
    np.testing.assert_array_equal(dev.numpy(), gb)
    if not rounded:            # the card's route (no -0.0), in torch ops
        got = S._candidates_t(torch.from_numpy(cols), torch.from_numpy(vals),
                              17, max_bins - 1)
        assert got.tobytes() == jcand.tobytes()
    # entries on the other side of -0.0 / +0.0 cuts bin as floats compare
    probe = np.array([0.0, -0.0, 0.1, -0.1], np.float32)
    pc = np.full(4, 6)
    np.testing.assert_array_equal(
        S.bin_sparse_entries(pc, probe, cuts),
        JS.bin_sparse_entries(pc, probe, cuts))


def test_cuts_on_the_sparse_bench_rows_bit_equal():
    from dmlc_core_tpu_torch.tools.bench_sparse import sparse_data

    offset, index, value, _ = sparse_data(500, 3000, 0.01)
    _same_cuts(S.build_sparse_cuts(index, value, 3000, 32),
               JS.build_sparse_cuts(index, value, 3000, 32))
    cuts = S.build_sparse_cuts(index, value, 3000, 32)
    got = S._candidates_t(torch.from_numpy(index), torch.from_numpy(value),
                          3000, 31)
    assert got.tobytes() == JS.sparse_cut_candidates(index, value, 3000,
                                                     32).tobytes()
    np.testing.assert_array_equal(
        S.bin_sparse_entries(index, value, cuts, device="cpu").numpy(),
        JS.bin_sparse_entries(index, value, cuts))
    np.testing.assert_array_equal(S.csr_rows(offset), JS.csr_rows(offset))


def test_csr_rows_and_the_two_shard_merge_bit_equal():
    assert S.csr_rows(np.array([0, 2, 2, 5])).tolist() == [0, 0, 2, 2, 2]
    assert S.csr_rows(np.array([0, 2, 2, 5])).dtype == np.int32
    rng = np.random.default_rng(5)
    F, nnz = 11, 4000
    cols = rng.integers(0, F, nnz)
    cols[cols == 4] = 5
    vals = rng.normal(size=nnz).astype(np.float32)
    halves = [slice(0, nnz // 2), slice(nnz // 2, nnz)]
    cands = np.stack([S.sparse_cut_candidates(cols[s], vals[s], F, 16)
                      for s in halves])
    jc = np.stack([JS.sparse_cut_candidates(cols[s], vals[s], F, 16)
                   for s in halves])
    assert cands.tobytes() == jc.tobytes()
    _same_cuts(S.merge_sparse_cut_candidates(cands),
               JS.merge_sparse_cut_candidates(jc))


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def _level_inputs(seed=3, n=300, F=14):
    offset, index, value, y, _, _ = _sparse_problem(n=n, F=F, density=0.3,
                                                    seed=seed)
    cuts = S.build_sparse_cuts(index, value, F, 8)
    gb = S.bin_sparse_entries(index, value, cuts)
    rows = S.csr_rows(offset)
    rng = np.random.default_rng(seed)
    g = rng.choice(np.float32([-1.0, -0.5, 0.5, 1.0]), n)   # order-exact
    h = rng.choice(np.float32([0.25, 1.0]), n)
    return cuts, gb, rows, g.astype(np.float32), h.astype(np.float32)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_level_histogram_and_node_totals_bit_equal(level):
    cuts, gb, rows, g, h = _level_inputs()
    n = len(g)
    rng = np.random.default_rng(level)
    n_nodes = 1 << level
    node = rng.integers(-1, n_nodes, n).astype(np.int32)    # −1: padding
    n_build = 1 if level == 0 else n_nodes >> 1
    TB = cuts.total_bins
    kg, kh = 4, 4                          # exact for these g/h
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    hist = S.level_histogram(t(rows), t(gb), t(node), t(g), t(h),
                             n_build=n_build, total_bins=TB, level=level,
                             kg=kg, kh=kh)
    assert hist.dtype == torch.int64 and hist.shape == (2, n_build, TB)
    jh = JS.level_histogram(jnp.asarray(rows), jnp.asarray(gb),
                            jnp.asarray(node), jnp.asarray(g),
                            jnp.asarray(h), n_build=n_build,
                            total_bins=TB, level=level)
    got = S.dequantize_sums(hist, kg, kh).numpy()
    assert got.tobytes() == np.asarray(jh).tobytes()
    tot = S.node_totals(t(node), t(g), t(h), n_nodes=n_nodes, kg=kg, kh=kh)
    jt = JS.node_totals(jnp.asarray(node), jnp.asarray(g), jnp.asarray(h),
                        n_nodes=n_nodes)
    assert S.dequantize_sums(tot, kg, kh).numpy().tobytes() == \
        np.asarray(jt).tobytes()


def test_route_level_bit_equal():
    cuts, gb, rows, _, _ = _level_inputs(seed=4)
    n = int(rows.max()) + 1
    rng = np.random.default_rng(0)
    node = rng.integers(-1, 4, n).astype(np.int32)
    widths = np.diff(cuts.bin_ptr)
    feat = rng.integers(0, cuts.n_features, 4).astype(np.int32)
    thr = (rng.integers(0, 100, 4) % widths[feat]).astype(np.int32)
    dirv = rng.random(4) < 0.5
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    got = S.route_level(t(rows), t(gb), t(node), t(feat), t(thr), t(dirv),
                        t(cuts.bin_ptr), t(cuts.feat_of_bin))
    want = JS.route_level(jnp.asarray(rows), jnp.asarray(gb),
                          jnp.asarray(node), jnp.asarray(feat),
                          jnp.asarray(thr), jnp.asarray(dirv),
                          jnp.asarray(cuts.bin_ptr),
                          jnp.asarray(cuts.feat_of_bin))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shuffled", [False, True])
def test_route_sorted_equals_route_level(shuffled):
    cuts, gb, rows, _, _ = _level_inputs(seed=6)
    n = int(rows.max()) + 1
    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    feat_e = cuts.feat_of_bin[gb]
    order = (rng.permutation(len(gb)) if shuffled
             else np.arange(len(gb)))
    index = S.EntryIndex(t(rows[order].astype(np.int64)),
                         t(feat_e[order]), t(gb[order]), cuts.n_features)
    widths = np.diff(cuts.bin_ptr)
    for n_nodes in (1, 2, 4, 8):
        node = rng.integers(-1, n_nodes, n).astype(np.int32)
        feat = rng.integers(0, cuts.n_features, n_nodes).astype(np.int32)
        thr = (rng.integers(0, 100, n_nodes) % widths[feat]).astype(np.int32)
        dirv = rng.random(n_nodes) < 0.5
        args = (t(node), t(feat), t(thr), t(dirv))
        want = S.route_level(t(rows), t(gb), *args, t(cuts.bin_ptr),
                             t(cuts.feat_of_bin))
        got = S.route_sorted(index, *args, t(cuts.bin_ptr))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_histogram_sums_exact_at_the_scale_bound():
    # |q| up to 2^53 / n: the float64 scatter-adds must give the int64
    # sums exactly, in any order of the entries
    from dmlc_core_tpu_torch.ops.histogram import hist_scales

    cuts, gb, rows, _, _ = _level_inputs(seed=8)
    n = int(rows.max()) + 1
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 1e3)
    h = torch.from_numpy(rng.uniform(0, 5, n).astype(np.float32))
    kg, kh = hist_scales(g, h)
    q = S.quantize_rows(g, h, kg, kh).numpy()
    assert np.abs(q[:, 0]).max() * n > 2 ** 51          # near the bound
    TB = cuts.total_bins
    want = np.zeros((2, TB), np.int64)
    for p in range(2):
        np.add.at(want[p], gb, q[rows, p])
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    node = torch.zeros(n, dtype=torch.int32)
    for perm in (np.arange(len(gb)), rng.permutation(len(gb))):
        got = S.level_histogram(t(rows[perm]), t(gb[perm]), node, g, h,
                                n_build=1, total_bins=TB, level=0, kg=kg,
                                kh=kh)
        np.testing.assert_array_equal(got[:, 0].numpy(), want)
    tot = S.node_totals(node, g, h, n_nodes=1, kg=kg, kh=kh)
    np.testing.assert_array_equal(tot[:, 0].numpy(), q.sum(0))


def _jax_split(hist, totals, cuts, **kw):
    widths = np.diff(cuts.bin_ptr)
    b_max = int(widths.max())
    TB = cuts.total_bins
    dense_pos = (cuts.feat_of_bin.astype(np.int64) * b_max + np.arange(TB)
                 - cuts.bin_ptr[cuts.feat_of_bin])
    last = np.isin(np.arange(TB), cuts.bin_ptr[1:] - 1)
    out = JS.sparse_best_split(
        jnp.asarray(hist), jnp.asarray(totals), jnp.asarray(cuts.bin_ptr),
        jnp.asarray(cuts.feat_of_bin), jnp.asarray(last),
        jnp.asarray(dense_pos), n_dense=cuts.n_features * b_max,
        b_max=b_max, **kw)
    return [np.asarray(o) for o in out]


def _port_split(hist_q, totals_q, cuts, kg, kh, **kw):
    last = np.zeros(cuts.total_bins, bool)
    last[cuts.bin_ptr[1:] - 1] = True
    out = S.sparse_best_split(
        torch.from_numpy(hist_q), torch.from_numpy(totals_q),
        torch.from_numpy(cuts.bin_ptr),
        torch.from_numpy(cuts.feat_of_bin), torch.from_numpy(last),
        kg=kg, kh=kh, **kw)
    return [o.numpy() for o in out]


def _split_case(exact, seed=0, N=4, F=12):
    """int64 sums of a node-partitioned problem: per node the present
    mass of each bin and the node's totals (present + absent)."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(1, 7, F)
    bin_ptr = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    cuts = S.SparseCuts(np.zeros(int(bin_ptr[-1] - F), np.float32),
                        np.concatenate([[0], np.cumsum(widths - 1)]),
                        bin_ptr, np.repeat(np.arange(F, dtype=np.int32),
                                           widths))
    TB = cuts.total_bins
    k = 0 if exact else 20
    g = rng.integers(-40, 41, (N, TB)) << k
    h = rng.integers(0, 30, (N, TB)) << k
    if not exact:                           # fractional low bits
        g += rng.integers(0, 1 << k, (N, TB))
        h += rng.integers(0, 1 << k, (N, TB))
    feat_tot = [np.add.reduceat(x, bin_ptr[:-1], axis=1) for x in (g, h)]
    absent = [rng.integers(0, 40, N) << k, rng.integers(0, 20, N) << k]
    totals = np.stack([feat_tot[0].max(1) + absent[0],
                       feat_tot[1].max(1) + absent[1]])
    return cuts, np.stack([g, h]).astype(np.int64), totals.astype(np.int64), k


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("lam,gamma,mcw,alpha", [(1.0, 0.0, 1.0, 0.0),
                                                 (0.5, 2.0, 4.0, 0.0),
                                                 (1.0, 0.0, 1.0, 3.0)])
def test_sparse_best_split_matches_jax(exact, lam, gamma, mcw, alpha):
    cuts, hq, tq, k = _split_case(exact)
    kw = dict(lam=lam, gamma=gamma, mcw=mcw, alpha=alpha)
    feat, thr, dirv, gain = _port_split(hq, tq, cuts, k, k, **kw)
    hf = (hq * 2.0 ** -k).astype(np.float32)
    tf = (tq * 2.0 ** -k).astype(np.float32)
    jf, jt, jd, jg = _jax_split(hf, tf, cuts, **kw)
    np.testing.assert_array_equal(feat, jf)
    np.testing.assert_array_equal(thr, jt)
    np.testing.assert_array_equal(dirv, jd)
    assert feat.dtype == np.int32 and thr.dtype == np.int32
    assert dirv.dtype == np.bool_ and gain.dtype == np.float32
    if exact:
        assert gain.tobytes() == jg.tobytes()
    else:
        np.testing.assert_allclose(gain, jg, rtol=1e-5)


def test_split_scan_precision_rare_feature_after_heavy_mass():
    # tests/test_sparse_gbt.py's probe: ~1e8 of g/h mass in 16,000 bins
    # before a rare 4-bin feature.  The port's prefixes are exact, so the
    # chosen gain is the float64 best of every candidate within f32
    # rounding (JAX's bound: its best of the tiny feature minus 1e-3 rel)
    F_heavy, B = 2000, 8
    TB = F_heavy * B + 4
    rng = np.random.default_rng(0)
    k = 10
    hist = np.zeros((2, 1, TB), np.int64)
    hist[:, 0, :F_heavy * B] = rng.integers(0, 10_000 << k,
                                            (2, F_heavy * B))
    tiny = np.array([13, 7, 29, 5], np.int64) << k
    hist[0, 0, F_heavy * B:] = tiny
    hist[1, 0, F_heavy * B:] = tiny // 2
    widths = np.full(F_heavy + 1, B, np.int64)
    widths[-1] = 4
    bin_ptr = np.concatenate([[0], np.cumsum(widths)])
    cuts = S.SparseCuts(np.zeros(TB - F_heavy - 1, np.float32),
                        np.concatenate([[0], np.cumsum(widths - 1)]),
                        bin_ptr, np.repeat(np.arange(F_heavy + 1,
                                                     dtype=np.int32), widths))
    totals = hist.sum(axis=2) * 3 // 2
    feat, thr, dirv, gain = _port_split(hist, totals, cuts, k, k, lam=1.0,
                                        gamma=0.0, mcw=1.0)
    x = hist[:, 0].astype(np.float64) * 2.0 ** -k
    gt, ht = totals[:, 0].astype(np.float64) * 2.0 ** -k
    best = -np.inf
    for f in range(F_heavy + 1):
        a, b = bin_ptr[f], bin_ptr[f + 1]
        gl, hl = np.cumsum(x[0, a:b])[:-1], np.cumsum(x[1, a:b])[:-1]
        mg, mh = gt - x[0, a:b].sum(), ht - x[1, a:b].sum()
        for ml in (0.0, 1.0):
            GL, HL = gl + ml * mg, hl + ml * mh
            GR, HR = gt - GL, ht - HL
            ok = (HL >= 1.0) & (HR >= 1.0)
            s = GL ** 2 / (HL + 1) + GR ** 2 / (HR + 1) - gt ** 2 / (ht + 1)
            if ok.any():
                best = max(best, s[ok].max())
    np.testing.assert_allclose(float(gain[0]), 0.5 * best, rtol=1e-6)
    jh = (hist * 2.0 ** -k).astype(np.float32)
    jt = (totals * 2.0 ** -k).astype(np.float32)
    jg = _jax_split(jh, jt, cuts, lam=1.0, gamma=0.0, mcw=1.0)[3]
    assert float(gain[0]) >= float(jg[0]) * (1 - 1e-3)


# ---------------------------------------------------------------------------
# first trees and full fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,mcw,gamma", [(3, 1.0, 0.0), (2, 4.0, 0.05),
                                             (4, 1.0, 0.0), (3, 2.0, 0.5)])
def test_first_tree_matches_brute_force_and_jax(depth, mcw, gamma):
    offset, index, value, y, mask, vals = _sparse_problem(
        n=300, F=14, density=0.25, seed=7)
    kw = dict(n_trees=1, max_depth=depth, n_bins=8, learning_rate=0.7,
              reg_lambda=1.0, min_child_weight=mcw, gamma=gamma)
    m = SparseHistGBT(device="cpu", **kw).fit(offset, index, value, y)
    cuts = m.cuts
    widths = np.diff(cuts.bin_ptr).astype(int)
    n, F = mask.shape
    bins = np.zeros((n, F), int)
    for f in range(F):
        cf = cuts.cut_vals[cuts.cut_ptr[f]:cuts.cut_ptr[f + 1]]
        bins[:, f] = np.searchsorted(cf, vals[:, f], side="right")
    levels, leaf, _ = _brute_first_tree(
        bins, mask, y, widths, lam=1.0, gamma=gamma, mcw=mcw, depth=depth,
        eta=0.7)
    tree = m.trees[0]
    for lv, (bf, bt, bd) in enumerate(levels):
        nn = 1 << lv
        np.testing.assert_array_equal(tree["feat"][lv][:nn], bf)
        np.testing.assert_array_equal(tree["thr"][lv][:nn], bt)
        np.testing.assert_array_equal(tree["dir"][lv][:nn], bd)
    np.testing.assert_allclose(tree["leaf"], leaf, rtol=1e-5, atol=1e-7)
    # level (a): logistic round-one g/h are dyadic, so the JAX tree is
    # the same tree bit for bit
    jt = JaxSparse(**kw).fit(offset, index, value, y).trees[0]
    assert list(tree) == list(jt) == ["feat", "thr", "dir", "gain", "leaf"]
    for key in tree:
        assert tree[key].dtype == jt[key].dtype, key
        assert tree[key].tobytes() == jt[key].tobytes(), key


def test_squared_error_plus_minus_one_trees_bit_equal():
    # reg:squarederror with labels ±1 from margin 0: g ∈ {±1}, h = 1
    offset, index, value, y, _, _ = _sparse_problem(seed=13)
    y = 2 * y - 1
    kw = dict(n_trees=1, max_depth=4, n_bins=16, learning_rate=0.5,
              objective="reg:squarederror")
    a = SparseHistGBT(device="cpu", **kw).fit(offset, index, value, y)
    b = JaxSparse(**kw).fit(offset, index, value, y)
    for key in a.trees[0]:
        assert a.trees[0][key].tobytes() == b.trees[0][key].tobytes(), key


def _node_rows(model, offset, index, value, tree):
    """Each level's node of every row under ``tree`` (the port's route)."""
    n = len(offset) - 1
    c = model.cuts
    t = torch.from_numpy
    rows = t(S.csr_rows(offset).astype(np.int64))
    gb = S.bin_sparse_entries(index, value, c, device="cpu")
    bp, fob = t(c.bin_ptr), t(c.feat_of_bin.astype(np.int64))
    node = torch.zeros(n, dtype=torch.int32)
    out = []
    for lv in range(tree["feat"].shape[0]):
        out.append(node.numpy().copy())
        nn = 1 << lv
        node = S.route_level(rows, gb, node, t(tree["feat"][lv][:nn]),
                             t(tree["thr"][lv][:nn]), t(tree["dir"][lv][:nn]),
                             bp, fob)
    return out


def assert_sparse_level_b(jm, tm, csr, held_out=None, weight=None):
    """Parity level (b) for sparse fits: every node's (feat, thr) equal;
    dir equal except at a node none of whose (weighted) training rows
    lacks the node's feature (ROADMAP C8, listed in the return value);
    leaves and gains close; training and held-out margins within 1e-5
    once JAX's trees take the port's direction at those nodes."""
    offset, index, value, y = csr
    n = len(offset) - 1
    w = np.ones(n) if weight is None else weight
    present = np.zeros((n, tm.n_features), bool)
    present[S.csr_rows(offset), index] = True
    assert len(jm.trees) == len(tm.trees)
    c8 = []
    for ti, (a, b) in enumerate(zip(jm.trees, tm.trees)):
        nodes = _node_rows(tm, offset, index, value, b)
        for lv in range(b["feat"].shape[0]):
            nn = 1 << lv
            np.testing.assert_array_equal(a["feat"][lv][:nn],
                                          b["feat"][lv][:nn])
            np.testing.assert_array_equal(a["thr"][lv][:nn],
                                          b["thr"][lv][:nn])
            for i in np.nonzero(a["dir"][lv][:nn] != b["dir"][lv][:nn])[0]:
                f = b["feat"][lv][i]
                rows = (nodes[lv] == i) & (w > 0)
                assert present[rows, f].all(), (ti, lv, i)
                c8.append((ti, lv, int(i)))
        np.testing.assert_allclose(b["leaf"], a["leaf"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(b["gain"], a["gain"], rtol=1e-4,
                                   atol=1e-5)
    for ti, lv, i in c8:                    # JAX's trees, the port's dirs
        jm.trees[ti]["dir"][lv][i] = tm.trees[ti]["dir"][lv][i]
    for o, ix, v in [(offset, index, value)] + ([held_out] if held_out
                                                else []):
        np.testing.assert_allclose(
            tm.predict(o, ix, v, output_margin=True),
            jm.predict(o, ix, v, output_margin=True), rtol=0, atol=1e-5)
    return c8


@pytest.mark.parametrize("case", ["binary", "regression", "subsample",
                                  "l1_weighted"])
def test_full_fits_meet_level_b(case):
    offset, index, value, y, mask, vals = _sparse_problem(seed=11)
    ho = _sparse_problem(seed=12)[:3]
    kw = dict(n_trees=12, max_depth=3, n_bins=16, learning_rate=0.4)
    weight = None
    if case == "regression":
        y = np.where(mask[:, 0], vals[:, 0], -1.0).astype(np.float32)
        kw.update(objective="reg:squarederror", learning_rate=0.3)
    elif case == "subsample":
        kw.update(subsample=0.8, seed=5)
    elif case == "l1_weighted":
        kw.update(reg_alpha=0.5, scale_pos_weight=2.0)
        weight = np.random.default_rng(1).uniform(0.5, 2, len(y)).astype(
            np.float32)
    tm = SparseHistGBT(device="cpu", **kw).fit(offset, index, value, y,
                                               weight=weight)
    jm = JaxSparse(**kw).fit(offset, index, value, y, weight=weight)
    assert_sparse_level_b(jm, tm, (offset, index, value, y), ho)


def test_c8_direction_tie_without_absent_mass():
    """ROADMAP C8 pinned: tree 13 of tests/test_sparse_gbt.py's seed-11
    problem splits level 2, node 0 on feature 0, present in all 21 of the
    node's rows.  The port's absent mass there is exactly 0, so both
    directions score the same and it keeps dir False (missing right, as
    ``gain_l > gain_r`` decides); JAX's f32 absent mass is rounding noise
    and sets dir True.  Every other node agrees."""
    offset, index, value, y, _, _ = _sparse_problem(seed=11)
    kw = dict(n_trees=20, max_depth=3, n_bins=16, learning_rate=0.4)
    tm = SparseHistGBT(device="cpu", **kw).fit(offset, index, value, y)
    jm = JaxSparse(**kw).fit(offset, index, value, y)
    c8 = assert_sparse_level_b(jm, tm, (offset, index, value, y))
    assert c8 == [(13, 2, 0)]
    assert not tm.trees[13]["dir"][2][0]


def test_rounds_per_dispatch_and_blocks_give_one_model(tmp_path, monkeypatch):
    offset, index, value, y, _, _ = _sparse_problem(seed=17)
    kw = dict(n_trees=5, max_depth=3, n_bins=16)
    files = []
    for k in ("1", "3", "8"):
        monkeypatch.setenv(KNOB, k)
        m = SparseHistGBT(device="cpu", **kw).fit(offset, index, value, y)
        files.append(_file(m, tmp_path, k))
    blk = RowBlock(offset=offset, label=y, index=index, value=value)
    mb = SparseHistGBT(device="cpu", **kw).fit_block(blk)
    files.append(_file(mb, tmp_path, "blk"))
    assert len(set(files)) == 1
    np.testing.assert_array_equal(
        mb.predict_block(blk, output_margin=True),
        mb.predict(offset, index, value, output_margin=True))


def _file(model, tmp_path, name):
    path = str(tmp_path / f"{name}.model")
    model.save_model(path)
    with open(path, "rb") as f:
        return f.read()


def test_model_files_cross_load_both_ways(tmp_path):
    offset, index, value, y, _, _ = _sparse_problem(seed=23)
    kw = dict(n_trees=6, max_depth=3, n_bins=16)
    tm = SparseHistGBT(device="cpu", **kw).fit(offset, index, value, y)
    jm = JaxSparse(**kw).fit(offset, index, value, y)
    tp, jp = str(tmp_path / "t.model"), str(tmp_path / "j.model")
    tm.save_model(tp)
    jm.save_model(jp)
    j_of_t = JaxSparse.load_model(tp)
    t_of_j = SparseHistGBT.load_model(jp, device="cpu")
    for a, b in ((tm, j_of_t), (t_of_j, jm)):
        np.testing.assert_array_equal(
            a.predict(offset, index, value, output_margin=True),
            b.predict(offset, index, value, output_margin=True))
        np.testing.assert_allclose(a.predict(offset, index, value),
                                   b.predict(offset, index, value),
                                   rtol=0, atol=1e-6)
        for kind in ("weight", "gain"):
            np.testing.assert_array_equal(a.feature_importances(kind),
                                          b.feature_importances(kind))
    # the port's load of its own file writes the same bytes again
    again = SparseHistGBT.load_model(tp, device="cpu")
    assert _file(again, tmp_path, "again") == _file(tm, tmp_path, "t2")
    bad = tmp_path / "bad.model"
    bad.write_bytes(b"DCTGBT01" + b"\0" * 8)
    with pytest.raises(Error, match="not a SparseHistGBT model"):
        SparseHistGBT.load_model(str(bad), device="cpu")


def test_unseen_features_at_predict_are_absent():
    offset, index, value, y, _, _ = _sparse_problem(seed=29)
    m = SparseHistGBT(device="cpu", n_trees=4, max_depth=2,
                      n_bins=16).fit(offset, index, value, y)
    base = m.predict(offset, index, value, output_margin=True)
    offset2 = offset.copy()
    offset2[-1] += 1
    index2 = np.concatenate([index, [m.n_features + 7]])
    value2 = np.concatenate([value, [3.3]]).astype(np.float32)
    np.testing.assert_array_equal(
        m.predict(offset2, index2, value2, output_margin=True), base)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

_O, _I, _V, _Y, _, _ = _sparse_problem(n=60, F=8, seed=31)


def _fit_call(**over):
    a = dict(offset=_O, index=_I, value=_V, y=_Y)
    a.update(over)
    return lambda cls, **kw: cls(n_trees=1, max_depth=2, **kw).fit(
        a["offset"], a["index"], a["value"], a["y"],
        **{k: v for k, v in over.items()
           if k in ("n_features", "cuts", "weight")})


_BAD_NAN = _V.copy()
_BAD_NAN[3] = np.nan
_BAD_NEG = _I.copy()
_BAD_NEG[5] = -1
_DUP_I = np.array([2, 2, 5])

REFUSALS = {
    "objective": (lambda cls, **kw: cls(objective="multi:softmax",
                                        num_class=3, **kw),
                  "binary:logistic"),
    "monotone": (lambda cls, **kw: cls(monotone_constraints=[1, 0], **kw),
                 "monotone"),
    "colsample": (lambda cls, **kw: cls(colsample_bytree=0.5, **kw),
                  "colsample"),
    "subsample": (lambda cls, **kw: cls(subsample=0.0, **kw), "subsample"),
    "nan": (_fit_call(value=_BAD_NAN), "finite"),
    "negative": (_fit_call(index=_BAD_NEG), "negative"),
    "duplicate": (lambda cls, **kw: cls(n_trees=1, **kw).fit(
        np.array([0, 3]), _DUP_I, np.ones(3, np.float32),
        np.zeros(1, np.float32)), "duplicate"),
    "nnz": (lambda cls, **kw: cls(n_trees=1, **kw).fit(
        np.array([0, 4]), _DUP_I, np.ones(3, np.float32),
        np.zeros(1, np.float32)), "offset"),
    "value_length": (_fit_call(value=_V[:-1]), "index/value length"),
    "rows": (_fit_call(y=_Y[:-1]), "y/offset row mismatch"),
    "n_features": (_fit_call(n_features=3), "n_features smaller"),
    "huge_F": (_fit_call(n_features=(1 << 24) + 1), "2\\^24"),
    "cuts_width": (lambda cls, **kw: cls(n_trees=1, **kw).fit(
        _O, _I, _V, _Y, n_features=8,
        cuts=S.build_sparse_cuts(_I, _V, 9, 8)), "feature count"),
    "predict_before_fit": (lambda cls, **kw: cls(**kw).predict(_O, _I, _V),
                           "predict before fit"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_are_jax_refusals(name):
    call, msg = REFUSALS[name]
    with pytest.raises(JaxError, match=msg):
        call(JaxSparse)
    with pytest.raises(Error, match=msg):
        call(SparseHistGBT, device="cpu")


@pytest.mark.parametrize("bad", ["nan", "negative"])
def test_predict_refusals(bad):
    m = SparseHistGBT(device="cpu", n_trees=2, max_depth=2).fit(_O, _I, _V,
                                                                 _Y)
    j = JaxSparse(n_trees=2, max_depth=2).fit(_O, _I, _V, _Y)
    args = (_O, _I, _BAD_NAN) if bad == "nan" else (_O, _BAD_NEG, _V)
    msg = "finite" if bad == "nan" else "negative"
    with pytest.raises(Error, match=msg):
        m.predict(*args)
    with pytest.raises(JaxError, match=msg):
        j.predict(*args)
    with pytest.raises(Error, match=msg):
        m.predict_block(RowBlock(offset=args[0], label=_Y, index=args[1],
                                 value=args[2]))


def test_no_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(Error, match="no CUDA GPU"):
        SparseHistGBT()


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def test_two_ranks_write_the_one_process_file(tmp_path):
    offset, index, value, y, _, _ = _sparse_problem(seed=11)
    kw = dict(n_trees=4, max_depth=3, n_bins=16, learning_rate=0.4)
    one = SparseHistGBT(device="cpu", **kw).fit(offset, index, value, y,
                                                n_features=40)
    csr = tmp_path / "csr.npz"
    np.savez(csr, offset=offset, index=index, value=value, y=y)
    cuts = tmp_path / "cuts.npz"
    np.savez(cuts, cut_vals=one.cuts.cut_vals, cut_ptr=one.cuts.cut_ptr)
    out = tmp_path / "out"
    launch({"backend": "gloo", "device": "cpu", "params": kw,
            "runs": [{"name": "inj", "sparse": {
                         "csr": str(csr), "n_features": 40,
                         "cuts": str(cuts)}},
                     {"name": "merged", "sparse": {
                         "csr": str(csr), "n_features": 40}}],
            "out": str(out)}, world=2, timeout=240)
    want = _file(one, tmp_path, "one")
    for r in range(2):
        assert (out / f"inj.{r}.model").read_bytes() == want
    # without cuts: JAX's merge of the two shards' candidates
    half = (len(offset) - 1) // 2
    a = int(offset[half])
    cands = np.stack([JS.sparse_cut_candidates(index[:a], value[:a], 40, 16),
                      JS.sparse_cut_candidates(index[a:], value[a:], 40, 16)])
    want_cuts = JS.merge_sparse_cut_candidates(cands)
    for r in range(2):
        got = SparseHistGBT.load_model(str(out / f"merged.{r}.model"),
                                       device="cpu")
        _same_cuts(got.cuts, want_cuts)
    assert (out / "merged.0.model").read_bytes() == \
        (out / "merged.1.model").read_bytes()
