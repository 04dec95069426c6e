"""The forest prediction of the port (``ops/forest.py``) against the JAX
package and against the per-level chain it replaced, on the CPU.

``forest_kernel`` walks every tree of a forest in one launch on the card;
its plain version, :func:`predict_forest_plain`, reads the same packed
tables, so a packing fault shows here.  Held BIT-EQUAL (the f32 bytes):

* margins — against JAX's compiled ``_predict_trees`` in its zero-padded
  chunks of 64 trees (``HistGBT._stacked_trees`` / ``_apply_trees``'s
  loop), and against the port's per-level chain (``_predict_trees`` over
  ``descend_plain``, one ``+ 0.0`` after a short last chunk), for
  T ∈ {1, 5, 63, 64, 65, 129} trees, depth ∈ {1, 3, 6, 12} (narrow F and
  few rows at depth 12), depth-wise and lossguide fits, ``multi:softmax``
  with K = 3, missing mode with NaN rows, and forests whose margins reach
  −0.0 before a short last chunk (and before a full one);
* leaf positions — against JAX's ``_leaf_indices`` and the chain's
  ``_tree_leaf``;
* the packing alone — ``pack_forest`` → ``unpack_forest`` gives the
  stacked tables back, u16 and u32 records, with and without directions;
* the slice whole — a port model's ``predict``, ``predict_leaf`` and
  margin replay against JAX's ``load_model`` of the same file.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.models.histgbt import (  # noqa: E402
    _leaf_indices as jax_leaf_indices, _predict_trees as jax_predict_trees)
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models.histgbt import (  # noqa: E402
    _TREE_CHUNK, _predict_trees, _tree_leaf)
from dmlc_core_tpu_torch.ops import forest as fo  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

#: an H100's (SMs, opt-in shared bytes a block, an SM's, reserved a block)
H100 = (132, 232448, 233472, 1024)


def _trees(rng, T, depth, F, B, K=1, missing=False, thr_lo=0):
    """``T`` random depth-wise trees (K classes each): features in
    ``[0, F)``, thresholds in ``[thr_lo, B-1]`` (``B-1``: all left),
    leaves of either sign, padding slots 0, directions in missing mode."""
    half = max((1 << depth) >> 1, 1)
    shape = (K,) if K > 1 else ()
    out = []
    for _ in range(T):
        live = np.zeros(shape + (depth, half), bool)
        for lv in range(depth):
            live[..., lv, :1 << lv] = True
        t = {"feat": np.where(live, rng.integers(0, F, live.shape), 0
                              ).astype(np.int32),
             "thr": np.where(live, rng.integers(thr_lo, B, live.shape), 0
                             ).astype(np.int32),
             "leaf": rng.normal(size=shape + (1 << depth,)
                                ).astype(np.float32)}
        if missing:
            t["dir"] = np.where(live, rng.integers(0, 2, live.shape), 0
                                ).astype(np.int32)
        out.append(t)
    return out


def _bins(rng, F, n, B, miss_bin=None):
    """Feature-major ``[F, n]`` uint8 bins; with ``miss_bin`` a fifth of
    the cells in the reserved NaN bin."""
    b = rng.integers(0, B if miss_bin is None else B - 1, (F, n))
    if miss_bin is not None:
        b = np.where(rng.random((F, n)) < 0.2, miss_bin, b)
    return b.astype(np.uint8)


def _jax_margins(bins, trees, depth, init, miss_bin=-1):
    """JAX's margins: ``_predict_trees`` a zero-padded chunk of 64 trees,
    class by class, the margins threaded through (``_apply_trees``)."""
    jb = jnp.asarray(np.ascontiguousarray(bins.T))
    margin = jnp.asarray(init)
    for chunk in JaxHistGBT._stacked_trees(trees):
        dirs = chunk.get("dir")
        if chunk["feat"].ndim == 4:
            margin = jnp.stack([
                jax_predict_trees(jb, chunk["feat"][:, c],
                                  chunk["thr"][:, c], chunk["leaf"][:, c],
                                  depth, 0.0, margin[:, c],
                                  None if dirs is None else dirs[:, c],
                                  miss_bin)
                for c in range(chunk["feat"].shape[1])], axis=1)
        else:
            margin = jax_predict_trees(jb, chunk["feat"], chunk["thr"],
                                       chunk["leaf"], depth, 0.0, margin,
                                       dirs, miss_bin)
    return np.asarray(margin)


def _jax_leaves(bins, trees, depth, miss_bin=-1):
    """JAX's ``predict_leaf`` body: ``_leaf_indices`` over the exact
    stack, class by class."""
    jb = jnp.asarray(np.ascontiguousarray(bins.T))
    st = {k: jnp.asarray(np.stack([t[k] for t in trees]))
          for k in ("feat", "thr", "dir") if k in trees[0]}
    dirs = st.get("dir")
    if st["feat"].ndim == 4:
        return np.stack([np.asarray(jax_leaf_indices(
            jb, st["feat"][:, c], st["thr"][:, c], depth,
            None if dirs is None else dirs[:, c], miss_bin))
            for c in range(st["feat"].shape[1])], axis=2)
    return np.asarray(jax_leaf_indices(jb, st["feat"], st["thr"], depth,
                                       dirs, miss_bin))


def _stack(trees):
    return {k: torch.from_numpy(np.stack([t[k] for t in trees]))
            for k in trees[0]}


def _chain_margins(bins, trees, depth, init, miss_bin=-1):
    """The per-level chain the forest kernel replaced: ``_predict_trees``
    (one ``descend_plain`` a level) a chunk of 64 trees, class by class,
    ``+ 0.0`` after a short last chunk."""
    bins_t = torch.from_numpy(bins)
    margin = torch.from_numpy(init)
    for lo in range(0, len(trees), _TREE_CHUNK):
        st = _stack(trees[lo:lo + _TREE_CHUNK])

        def one(s, m):
            return _predict_trees(bins_t, s["feat"], s["thr"], s["leaf"],
                                  depth, m, s.get("dir"), miss_bin)

        if st["feat"].dim() == 4:
            margin = torch.stack([
                one({k: v[:, c] for k, v in st.items()}, margin[:, c])
                for c in range(st["feat"].shape[1])], dim=1)
        else:
            margin = one(st, margin)
        if len(trees) - lo < _TREE_CHUNK:
            margin = margin + 0.0
    return margin.numpy()


def _chain_leaves(bins, trees, depth, miss_bin=-1):
    bins_t = torch.from_numpy(bins)
    st = _stack(trees)

    def one(s):
        return torch.stack([_tree_leaf(bins_t, s["feat"][t], s["thr"][t],
                                       depth, None if "dir" not in s
                                       else s["dir"][t], miss_bin)
                            for t in range(s["feat"].shape[0])], dim=1)

    if st["feat"].dim() == 4:
        return torch.stack([one({k: v[:, c] for k, v in st.items()})
                            for c in range(st["feat"].shape[1])],
                           dim=2).numpy()
    return one(st).numpy()


def _forest_margins(bins, trees, depth, init, miss_bin=-1):
    f = fo.pack_forest(trees, depth, "cpu", miss_bin,
                       add_zero=len(trees) % _TREE_CHUNK != 0)
    return fo.predict_forest(torch.from_numpy(bins), f,
                             torch.from_numpy(init)).numpy()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _assert_margins(bins, trees, depth, init, miss_bin=-1):
    got = _forest_margins(bins, trees, depth, init, miss_bin)
    assert got.dtype == np.float32 and got.shape == init.shape
    np.testing.assert_array_equal(
        _bits(got), _bits(_jax_margins(bins, trees, depth, init, miss_bin)))
    np.testing.assert_array_equal(
        _bits(got), _bits(_chain_margins(bins, trees, depth, init,
                                         miss_bin)))
    return got


def _assert_leaves(bins, trees, depth, miss_bin=-1):
    f = fo.pack_forest(trees, depth, "cpu", miss_bin)
    got = fo.predict_forest(torch.from_numpy(bins), f).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax_leaves(bins, trees, depth,
                                                   miss_bin))
    np.testing.assert_array_equal(got, _chain_leaves(bins, trees, depth,
                                                     miss_bin))


# ---------------------------------------------------------------------------
# margins and leaves on synthetic forests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 5, 63, 64, 65, 129])
def test_margins_by_tree_count(T):
    rng = np.random.default_rng(T)
    F, B, n, depth = 9, 32, 300, 3
    bins = _bins(rng, F, n, B)
    init = rng.normal(size=n).astype(np.float32)
    _assert_margins(bins, _trees(rng, T, depth, F, B), depth, init)


@pytest.mark.parametrize("depth,F,n", [(1, 7, 200), (3, 7, 200),
                                       (6, 12, 200), (12, 4, 48)])
def test_margins_by_depth(depth, F, n):
    rng = np.random.default_rng(100 + depth)
    B = 64
    bins = _bins(rng, F, n, B)
    init = rng.normal(size=n).astype(np.float32)
    trees = _trees(rng, 65, depth, F, B)
    _assert_margins(bins, trees, depth, init)


@pytest.mark.parametrize("T", [5, 65])
def test_margins_softmax(T):
    rng = np.random.default_rng(7 + T)
    F, B, n, depth, K = 8, 32, 250, 4, 3
    bins = _bins(rng, F, n, B)
    init = rng.normal(size=(n, K)).astype(np.float32)
    trees = _trees(rng, T, depth, F, B, K=K)
    f = fo.pack_forest(trees, depth, "cpu")
    assert (f.per_class, f.n_class) == (T, K)
    _assert_margins(bins, trees, depth, init)


@pytest.mark.parametrize("T", [5, 65])
def test_margins_missing(T):
    rng = np.random.default_rng(11 + T)
    F, B, n, depth = 8, 32, 300, 4
    miss = B - 1
    bins = _bins(rng, F, n, B, miss_bin=miss)
    init = rng.normal(size=n).astype(np.float32)
    # thresholds below the NaN bin, as training learns them, and B-1
    trees = _trees(rng, T, depth, F, B, missing=True)
    got = _assert_margins(bins, trees, depth, init, miss)
    # the directions matter: the same forest without them differs
    plain = [{k: v for k, v in t.items() if k != "dir"} for t in trees]
    assert not np.array_equal(
        _bits(got), _bits(_forest_margins(bins, plain, depth, init)))


@pytest.mark.parametrize("T,want_sign", [(5, 0), (64, 1), (129, 0)])
def test_negative_zero_before_the_last_chunk(T, want_sign):
    # init −0.0 and every leaf −0.0: the sum stays −0.0; JAX's padded
    # last chunk adds +0.0 (a zero tree) and so does the forest when the
    # last chunk is short — a full last chunk keeps −0.0
    rng = np.random.default_rng(3)
    F, B, n, depth = 5, 16, 64, 3
    trees = _trees(rng, T, depth, F, B)
    for t in trees:
        t["leaf"] = np.full_like(t["leaf"], -0.0)
    bins = _bins(rng, F, n, B)
    init = np.full(n, -0.0, np.float32)
    got = _assert_margins(bins, trees, depth, init)
    assert (np.signbit(got) == bool(want_sign)).all() and (got == 0).all()


@pytest.mark.parametrize("seed,case", enumerate(["single", "softmax",
                                                 "missing", "deep"]))
def test_leaf_positions(seed, case):
    rng = np.random.default_rng(seed)
    F, B, n = 8, 32, 200
    depth, K, missing, T = 4, 1, False, 65
    if case == "softmax":
        K = 3
    elif case == "missing":
        missing = True
    elif case == "deep":
        depth, F, n, T = 12, 4, 48, 5
    miss = B - 1 if missing else -1
    bins = _bins(rng, F, n, B, miss_bin=miss if missing else None)
    trees = _trees(rng, T, depth, F, B, K=K, missing=missing)
    _assert_leaves(bins, trees, depth, miss)


# ---------------------------------------------------------------------------
# real fits: depth-wise and lossguide trees
# ---------------------------------------------------------------------------

def _fit(policy, monkeypatch, n_trees=7):
    monkeypatch.setenv("DMLC_GROW_POLICY", policy)
    monkeypatch.setenv("DMLC_MAX_LEAVES", "6" if policy == "lossguide"
                       else "0")
    X = np.random.default_rng(5).normal(size=(1500, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return HistGBT(device="cpu", n_trees=n_trees, max_depth=4, n_bins=32,
                   learning_rate=0.3).fit(X, y), X


@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
def test_fitted_trees(policy, monkeypatch):
    m, X = _fit(policy, monkeypatch)
    if policy == "lossguide":
        # unexpanded slots: feat 0, thr B-1, their leaves −0.0
        thr = np.stack([t["thr"] for t in m.trees])
        assert (thr == m.param.n_bins - 1).any()
    bins = m._bins_of(torch.from_numpy(X)).numpy()
    init = m._base_margin(len(X)).numpy()
    got = _assert_margins(bins, m.trees, 4, init)
    # the fit's own margins, + 0.0 as a short last chunk ends
    np.testing.assert_array_equal(_bits(got),
                                  _bits(m.train_margins() + np.float32(0)))
    _assert_leaves(bins, m.trees, 4)


# ---------------------------------------------------------------------------
# the packing alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["narrow", "wide_features", "negative_thr",
                                  "missing", "softmax"])
def test_pack_round_trip(case):
    rng = np.random.default_rng(21)
    F, B, T, depth, K, missing, thr_lo = 12, 64, 9, 5, 1, False, 0
    if case == "wide_features":
        F, depth, T = 600, 6, 40          # > 256 distinct split features
    elif case == "negative_thr":
        thr_lo = -1                        # thr −1: every row goes right
    elif case == "missing":
        missing = True
    elif case == "softmax":
        K = 3
    trees = _trees(rng, T, depth, F, B, K=K, missing=missing, thr_lo=thr_lo)
    f = fo.pack_forest(trees, depth, "cpu", B - 1 if missing else -1)
    assert f.wide == (case in ("wide_features", "negative_thr"))
    assert f.tree_bytes % 16 == 0 and f.blob.numel() == T * K * f.tree_bytes
    back = fo.unpack_forest(f)
    assert sorted(back) == sorted(trees[0])
    for k in trees[0]:
        np.testing.assert_array_equal(back[k], np.stack([t[k] for t in trees]),
                                      err_msg=k)
    if case == "wide_features":
        assert f.n_used > 256
        bins = _bins(rng, F, 100, B)
        _assert_margins(bins, trees, depth,
                        rng.normal(size=100).astype(np.float32))


def test_pack_refuses_tables_of_another_depth():
    rng = np.random.default_rng(0)
    with pytest.raises(Error, match="depth"):
        fo.pack_forest(_trees(rng, 2, 3, 4, 16), 4, "cpu")


# ---------------------------------------------------------------------------
# the kernel's wrapper and plan (the kernel itself runs on the card only)
# ---------------------------------------------------------------------------

def test_kernel_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(1)
    f = fo.pack_forest(_trees(rng, 3, 3, 4, 16), 3, "cpu")
    before = fo.forest_kernel.launches
    with pytest.raises(Error, match="CUDA"):
        fo.forest_kernel(torch.from_numpy(_bins(rng, 4, 10, 16)), f,
                         torch.zeros(10))
    assert fo.forest_kernel.launches == before


@pytest.mark.parametrize("n_used,tree_bytes,n_trees,n,want", [
    # 10M x 28, 100 trees of depth 6: one group, three blocks an SM
    (28, 384, 100, 10_000_000, (256, 100, 28 * 1024 + 38400)),
    # a served batch of 256 rows, 20 trees of depth 4
    (28, 96, 20, 256, (64, 20, 28 * 256 + 1920)),
    # depth 12: a tree a group, double-buffered, two blocks an SM
    (28, 24576, 10, 1_000_000, (256, 1, 28 * 1024 + 2 * 24576)),
])
def test_forest_plan(n_used, tree_bytes, n_trees, n, want):
    assert fo.forest_plan(n_used, tree_bytes, n_trees, n, H100) == want
    threads, group, smem = want
    assert smem <= H100[1] and threads % 32 == 0 and threads <= 256


def test_forest_plan_shrinks_then_refuses():
    # 1000 split features: a tile of 128 rows and two trees a group
    assert fo.forest_plan(1000, 24576, 5, 10**6, H100) == (
        32, 2, 1000 * 128 + 2 * 2 * 24576)
    with pytest.raises(Error, match="shared memory"):
        fo.forest_plan(60000, 24576, 5, 10**6, H100)


def test_forest_bounds():
    rng = np.random.default_rng(2)
    f = fo.pack_forest(_trees(rng, 100, 6, 28, 256), 6, "cpu")
    b = fo.forest_bounds(10_000_000, 28, f, 3.35e12)
    assert abs(b["bytes_ms"] - 0.107) < 2e-3
    assert b["lookups"] == 10_000_000 * 100 * 6
    assert b["lookups_ms"] > b["bytes_ms"]


# ---------------------------------------------------------------------------
# the slice whole: the port's model against JAX's load of its file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["depthwise", "lossguide"])
def test_model_predict_equals_jax(policy, monkeypatch, tmp_path):
    m, X = _fit(policy, monkeypatch, n_trees=66)
    path = str(tmp_path / "m.bin")
    m.save_model(path)
    jm = JaxHistGBT.load_model(path)
    Xq = np.random.default_rng(9).normal(size=(333, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(m.predict(Xq, output_margin=True)),
        _bits(jm.predict(Xq, output_margin=True)))
    np.testing.assert_array_equal(m.predict_leaf(Xq), jm.predict_leaf(Xq))
    # the margin replay of a continued fit: the carried margins' bits
    replay = m._apply_trees(m._bins_of(torch.from_numpy(X)), m.trees,
                            m._base_margin(len(X)))
    np.testing.assert_array_equal(_bits(replay.numpy()),
                                  _bits(m.train_margins() + np.float32(0)))
