"""Port parity: quantile cuts and binning are BIT-EQUAL to the JAX
package's (``compute_cuts`` / ``apply_bins``), including the XLA addition
order of ``jnp.cumsum`` and an atom-dominated column that exercises the
strictly-increasing guard.  Compared as raw bits: the tolerance is 0."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.ops import quantile as jq  # noqa: E402
from dmlc_core_tpu_torch.ops import quantile as tq  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.uint32)


def _matrix(n, F, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    # atom-dominated: 70% exact zeros (a densified sparse column) — runs
    # of equal quantile targets that the guard must fan out
    X[:, 0] = np.where(rng.random(n) < 0.7, 0.0, X[:, 0])
    X[:, 1] = rng.integers(0, 3, n)              # 3-valued column
    X[:, 2] = np.exp(3.0 * X[:, 2])              # heavy tail
    return X


@pytest.mark.parametrize("length", [1, 5, 16, 17, 33, 255, 256, 2048, 5000])
def test_xla_cumsum_matches_jnp_cumsum(length):
    rng = np.random.default_rng(length)
    x = (rng.standard_normal((3, length))
         * np.exp(3 * rng.standard_normal((3, length)))).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    got = tq.xla_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want0 = np.asarray(jnp.cumsum(jnp.asarray(x.T), axis=0))
    got0 = tq.xla_cumsum(torch.from_numpy(np.ascontiguousarray(x.T)),
                         dim=0).numpy()
    np.testing.assert_array_equal(_bits(got0), _bits(want0))


@pytest.mark.parametrize("num", [2, 33, 257, 2048])
def test_linspace_grid_matches_jax(num):
    np.testing.assert_array_equal(
        _bits(tq._linspace01(num, "cpu").numpy()),
        _bits(jnp.linspace(0.0, 1.0, num)))


@pytest.mark.parametrize("n_bins", [32, 256])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuts_and_bins_bit_equal(n_bins, weighted):
    n, F = 1503, 4
    X = _matrix(n, F, seed=n_bins + weighted)
    w = None
    if weighted:
        w = (np.random.default_rng(5).random(n) + 0.1).astype(np.float32)
    want = np.array(jq.compute_cuts(X, n_bins, weight=w))
    got = tq.compute_cuts(torch.from_numpy(X), n_bins,
                          weight=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (F, n_bins - 1)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the guard made every feature's cuts strictly increasing
    assert np.all(np.diff(got.numpy(), axis=1) > 0)
    bins_j = np.asarray(jq.apply_bins(jnp.asarray(X), jnp.asarray(want)))
    bins_t = tq.apply_bins(torch.from_numpy(X), torch.from_numpy(want))
    assert bins_t.dtype == torch.uint8 and bins_t.shape == (F, n)
    np.testing.assert_array_equal(bins_t.numpy(), bins_j.T)


def test_summary_stages_bit_equal():
    X = _matrix(777, 3, seed=1)
    s_j = np.asarray(jq.local_summary(jnp.asarray(X), None, 256))
    s_t = tq.local_summary(torch.from_numpy(X), None, 256).numpy()
    np.testing.assert_array_equal(_bits(s_t), _bits(s_j))
    m_j = np.asarray(jq.merge_summaries(jnp.asarray(s_j)[None], 64))
    m_t = tq.merge_summaries(torch.from_numpy(s_t)[None], 64).numpy()
    np.testing.assert_array_equal(_bits(m_t), _bits(m_j))


def _inf_matrix(n, seed):
    """Three gaussian columns: 1% +inf in column 1, 1% −inf in column 2
    (``compute_cuts`` then emits NaN cuts: the top ones for +inf, every
    one for −inf, at 256 bins)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    X[rng.random(n) < 0.01, 1] = np.inf
    X[rng.random(n) < 0.01, 2] = -np.inf
    return X


@pytest.mark.parametrize("n_bins", [2, 16, 256])
def test_bins_bit_equal_with_nan_cuts(n_bins):
    """±inf columns: cuts bit-equal NaN for NaN, and ``apply_bins`` bins
    as ``jnp.searchsorted`` does (NaN cuts sort after every number) and
    as the host route ``_host_bin_t`` does; a NaN value counts every
    cut in all three."""
    from dmlc_core_tpu_torch.models.gbt_split import _host_bin_t

    X = _inf_matrix(5000, seed=n_bins)
    want = np.array(jq.compute_cuts(X, n_bins))
    got = tq.compute_cuts(torch.from_numpy(X), n_bins).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if n_bins == 256:
        assert np.isnan(want[1]).any() and np.isnan(want[2]).all()
    # a fourth column of NaN values and gaussians, binned by column 0's cuts
    X4 = np.concatenate([X, X[:, :1]], axis=1)
    X4[::7, 3] = np.nan
    cuts4 = np.concatenate([want, want[:1]])
    bins_j = np.asarray(jq.apply_bins(jnp.asarray(X4), jnp.asarray(cuts4)))
    bins_t = tq.apply_bins(torch.from_numpy(X4), torch.from_numpy(cuts4))
    assert bins_t.dtype == torch.uint8 and bins_t.shape == (4, 5000)
    np.testing.assert_array_equal(bins_t.numpy(), bins_j.T)
    np.testing.assert_array_equal(bins_t.numpy(), _host_bin_t(X4, cuts4))


# ---------------------------------------------------------------------------
# ROADMAP C11: subnormal values.  XLA (CPU and TPU) reads an f32 subnormal
# as a zero of its sign; the port's device route flushes them where it
# reads values, so cuts and bins stay bit-equal.  The host route (numpy)
# keeps them in both packages.
# ---------------------------------------------------------------------------

def _subnormal(case, n=1000, F=3):
    rng = np.random.default_rng(11)
    X = (rng.normal(size=(n, F)) * 1e-40).astype(np.float32)
    w = None
    if case == "mixed":
        X = np.where(rng.random((n, F)) < 0.5, X,
                     rng.normal(size=(n, F))).astype(np.float32)
    elif case == "weighted":
        w = (rng.random(n) + 0.1).astype(np.float32)
    elif case == "missing":
        X[rng.random((n, F)) < 0.2] = np.nan
    return X, w


@pytest.mark.parametrize("case,n_bins", [("all", 64), ("mixed", 64),
                                         ("weighted", 64), ("missing", 64),
                                         ("all", 4)])
def test_subnormal_cuts_and_bins_bit_equal(case, n_bins):
    X, w = _subnormal(case)
    assert np.any((X != 0) & (np.abs(X) < np.finfo(np.float32).tiny))
    missing = case == "missing"
    want = np.array(jq.compute_cuts(X, n_bins, weight=w, missing=missing))
    got = tq.compute_cuts(torch.from_numpy(X), n_bins,
                          weight=None if w is None else torch.from_numpy(w),
                          missing=missing).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if missing:
        bins_j = jq.apply_bins_missing(jnp.asarray(X), jnp.asarray(want),
                                       n_bins)
        bins_t = tq.apply_bins_missing(torch.from_numpy(X),
                                       torch.from_numpy(want), n_bins)
    else:
        bins_j = jq.apply_bins(jnp.asarray(X), jnp.asarray(want))
        bins_t = tq.apply_bins(torch.from_numpy(X), torch.from_numpy(want))
    np.testing.assert_array_equal(bins_t.numpy(), np.asarray(bins_j).T)


def test_flush_subnormals_keeps_the_sign_and_the_rest():
    tiny = np.finfo(np.float32).tiny
    x = torch.tensor([1e-40, -1e-40, tiny, -tiny, 0.0, -0.0, 1.0,
                      float("nan"), float("inf"), -float("inf")])
    got = tq.flush_subnormals(x).numpy()
    want = np.array([0.0, -0.0, tiny, -tiny, 0.0, -0.0, 1.0, np.nan,
                     np.inf, -np.inf], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("backend", ["device", "cpu"])
def test_subnormal_fit_meets_level_b(backend, monkeypatch):
    """ROADMAP C11's fit: 4,000 × 3 gaussian rows, 40% of feature 0
    ±1e-39 by label; depth 3, 64 bins, 3 trees — level (b) on both
    binning routes (the default device route, and the host's, which
    trains on bins that keep the subnormals, in both packages alike)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_parity import assert_level_b
    from dmlc_core_tpu.models import HistGBT as JaxHistGBT
    from dmlc_core_tpu.parallel.mesh import local_mesh
    from dmlc_core_tpu_torch import HistGBT

    for k in ("DMLC_TPU_BIN_BACKEND", "DMLC_GROW_POLICY"):
        monkeypatch.delenv(k, raising=False)
    if backend == "cpu":
        monkeypatch.setenv("DMLC_TPU_BIN_BACKEND", "cpu")

    def rows(seed, n):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, 3)).astype(np.float32)
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
        sub = rng.random(n) < 0.4
        X[sub, 0] = np.where(y[sub] > 0, 1e-39, -1e-39).astype(np.float32)
        return X, y

    X, y = rows(0, 4000)
    Xv, _ = rows(1, 2000)
    kw = dict(n_trees=3, max_depth=3, n_bins=64)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    # the host route's fit: its margins part by more than the fixed 1e-5
    # (f32 sums in other orders over 3 trees, as in C5/C6), so it is held
    # by the float64 proofs alone, which bound the margins and held-out
    # predictions row by row
    assert assert_level_b(jm, tm, Xv, X=X, y=y,
                          fixed=backend == "device")[1] is None
